"""The train and eval step factories.

Port of ``flowtrain_stochastic_interpolation_tpu/train/steps.py``: one
micro-step is the loss (``unconditional_loss``, or ``conditional_loss`` when
``config.model.conditional`` is set), its backward, the optimiser's
accumulate-or-update (:class:`train.state.Optimizer`) and the EMA shadow.
PyTorch runs eagerly, so the step is a plain function that updates the state
in place; the JAX package's jit and buffer donation have no counterpart. The
metrics are the loss's (``train_loss``; the conditional loss adds
``flow_loss`` and ``reconstruct_loss``) and ``grad_norm`` (the micro-step's
own gradient, before accumulation and clipping), as device tensors.

The 128³ memory forms: ``training.remat`` runs the model's whole forward
under one activation checkpoint (:func:`models.remat.checkpoint`, which
replays the dropout generator's draws in the recompute) with
``training.remat_policy`` (``"dots"`` or ``"nothing"``) and, for the
conditional model, ``training.remat_save_atb``; ``training.objective_dtype =
"bfloat16"`` stores the drawn and interpolated volumes in bf16.

Data parallelism (``mesh`` with more than one data rank): each rank takes its
block of the global batch and its own draws, and the step keeps the JAX
default step's semantics, the objective of the *global* batch
(:func:`train.shard_map_step.global_objective`): the parameter-independent
denominators are all-reduced as scalars before the backward, and the local
gradients are summed over the data group in one all-reduce of a flat buffer
before the optimiser and the EMA.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from flowtrain_stochastic_interpolation_torch.config import ExperimentConfig
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant
from flowtrain_stochastic_interpolation_torch.models.remat import checkpoint
from flowtrain_stochastic_interpolation_torch.ops.embedding import embed
from flowtrain_stochastic_interpolation_torch.ops.masks import make_combined_mask
from flowtrain_stochastic_interpolation_torch.parallel.mesh import Mesh
from flowtrain_stochastic_interpolation_torch.train.objectives import (
    _draw_common,
    conditional_loss,
    unconditional_loss,
)
from flowtrain_stochastic_interpolation_torch.train.shard_map_step import (
    apply_update,
    global_objective,
    reduced_grads,
)
from flowtrain_stochastic_interpolation_torch.train.state import Optimizer, TrainState


OBJECTIVE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def rematerialised(model: nn.Module, config: ExperimentConfig):
    """``model`` called under one activation checkpoint of ``config.training``'s
    policy (JAX's ``jax.checkpoint`` with ``remat_policy``) while gradients are
    on; the model itself without ``training.remat``."""
    tc = config.training
    if not tc.remat:
        return model
    save_atb = config.model.conditional and tc.remat_save_atb

    def forward(*args):
        *inputs, generator = args
        if not torch.is_grad_enabled():
            return model(*inputs, generator)
        return checkpoint(lambda *a: model(*a), *inputs, generator=generator,
                          remat_policy=tc.remat_policy, save_atb=save_atb)

    return forward


def _loss(config: ExperimentConfig):
    """``loss(model, batch, table, generator) -> (loss, metrics)`` of the config."""
    tc = config.training
    if tc.objective_dtype not in OBJECTIVE_DTYPES:
        raise ValueError(f"unknown objective_dtype {tc.objective_dtype!r}; "
                         f"options: {tuple(OBJECTIVE_DTYPES)}")
    kwargs = dict(interpolant=LinearInterpolant(one_sided=True), time_range=tc.time_range,
                  x1_noise=tc.x1_noise, objective_dtype=OBJECTIVE_DTYPES[tc.objective_dtype])
    if config.model.conditional:
        return functools.partial(conditional_loss, lambda_reconstruct=tc.lambda_reconstruct,
                                 **kwargs)
    return functools.partial(unconditional_loss, **kwargs)


def make_train_step(model: nn.Module, tx: Optimizer, config: ExperimentConfig,
                    mesh: Optional[Mesh] = None):
    """``train_step(state, batch, generator) -> (state, metrics)``.

    ``batch`` is the categorical volume ``[B, X, Y, Z]`` (air = -1) on the
    model's device; ``generator`` draws the objective's noise and times and
    the dropout masks. With a ``mesh`` of several data ranks, ``batch`` is this
    rank's block, the generator this rank's, and the step data-parallel
    (:func:`make_data_parallel_loss_and_grads`); the step then also takes
    ``draws`` for its block, as the objectives take them.
    """
    if mesh is not None and mesh.n_spatial > 1:
        raise ValueError("a spatial mesh trains through train.shard_map_step."
                         "make_spatial_train_step")
    if mesh is not None and mesh.n_data > 1:
        return _data_parallel_step(model, tx, config, mesh)
    loss_fn = _loss(config)
    forward = rematerialised(model, config)
    names = [name for name, _ in model.named_parameters()]

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: torch.Generator) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train()
        params = [state.params[k] for k in names]
        for p in params:
            p.grad = None
        loss, metrics = loss_fn(forward, batch, state.constants["embedding"], generator)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, apply_update(state, tx, config, params, grads, metrics)

    return train_step


def make_data_parallel_loss_and_grads(model: nn.Module, config: ExperimentConfig, mesh: Mesh):
    """``f(state, batch, generator, draws=None) -> (metrics, grads)``: the global
    objective's metrics and exact gradient (a list in the model's parameter
    order) from this rank's block ``batch`` of the global batch.

    The draws come from ``generator`` in the objectives' order (the conditional
    mask first), or are ``draws`` for the block: ``(X1, X0, T)``, or ``(mask,
    X1, X0, T)`` for the conditional model.
    """
    tc = config.training
    conditional = config.model.conditional
    interpolant = LinearInterpolant(one_sided=True)
    dtype = OBJECTIVE_DTYPES[tc.objective_dtype]
    forward = rematerialised(model, config)
    names = [name for name, _ in model.named_parameters()]

    def loss_and_grads(state: TrainState, batch: torch.Tensor, generator: torch.Generator,
                       draws=None):
        model.train()
        params = [state.params[k] for k in names]
        for p in params:
            p.grad = None
        table = state.constants["embedding"]
        mask = None
        if draws is None:
            if conditional:
                mask = make_combined_mask(generator, batch)
            x1_clean, x1, x0, t = _draw_common(generator, batch, table, tc.time_range,
                                               tc.x1_noise, dtype)
        else:
            if conditional:
                mask, *draws = draws
            x1, x0, t = draws
            x1_clean = embed(batch, table)
            x1_clean = x1_clean if dtype is None else x1_clean.to(dtype)
        xt, vt = interpolant.flow_objective(t, x0, x1)
        loss, metrics = global_objective(
            lambda *a: forward(*a, generator), xt, vt, x1, x1_clean, t, mask,
            conditional=conditional, lambda_reconstruct=tc.lambda_reconstruct,
            world_group=mesh.world_group, data_group=mesh.data_group, n_data=mesh.n_data)
        loss.backward()
        grads, metrics = reduced_grads(params, metrics, mesh.world_group)
        return metrics, grads

    return loss_and_grads


def _data_parallel_step(model: nn.Module, tx: Optimizer, config: ExperimentConfig, mesh: Mesh):
    loss_and_grads = make_data_parallel_loss_and_grads(model, config, mesh)
    names = [name for name, _ in model.named_parameters()]

    def train_step(state: TrainState, batch: torch.Tensor, generator: torch.Generator,
                   draws=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        metrics, grads = loss_and_grads(state, batch, generator, draws)
        params = [state.params[k] for k in names]
        return state, apply_update(state, tx, config, params, grads, metrics)

    return train_step


def make_eval_loss(model: nn.Module, config: ExperimentConfig):
    """``eval_loss(state, batch, generator) -> metrics``: the deterministic loss
    (no dropout, no gradient, no update)."""
    loss_fn = _loss(config)

    @torch.no_grad()
    def eval_loss(state: TrainState, batch: torch.Tensor,
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            _, metrics = loss_fn(model, batch, state.constants["embedding"], generator)
        finally:
            model.train(was_training)
        return metrics

    return eval_loss
