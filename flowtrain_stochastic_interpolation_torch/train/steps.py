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
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch import nn

from flowtrain_stochastic_interpolation_torch.config import ExperimentConfig
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant
from flowtrain_stochastic_interpolation_torch.models.remat import checkpoint
from flowtrain_stochastic_interpolation_torch.train.objectives import (
    conditional_loss,
    unconditional_loss,
)
from flowtrain_stochastic_interpolation_torch.train.state import (
    Optimizer,
    TrainState,
    ema_update,
    global_norm,
)


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


def make_train_step(model: nn.Module, tx: Optimizer, config: ExperimentConfig):
    """``train_step(state, batch, generator) -> (state, metrics)``.

    ``batch`` is the categorical volume ``[B, X, Y, Z]`` (air = -1) on the
    model's device; ``generator`` draws the objective's noise and times and
    the dropout masks.
    """
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
        metrics["grad_norm"] = global_norm(grads)
        tx.update(grads, state.opt_state, params)
        for p in params:
            p.grad = None
        state.ema_params = ema_update(config.ema, state.step, state.ema_params, state.params)
        state.step += 1
        return state, metrics

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
