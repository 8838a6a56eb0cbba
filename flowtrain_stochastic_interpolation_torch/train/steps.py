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

Not ported yet: ``remat`` and the bf16 objective (``objective_dtype``); asking
for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch import nn

from flowtrain_stochastic_interpolation_torch.config import ExperimentConfig
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant
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


def _check_ported(config: ExperimentConfig) -> None:
    tc = config.training
    if tc.remat or tc.objective_dtype != "float32":
        raise NotImplementedError(
            "remat and the bf16 objective are not ported "
            "(ROADMAP Queue 1, the 128³ memory forms)"
        )


def _loss(config: ExperimentConfig):
    """``loss(model, batch, table, generator) -> (loss, metrics)`` of the config."""
    _check_ported(config)
    tc = config.training
    kwargs = dict(interpolant=LinearInterpolant(one_sided=True), time_range=tc.time_range,
                  x1_noise=tc.x1_noise)
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
    names = [name for name, _ in model.named_parameters()]

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: torch.Generator) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train()
        params = [state.params[k] for k in names]
        for p in params:
            p.grad = None
        loss, metrics = loss_fn(model, batch, state.constants["embedding"], generator)
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
