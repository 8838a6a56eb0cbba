"""Training state, the optimiser and the EMA shadow.

Port of ``flowtrain_stochastic_interpolation_tpu/train/state.py``, which
builds an optax chain. The port computes the same chain by hand, so that it
matches optax rather than torch's helpers:

* ``clip_by_global_norm``: scale by ``max / g`` only when the global norm g is
  ``>= max`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 and clips always);
* ``MultiSteps`` accumulation: gradients are *averaged* over k micro-steps
  (``acc += (g - acc) / (n + 1)``); the inner chain runs on every k-th
  micro-step only, and params do not change in between;
* Adam / AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, bias
  correction on the inner update count); AdamW adds ``weight_decay · p`` of
  the params before the update;
* the staircase exponential decay of the learning rate, counting *inner*
  updates: ``lr · decay^floor(updates / transition_steps)``.

Everything updates in place, with ``torch._foreach`` operations over the
parameter list. The EMA shadow is updated on every micro-step.

``TrainState.state_dict`` / ``load_state_dict`` carry the whole state (the
step, the params, the optimiser's counters and moments, the EMA shadow and the
constants) to and from ``torch.save``: what the JAX package's orbax
checkpoints hold. ``with_ema_applied`` is the JAX state's method of that name.

The model's buffers (a RandomFourier time embedding's frozen features: the
JAX ``constants["model"]`` collection) ride in ``constants`` under the prefix
``model.``, as the model's own tensors: a checkpoint saves and restores them,
and neither the optimiser nor the EMA, which take the parameters only, ever
touches them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from flowtrain_stochastic_interpolation_torch.config import EMAConfig, TrainingConfig


@dataclass
class OptState:
    """What the optimiser carries between micro-steps."""

    mini_step: int = 0                 # micro-steps accumulated since the last update
    updates: int = 0                   # inner updates so far (the schedule's count)
    acc: List[torch.Tensor] = field(default_factory=list)   # mean gradient so far
    mu: List[torch.Tensor] = field(default_factory=list)    # Adam's first moment
    nu: List[torch.Tensor] = field(default_factory=list)    # Adam's second moment


MODEL_CONSTANTS = "model."


@dataclass
class TrainState:
    """Everything a training step mutates. ``params`` are the model's own
    parameter tensors, by name; the step updates them in place."""

    step: int                                  # global micro-step counter
    params: Dict[str, torch.Tensor]
    constants: Dict[str, torch.Tensor]         # the embedding table, the model's buffers
    opt_state: OptState
    ema_params: Optional[Dict[str, torch.Tensor]]  # None when EMA is off

    def with_ema_applied(self) -> "TrainState":
        """The state with the EMA shadow as its params (for sampling); the state
        itself when EMA is off."""
        if self.ema_params is None:
            return self
        return dataclasses.replace(self, params=self.ema_params)

    def model_buffers(self) -> Dict[str, torch.Tensor]:
        """The model's buffers, by their names in the model."""
        n = len(MODEL_CONSTANTS)
        return {k[n:]: v for k, v in self.constants.items() if k.startswith(MODEL_CONSTANTS)}

    def model_state_dict(self, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """A ``state_dict`` for the model: the params (the EMA shadow with
        ``use_ema`` where EMA is on) and the buffers."""
        params = self.with_ema_applied().params if use_ema else self.params
        return {**params, **self.model_buffers()}

    def state_dict(self) -> Dict[str, Any]:
        """Everything the state holds, as tensors, ints, lists and dicts."""
        opt = self.opt_state
        return {
            "step": self.step,
            "params": dict(self.params),
            "constants": dict(self.constants),
            "opt_state": {"mini_step": opt.mini_step, "updates": opt.updates,
                          "acc": list(opt.acc), "mu": list(opt.mu), "nu": list(opt.nu)},
            "ema_params": None if self.ema_params is None else dict(self.ema_params),
        }

    @torch.no_grad()
    def load_state_dict(self, saved: Dict[str, Any]) -> None:
        """Copy ``saved`` (a :meth:`state_dict`) into this state's tensors in
        place, so that a model whose parameters are ``params`` holds them too.
        Names, shapes and the presence of EMA and accumulation must agree."""
        def copy(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str):
            if set(dst) != set(src):
                raise KeyError(f"{what}: the checkpoint's names differ from the state's")
            torch._foreach_copy_([dst[k] for k in dst], [src[k] for k in dst])

        def copy_list(dst: List[torch.Tensor], src: List[torch.Tensor], what: str):
            if len(dst) != len(src):
                raise ValueError(f"{what}: {len(src)} tensors saved, {len(dst)} in the state")
            if dst:
                torch._foreach_copy_(dst, list(src))

        if (saved["ema_params"] is None) != (self.ema_params is None):
            raise ValueError("the checkpoint and the state disagree on EMA")
        copy(self.params, saved["params"], "params")
        copy(self.constants, saved["constants"], "constants")
        if self.ema_params is not None:
            copy(self.ema_params, saved["ema_params"], "ema_params")
        opt, saved_opt = self.opt_state, saved["opt_state"]
        for name in ("acc", "mu", "nu"):
            copy_list(getattr(opt, name), saved_opt[name], name)
        opt.mini_step, opt.updates = int(saved_opt["mini_step"]), int(saved_opt["updates"])
        self.step = int(saved["step"])


class Optimizer:
    """clip_by_global_norm → Adam(W) with a staircase learning rate, accumulated
    over ``accumulate`` micro-steps (optax's ``MultiSteps``)."""

    def __init__(self, *, learning_rate: float, lr_decay: float, transition_steps: int,
                 max_norm: float, accumulate: int = 1, optimizer: str = "adam",
                 weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        if optimizer not in ("adam", "adamw"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        self.learning_rate, self.lr_decay = learning_rate, lr_decay
        self.transition_steps = max(transition_steps, 1)
        self.max_norm, self.accumulate = max_norm, accumulate
        self.weight_decay = weight_decay if optimizer == "adamw" else 0.0
        self.b1, self.b2, self.eps = b1, b2, eps

    def lr(self, updates: int) -> float:
        """The staircase learning rate of inner update number ``updates`` (from 0)."""
        return self.learning_rate * self.lr_decay ** (updates // self.transition_steps)

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        zeros = lambda: [torch.zeros_like(p) for p in params]
        return OptState(acc=zeros() if self.accumulate > 1 else [], mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> bool:
        """Take one micro-step's gradients; returns whether params were updated."""
        grads = list(grads)
        if self.accumulate > 1:
            n = state.mini_step
            torch._foreach_add_(state.acc, torch._foreach_div(
                torch._foreach_sub(grads, state.acc), float(n + 1)))
            state.mini_step = (n + 1) % self.accumulate
            if n != self.accumulate - 1:
                return False
            grads = state.acc
        self._inner_update(grads, state, list(params))
        if self.accumulate > 1:
            torch._foreach_zero_(state.acc)
        return True

    def _inner_update(self, grads, state: OptState, params) -> None:
        # clip_by_global_norm
        g_norm = global_norm(grads)
        factor = torch.where(g_norm < self.max_norm, torch.ones_like(g_norm),
                             self.max_norm / g_norm)
        grads = torch._foreach_mul(grads, factor)
        # Adam moments and bias correction
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - self.b2)
        count = state.updates + 1
        mu_hat = torch._foreach_div(state.mu, 1.0 - self.b1 ** count)
        denom = torch._foreach_sqrt(torch._foreach_div(state.nu, 1.0 - self.b2 ** count))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-self.lr(state.updates))
        state.updates = count


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ ‖t‖²)`` over all tensors, in f32 (optax's ``global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def make_optimizer(cfg: TrainingConfig, updates_per_epoch: int) -> Optimizer:
    """The optimiser of the training recipe; ``updates_per_epoch`` is the number
    of *inner* updates per epoch, the staircase's transition steps."""
    return Optimizer(
        learning_rate=cfg.learning_rate, lr_decay=cfg.lr_decay,
        transition_steps=updates_per_epoch, max_norm=cfg.gradient_clip_val,
        accumulate=cfg.accumulate_grad_batches, optimizer=cfg.optimizer,
        weight_decay=cfg.weight_decay,
    )


def init_state(model: nn.Module, constants: Dict[str, torch.Tensor], tx: Optimizer,
               ema: EMAConfig) -> TrainState:
    """The state of ``model`` at step 0: its parameters, ``constants`` with the
    model's buffers added, the optimiser's state and the EMA shadow."""
    params = dict(model.named_parameters())
    shadow = ({k: p.detach().clone() for k, p in params.items()} if ema.enabled else None)
    constants = {**constants,
                 **{MODEL_CONSTANTS + k: b for k, b in model.named_buffers()}}
    return TrainState(step=0, params=params, constants=constants,
                      opt_state=tx.init(list(params.values())), ema_params=shadow)


@torch.no_grad()
def ema_update(ema_cfg: EMAConfig, step: int, ema_params: Optional[Dict[str, torch.Tensor]],
               params: Dict[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
    """Shadow update ``s = d·s + (1-d)·p``, in place, gated as the JAX package's:
    before ``start_step`` the shadow tracks the raw weights; from then on it
    decays every ``update_every`` micro-steps and holds in between."""
    if not ema_cfg.enabled or ema_params is None:
        return None
    shadow = list(ema_params.values())
    current = [params[k] for k in ema_params]
    if step >= ema_cfg.start_step and step % ema_cfg.update_every == 0:
        d = ema_cfg.decay
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, current, alpha=1.0 - d)
    elif step < ema_cfg.start_step:
        torch._foreach_copy_(shadow, current)
    return ema_params
