"""Data-parallel and spatially sharded train steps over ``torch.distributed``.

Port of ``flowtrain_stochastic_interpolation_tpu/train/shard_map_step.py``,
and the objective that the data-parallel default step (``train.steps``) uses.

* :func:`global_objective`: the JAX default step's objective, computed over
  the *global* batch (and volume) from each rank's block. Every term of
  either loss is a ratio whose denominator (``Σ VT²``; for the conditional
  loss also ``Σ X1²``, the masked count, the element count and the mean of
  T) does not depend on the parameters: those are all-reduced as a few
  scalars before the backward, so each rank's loss is its local numerators
  over the global denominators, and the sum over the ranks of the local
  losses, and of their gradients, is the global loss and its exact gradient.
* :func:`make_shard_map_train_step`: JAX's explicit variant, a *mean* over
  the data group of each rank's own objective and gradient (another
  objective: a mean of per-rank ratios).
* :func:`spatial_draws`, :func:`make_spatial_loss_and_grad` and
  :func:`make_spatial_train_step`: the X axis of every sample sharded over
  the mesh's spatial group, through a model built with that group
  (``models.unet.UNet(..., spatial_group=...)``). T comes from ``(seed, di)``
  only, so every slab of a sample sees the same time; the X0 and X1 noise and
  the dropout from ``(seed, di, si)``. Every sum of the objective runs over
  data × spatial, the conditional mean of T over data alone; the gradient is
  the sum over all ranks of each rank's gradient of its local terms.

Each step all-reduces one flat buffer a micro-step: the gradients with the
metrics' local parts appended. Every rank then applies the same update, and
the replicas stay bitwise equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from flowtrain_stochastic_interpolation_torch.config import ExperimentConfig
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant
from flowtrain_stochastic_interpolation_torch.ops.embedding import embed
from flowtrain_stochastic_interpolation_torch.parallel.collectives import all_reduce_sum
from flowtrain_stochastic_interpolation_torch.parallel.mesh import Mesh
from flowtrain_stochastic_interpolation_torch.train.state import (
    Optimizer,
    TrainState,
    ema_update,
    global_norm,
)
from flowtrain_stochastic_interpolation_torch.utils.rng import generator as folded_generator


def global_objective(forward, xt: torch.Tensor, vt: torch.Tensor, x1: torch.Tensor,
                     x1_clean: torch.Tensor, t: torch.Tensor, mask: Optional[torch.Tensor],
                     *, conditional: bool, lambda_reconstruct: float, world_group,
                     data_group, n_data: int,
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """This rank's share of the global loss, and of its metrics: the sums over
    ``world_group`` of both are the global values.

    ``forward(xt, t)`` (or ``forward(xt, atb, t)`` when ``conditional``) is the
    model on this rank's block. ``t`` is this rank's samples' times, the same on
    every rank of a sample (the conditional mean of T sums over ``data_group``
    and divides by ``n_data`` blocks).
    """
    if not conditional:
        v_hat = forward(xt, t)
        sum_d2 = (v_hat.float() - vt.float()).square().sum()
        den = all_reduce_sum(vt.float().square().sum().detach(), world_group)
        loss = sum_d2 / den
        return loss, {"train_loss": loss}

    mask_f = mask[..., None].to(torch.float32)
    atb = x1_clean * mask_f.to(x1_clean.dtype)
    stats = torch.stack([vt.float().square().sum(), x1.float().square().sum(),
                         mask_f.sum(), torch.tensor(float(vt.numel()), device=vt.device)])
    sum_vt2, sum_x12, n_obs, n_tot = all_reduce_sum(stats.detach(), world_group)
    t_mean = all_reduce_sum(t.sum().detach(), data_group) / (t.numel() * n_data)

    v_hat = forward(xt, atb, t)
    sum_d2 = (v_hat.float() - vt.float()).square().sum()
    flow_loss = (sum_d2 / n_tot) / (sum_vt2 / n_tot + 1e-6)
    t_b = t.reshape(-1, 1, 1, 1, 1).to(xt.dtype)
    b_hat = (xt + (1.0 - t_b) * v_hat).float()
    n_masked = n_obs.clamp_min(1.0) * x1.shape[-1]
    masked_mse = ((b_hat - x1_clean.float()).square() * mask_f).sum() / n_masked
    denom = sum_x12 / n_tot + 1e-6
    reconstruct_loss = t_mean * masked_mse / denom
    loss = flow_loss + lambda_reconstruct * reconstruct_loss
    return loss, {"train_loss": loss, "flow_loss": flow_loss,
                  "reconstruct_loss": reconstruct_loss}


def reduced_grads(params: List[torch.Tensor], metrics: Dict[str, torch.Tensor], group,
                  scale: float = 1.0) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Every parameter's gradient and every metric summed over ``group`` (times
    ``scale``), in one all-reduce of a flat f32 buffer."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    names = list(metrics)
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [torch.stack([metrics[k].detach().float() for k in names])])
    flat = all_reduce_sum(flat, group)
    if scale != 1.0:
        flat.mul_(scale)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].view_as(g).to(g.dtype))
        offset += g.numel()
    return out, dict(zip(names, flat[offset:]))


def apply_update(state: TrainState, tx: Optimizer, config: ExperimentConfig,
                 params: List[torch.Tensor], grads: List[torch.Tensor],
                 metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """grad_norm, the optimiser's micro-step and the EMA shadow, as every step
    of ``train.steps`` applies them."""
    metrics["grad_norm"] = global_norm(grads)
    tx.update(grads, state.opt_state, params)
    for p in params:
        p.grad = None
    state.ema_params = ema_update(config.ema, state.step, state.ema_params, state.params)
    state.step += 1
    return metrics


def make_shard_map_train_step(model: nn.Module, tx: Optimizer, config: ExperimentConfig,
                              mesh: Mesh):
    """``train_step(state, batch, generator, draws=None) -> (state, metrics)``: each
    rank's own objective on its block of the batch (its draws from its
    ``generator``, or ``draws`` as the objectives take them), then the mean of
    the gradients and metrics over the data group."""
    from flowtrain_stochastic_interpolation_torch.train.steps import _loss, rematerialised

    loss_fn = _loss(config)
    forward = rematerialised(model, config)
    names = [name for name, _ in model.named_parameters()]

    def train_step(state: TrainState, batch: torch.Tensor, generator: torch.Generator,
                   draws=None):
        model.train()
        params = [state.params[k] for k in names]
        for p in params:
            p.grad = None
        kw = {} if draws is None else {"draws": draws}
        loss, metrics = loss_fn(forward, batch, state.constants["embedding"], generator, **kw)
        loss.backward()
        grads, metrics = reduced_grads(params, metrics, mesh.data_group, 1.0 / mesh.n_data)
        return state, apply_update(state, tx, config, params, grads, metrics)

    return train_step


def spatial_draws(seed: int, labels: torch.Tensor, table: torch.Tensor,
                  time_range: Tuple[float, float], x1_noise: float, di: int, si: int,
                  dtype: Optional[torch.dtype] = None):
    """``(X1_clean, X1, X0, T)`` of the ``(data=di, spatial=si)`` block ``labels``
    ``[B_loc, X_loc, Y, Z]``: T from ``(seed, 17, di)``, the X1 noise from
    ``(seed, 23, di, si)``, X0 from ``(seed, 29, di, si)``."""
    dev = labels.device
    x1_clean = embed(labels, table)
    if dtype is not None:
        x1_clean = x1_clean.to(dtype)
    kw = dict(device=dev, dtype=x1_clean.dtype)
    noise_scale = torch.tensor(x1_noise, **kw)
    x1 = x1_clean + noise_scale * torch.randn(
        x1_clean.shape, generator=folded_generator(dev, seed, 23, di, si), **kw)
    x0 = torch.randn(x1.shape, generator=folded_generator(dev, seed, 29, di, si), **kw)
    lo, hi = time_range
    t = lo + (hi - lo) * torch.rand(x1.shape[0], generator=folded_generator(dev, seed, 17, di),
                                    device=dev, dtype=torch.float32)
    return x1_clean, x1, x0, t


def dropout_generator(device, seed: int, di: int, si: int) -> torch.Generator:
    """The dropout masks' generator of block ``(di, si)``."""
    return folded_generator(device, seed, 3, di, si)


def make_spatial_loss_and_grad(model: nn.Module, config: ExperimentConfig, mesh: Mesh):
    """``f(state, labels, mask, seed) -> (loss, metrics, grads)``: the global loss
    and metrics and every parameter's global gradient (a list in the model's
    parameter order), each rank holding block ``(di, si)`` of ``labels``
    ``[B, X, Y, Z]`` (and of the conditional ``mask``, made on the global
    volume). ``seed`` is this micro-step's (the caller folds the step in)."""
    from flowtrain_stochastic_interpolation_torch.train.steps import (
        OBJECTIVE_DTYPES,
        rematerialised,
    )

    tc = config.training
    conditional = config.model.conditional
    interpolant = LinearInterpolant(one_sided=True)
    forward_model = rematerialised(model, config)
    names = [name for name, _ in model.named_parameters()]

    def loss_and_grad(state: TrainState, labels: torch.Tensor, mask: Optional[torch.Tensor],
                      seed: int):
        model.train()
        params = [state.params[k] for k in names]
        for p in params:
            p.grad = None
        x1_clean, x1, x0, t = spatial_draws(
            seed, labels, state.constants["embedding"], tc.time_range, tc.x1_noise,
            mesh.di, mesh.si, OBJECTIVE_DTYPES[tc.objective_dtype])
        xt, vt = interpolant.flow_objective(t, x0, x1)
        gen = dropout_generator(labels.device, seed, mesh.di, mesh.si)
        loss, metrics = global_objective(
            lambda *a: forward_model(*a, gen), xt, vt, x1, x1_clean, t, mask,
            conditional=conditional, lambda_reconstruct=tc.lambda_reconstruct,
            world_group=mesh.world_group, data_group=mesh.data_group, n_data=mesh.n_data)
        loss.backward()
        grads, metrics = reduced_grads(params, metrics, mesh.world_group)
        return metrics["train_loss"], metrics, grads

    return loss_and_grad


def make_spatial_train_step(model: nn.Module, tx: Optimizer, config: ExperimentConfig,
                            mesh: Mesh):
    """``train_step(state, labels, mask, seed) -> (state, metrics)``: the spatial
    loss and gradient (:func:`make_spatial_loss_and_grad`), then the optimiser
    and the EMA, the same on every rank. ``seed`` is folded with the step here,
    as JAX folds its key."""
    from flowtrain_stochastic_interpolation_torch.utils.rng import fold_seed

    loss_and_grad = make_spatial_loss_and_grad(model, config, mesh)
    names = [name for name, _ in model.named_parameters()]

    def train_step(state: TrainState, labels: torch.Tensor, mask: Optional[torch.Tensor],
                   seed: int):
        _, metrics, grads = loss_and_grad(state, labels, mask, fold_seed(seed, state.step))
        params = [state.params[k] for k in names]
        return state, apply_update(state, tx, config, params, grads, metrics)

    return train_step
