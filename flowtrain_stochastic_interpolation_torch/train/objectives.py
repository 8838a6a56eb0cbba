"""The training objectives, unconditional and conditional.

Port of ``flowtrain_stochastic_interpolation_tpu/train/objectives.py``:

* :func:`unconditional_loss`: embed the categorical batch, add ``x1_noise``
  Gaussian noise, draw X0 ~ N(0, 1) and T ~ U(time_range), interpolate with
  the one-sided linear interpolant, and match the velocity with the relative
  MSE ``mse(VT, V̂) / mse(VT, 0)``, reduced in f32;
* :func:`conditional_loss`: the same flow loss (with eps 1e-6 in the
  denominator) for the conditional UNet given ``ATb = X1_clean · mask`` under
  the combined borehole and surface mask, plus the straight-line
  reconstruction ``XT + (1 - T)·V̂`` held to the clean X1 on the masked
  elements, weighted by ``mean(T)`` and ``lambda_reconstruct``.

The random draws come from a ``torch.Generator`` and are not the JAX
package's; a caller may pass its own ``draws`` (a test hands both sides the
same tensors). ``objective_dtype`` (bf16 for the 128³ memory form) is the
storage dtype of the drawn and interpolated volumes; T stays f32 and the loss
reduces in f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from flowtrain_stochastic_interpolation_torch.interpolants import Interpolant
from flowtrain_stochastic_interpolation_torch.ops.embedding import embed
from flowtrain_stochastic_interpolation_torch.ops.masks import make_combined_mask


def _rel_mse(target: torch.Tensor, pred: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """``mean((pred - target)²) / (mean(target²) + eps)``, reduced in f32."""
    diff = pred.float() - target.float()
    return diff.square().mean() / (target.float().square().mean() + eps)


def _draw_common(generator: torch.Generator, batch: torch.Tensor, table: torch.Tensor,
                 time_range: Tuple[float, float], x1_noise: float,
                 dtype: Optional[torch.dtype] = None):
    """Draw ``(X1_clean, X1, X0, T)``: the volumes in ``dtype`` (the table's when
    None), T in f32."""
    x1_clean = embed(batch, table)  # [B, X, Y, Z, E]
    if dtype is not None:
        x1_clean = x1_clean.to(dtype)
    kw = dict(generator=generator, device=x1_clean.device, dtype=x1_clean.dtype)
    # the noise scale in the volumes' dtype first, as JAX's asarray(x1_noise, dtype)
    noise_scale = torch.tensor(x1_noise, dtype=x1_clean.dtype, device=x1_clean.device)
    x1 = x1_clean + noise_scale * torch.randn(x1_clean.shape, **kw)
    x0 = torch.randn(x1.shape, **kw)
    lo, hi = time_range
    t = lo + (hi - lo) * torch.rand(x1.shape[0], generator=generator, device=x1.device,
                                    dtype=torch.float32)
    return x1_clean, x1, x0, t


def unconditional_loss(
    model: nn.Module,
    batch: torch.Tensor,
    table: torch.Tensor,
    generator: torch.Generator,
    *,
    interpolant: Interpolant,
    time_range: Tuple[float, float],
    x1_noise: float = 1e-3,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    objective_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Relative-MSE flow objective of the categorical ``batch`` ``[B, X, Y, Z]``.

    ``draws = (X1, X0, T)`` replaces the random draws. ``generator`` also draws
    the model's dropout masks when the model is in training.
    """
    if draws is None:
        _, x1, x0, t = _draw_common(generator, batch, table, time_range, x1_noise,
                                    objective_dtype)
    else:
        x1, x0, t = draws
    xt, vt = interpolant.flow_objective(t, x0, x1)
    v_hat = model(xt, t, generator)
    loss = _rel_mse(vt, v_hat)
    return loss, {"train_loss": loss}


def conditional_loss(
    model: nn.Module,
    batch: torch.Tensor,
    table: torch.Tensor,
    generator: torch.Generator,
    *,
    interpolant: Interpolant,
    time_range: Tuple[float, float],
    x1_noise: float = 1e-4,
    lambda_reconstruct: float = 1.0,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    objective_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Flow loss plus the weighted straight-line reconstruction loss of the
    categorical ``batch`` ``[B, X, Y, Z]`` for a conditional UNet.

    ``generator`` draws, in this order: the combined mask (the borehole counts,
    then their jitter), the X1 noise, X0 and T, then (when the model is in
    training) the dropout masks. ``draws = (mask, X1, X0, T)`` replaces the
    random draws of the objective. The metrics are ``train_loss``,
    ``flow_loss`` and ``reconstruct_loss``.
    """
    if draws is None:
        mask = make_combined_mask(generator, batch)
        x1_clean, x1, x0, t = _draw_common(generator, batch, table, time_range, x1_noise,
                                           objective_dtype)
    else:
        mask, x1, x0, t = draws
        x1_clean = embed(batch, table)
        if objective_dtype is not None:
            x1_clean = x1_clean.to(objective_dtype)
    mask_f = mask[..., None].to(torch.float32)  # over the embedding channels
    atb = x1_clean * mask_f.to(x1_clean.dtype)  # observed before the X1 noise
    xt, vt = interpolant.flow_objective(t, x0, x1)
    v_hat = model(xt, atb, t, generator)
    flow_loss = _rel_mse(vt, v_hat, eps=1e-6)

    t_b = t.reshape(-1, 1, 1, 1, 1).to(xt.dtype)
    b_hat = (xt + (1.0 - t_b) * v_hat).float()
    # a mean over masked elements: the mask counts voxels, the error spans E channels
    n_masked = mask_f.sum().clamp_min(1.0) * x1.shape[-1]
    masked_mse = ((b_hat - x1_clean.float()).square() * mask_f).sum() / n_masked
    denom = x1.float().square().mean() + 1e-6
    reconstruct_loss = t.mean() * masked_mse / denom

    loss = flow_loss + lambda_reconstruct * reconstruct_loss
    return loss, {"train_loss": loss, "flow_loss": flow_loss,
                  "reconstruct_loss": reconstruct_loss}
