"""Align-corners trilinear resize of channels-last volumes.

Port of ``flowtrain_stochastic_interpolation_tpu/models/resize.py::resize3d``.
The JAX package writes the resize as per-axis interpolation matmuls for the
TPU's matrix unit; here it is ``F.interpolate(mode="trilinear",
align_corners=True)``, the same linear map, with the same floor-based output
sizing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def resize3d(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Trilinear align-corners resize of ``[B, X, Y, Z, C]`` by ``scale``."""
    size = tuple(int(math.floor(s * scale)) for s in x.shape[1:4])
    if size == tuple(x.shape[1:4]):
        return x
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=size, mode="trilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 4, 1).contiguous()
