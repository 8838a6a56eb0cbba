"""Building blocks of the UNets, channels-last ``[B, X, Y, Z, C]`` (3-D) or
``[B, H, W, C]`` (2-D).

Port of ``flowtrain_stochastic_interpolation_tpu/models/layers.py``. Parameters
are stored in float32; each layer computes in its ``dtype`` (bfloat16 on the
flagship) by casting its input and weights at the call, as the flax layers'
``dtype`` does. Without one (an f32 model, flax's ``dtype=None``) each keeps
the JAX layer's rule: a convolution computes in its input's dtype (JAX's
``Conv3DFast``), a :class:`Dense` in the input's and the params' promoted
dtype (flax ``nn.Dense``). 1×1 convolutions are channel :class:`Dense` layers.

The JAX package's 3³ and 7³ convolutions pick among XLA formulations for the
TPU (``ops/fat_conv.py``, ``ops/packed_conv.py``); all compute the same SAME
convolution, which here is ``F.conv3d`` (cuDNN on the card) in the
``channels_last_3d`` memory format that the ``[B, X, Y, Z, C]`` layout is.

The 2-D layers (``ndim=2``, the JAX ``UNet2D``'s) are flax ``nn.Conv``: a 3×3
or 7×7 SAME :class:`Conv2d`, ``F.conv2d`` in ``channels_last``, which without
a ``dtype`` promotes its input to the f32 params as a :class:`Dense` does.

Parameter names follow the flax modules' (``kernel`` becomes ``weight``), so
:func:`models.persistence.params_from_jax` maps one tree onto the other.

Spatial parallelism (the JAX layers' ``spatial_axis``): with a
``spatial_group`` (a ``torch.distributed`` group over which the X axis is
sharded), :func:`conv_nd` gives a :class:`SpatialConv3d` for kernels larger
than 1 (the halo-exchange conv of :mod:`parallel.spatial`, with
:class:`Conv3d`'s parameters), and :class:`Upsample` / :class:`Downsample`
resize with :func:`parallel.spatial.sharded_resize3d`.
Initialisers follow flax's defaults: LeCun-normal kernels, zero biases, unit
RMSNorm gains.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from flowtrain_stochastic_interpolation_torch.models.resize import resize3d
from flowtrain_stochastic_interpolation_torch.parallel.spatial import (
    halo_conv3d,
    sharded_resize3d,
)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    # flax's lecun_normal: truncated normal (±2σ) with variance 1 / fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)


class Dense(nn.Module):
    """Channel dense layer: flax ``nn.Dense`` with the kernel stored as ``[out, in]``."""

    def __init__(self, in_features: int, out_features: int, *, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # without a dtype, flax's rule: the input's and the f32 params' promoted
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv3d(nn.Module):
    """3-D SAME convolution (stride 1, odd kernel, with bias) on ``[B, X, Y, Z, C]``.

    The weight is torch's ``[out, in, k, k, k]`` (the flax kernel is
    ``[k, k, k, in, out]``).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int, *,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.padding = kernel // 2
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel, kernel, device=device)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        fmt = torch.channels_last_3d
        xc = x.to(dt).permute(0, 4, 1, 2, 3).contiguous(memory_format=fmt)
        w = self.weight.to(dt).contiguous(memory_format=fmt)
        y = F.conv3d(xc, w, self.bias.to(dt), padding=self.padding)
        return y.permute(0, 2, 3, 4, 1).contiguous()


class SpatialConv3d(Conv3d):
    """:class:`Conv3d` over an X-sharded volume: the halo exchange over
    ``spatial_group``, then the conv VALID along X (the JAX ``SpatialConv3D``).
    The parameters are :class:`Conv3d`'s, so weights interchange."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, *, spatial_group,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(in_channels, out_channels, kernel, dtype=dtype, device=device)
        self.spatial_group = spatial_group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return halo_conv3d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.spatial_group)


class Conv2d(nn.Module):
    """2-D SAME convolution (stride 1, odd kernel, with bias) on ``[B, H, W, C]``:
    flax ``nn.Conv``, whose compute dtype without a ``dtype`` is the input's and
    the f32 params' promoted one. The weight is torch's ``[out, in, k, k]``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, *,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.padding = kernel // 2
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        fmt = torch.channels_last
        xc = x.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=fmt)
        w = self.weight.to(dt).contiguous(memory_format=fmt)
        y = F.conv2d(xc, w, self.bias.to(dt), padding=self.padding)
        return y.permute(0, 2, 3, 1).contiguous()


def conv_nd(in_channels: int, out_channels: int, kernel: int, *, ndim: int = 3,
            spatial_group=None, dtype: Optional[torch.dtype] = None, device=None) -> nn.Module:
    """The SAME conv over ``ndim`` spatial axes: a :class:`Conv2d` in 2-D; in 3-D a
    :class:`SpatialConv3d` with a ``spatial_group`` and a kernel larger than 1,
    else a :class:`Conv3d`."""
    if ndim == 2:
        if spatial_group is not None:
            raise ValueError("spatial parallelism is 3-D only")
        return Conv2d(in_channels, out_channels, kernel, dtype=dtype, device=device)
    if spatial_group is not None and kernel > 1:
        return SpatialConv3d(in_channels, out_channels, kernel, spatial_group=spatial_group,
                             dtype=dtype, device=device)
    return Conv3d(in_channels, out_channels, kernel, dtype=dtype, device=device)


class RMSNorm(nn.Module):
    """RMS normalisation over channels with a learnable gain.

    ``x / max(‖x‖, 1e-12) * g * sqrt(C)``: the norm is taken in float32, the
    division and the gain in the input's dtype.
    """

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.dim = dim
        self.g = nn.Parameter(torch.ones(dim, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
        normed = x / norm.clamp_min(1e-12).to(x.dtype)
        return normed * (self.g * math.sqrt(self.dim)).to(x.dtype)


def resize(x: torch.Tensor, scale: float, spatial_group=None) -> torch.Tensor:
    """:func:`models.resize.resize3d`, or its sharded form with a ``spatial_group``."""
    if spatial_group is None:
        return resize3d(x, scale)
    return sharded_resize3d(x, scale, spatial_group)


class Upsample(nn.Module):
    """×2 align-corners trilinear upsample + 3³ conv."""

    def __init__(self, ch_in: int, ch_out: int, *, spatial_group=None, dtype=None,
                 device=None):
        super().__init__()
        self.spatial_group = spatial_group
        self.conv = conv_nd(ch_in, ch_out, 3, spatial_group=spatial_group, dtype=dtype,
                            device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(resize(x, 2.0, self.spatial_group))


class Downsample(nn.Module):
    """×0.5 align-corners trilinear downsample + 1×1 conv."""

    def __init__(self, ch_in: int, ch_out: int, *, spatial_group=None, dtype=None,
                 device=None):
        super().__init__()
        self.spatial_group = spatial_group
        self.conv = Dense(ch_in, ch_out, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(resize(x, 0.5, self.spatial_group))


class SinusoidalPosEmb(nn.Module):
    """Fixed sin/cos features, interleaved ``(sin, cos)`` pairs, with frequencies
    ``exp(-(i + 1)·log(theta) / (dim / 2))`` indexed from i + 1; no parameters."""

    def __init__(self, dim: int, theta: float = 10000.0):
        super().__init__()
        self.dim, self.theta = dim, theta

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        step = math.log(self.theta) / half
        freqs = torch.exp(torch.arange(1, half + 1, device=t.device, dtype=torch.float32) * -step)
        arg = t[:, None] * freqs[None, :]
        return torch.stack([torch.sin(arg), torch.cos(arg)], dim=-1).reshape(t.shape[0], -1)


class _FourierEmbedding(nn.Module):
    """``cos(t·f + φ)·√2`` with f ~ N(0, bw²) and φ ~ U(0, 1): the phase is added
    before any 2π, the reference's quirk, so it spans a fraction of a period."""

    def __init__(self, bandwidth: float):
        super().__init__()
        self.bandwidth = bandwidth

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.freqs.normal_(0.0, 1.0, generator=generator).mul_(self.bandwidth)
            self.phases.uniform_(0.0, 1.0, generator=generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        y = t[:, None] * self.freqs[None, :] + self.phases[None, :]
        return torch.cos(y) * math.sqrt(2.0)


class LearnedFourierEmbedding(_FourierEmbedding):
    """Trainable Fourier features: f and φ are parameters."""

    def __init__(self, num_channels: int, bandwidth: float = 100.0, device=None):
        super().__init__(bandwidth)
        self.freqs = nn.Parameter(torch.empty(num_channels, device=device))
        self.phases = nn.Parameter(torch.empty(num_channels, device=device))


class RandomFourierEmbedding(_FourierEmbedding):
    """Frozen Fourier features: f and φ are persistent buffers (the JAX
    ``constants`` collection), in the ``state_dict`` but out of the
    optimiser's and the EMA's reach."""

    def __init__(self, num_channels: int, bandwidth: float = 100.0, device=None):
        super().__init__(bandwidth)
        self.register_buffer("freqs", torch.empty(num_channels, device=device))
        self.register_buffer("phases", torch.empty(num_channels, device=device))


class TimeMLP(nn.Module):
    """Time embedding → Dense(time_dim) → exact GELU → Dense(time_dim). The
    embedding is sinusoidal with ``sin_pos``, else LearnedFourier with
    ``learned_emb``, else RandomFourier."""

    def __init__(self, time_resolution: int, time_dim: int, *, sin_pos: bool = False,
                 learned_emb: bool = False, bandwidth: float = 100.0, dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        if sin_pos:
            self.embed = SinusoidalPosEmb(time_resolution)
        elif learned_emb:
            self.embed = LearnedFourierEmbedding(time_resolution, bandwidth, device=device)
        else:
            self.embed = RandomFourierEmbedding(time_resolution, bandwidth, device=device)
        self.fc1 = Dense(time_resolution, time_dim, dtype=dtype, device=device)
        self.fc2 = Dense(time_dim, time_dim, dtype=dtype, device=device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = self.embed(t)
        emb = emb.to(self.dtype or emb.dtype)
        return self.fc2(F.gelu(self.fc1(emb), approximate="none"))


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - p`` and scale kept values by
    ``1 / (1 - p)``. The mask is drawn in f32 from ``generator`` (the default
    generator of x's device when None)."""
    keep = 1.0 - p
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Block(nn.Module):
    """conv3 → RMSNorm → FiLM(scale+1, shift) → SiLU → dropout (in training only)."""

    def __init__(self, dim_in: int, dim_out: int, *, ndim: int = 3, dropout: float = 0.0,
                 spatial_group=None, dtype=None, device=None):
        super().__init__()
        self.dropout = dropout
        self.proj = conv_nd(dim_in, dim_out, 3, ndim=ndim, spatial_group=spatial_group,
                            dtype=dtype, device=device)
        self.norm = RMSNorm(dim_out, device=device)

    def forward(self, x: torch.Tensor,
                scale_shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        x = F.silu(x)
        if self.training and self.dropout > 0.0:
            x = dropout(x, self.dropout, generator)
        return x


class ResnetBlock(nn.Module):
    """Two Blocks with a time-FiLM on the first, plus a 1×1 residual; dropout in
    ``block1`` only, as the JAX package's ResnetBlock."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int, *, ndim: int = 3,
                 dropout: float = 0.0, spatial_group=None, dtype=None, device=None):
        super().__init__()
        self.ndim = ndim
        self.mlp = Dense(time_dim, dim_out * 2, dtype=dtype, device=device)
        self.block1 = Block(dim_in, dim_out, ndim=ndim, dropout=dropout,
                            spatial_group=spatial_group, dtype=dtype, device=device)
        self.block2 = Block(dim_out, dim_out, ndim=ndim, spatial_group=spatial_group,
                            dtype=dtype, device=device)
        self.res_conv = (Dense(dim_in, dim_out, dtype=dtype, device=device)
                         if dim_in != dim_out else None)

    def forward(self, x: torch.Tensor, time_emb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h_t = self.mlp(F.silu(time_emb))
        h_t = h_t.reshape(h_t.shape[0], *(1,) * self.ndim, h_t.shape[-1])
        h = self.block1(x, tuple(torch.chunk(h_t, 2, dim=-1)), generator)
        h = self.block2(h)
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x
