"""The attention UNets that predict the stochastic-interpolation velocity.

Port of ``flowtrain_stochastic_interpolation_tpu/models/unet.py``:
7³ init conv, per-stage [res, res, attn, resample] downs, full-attention
bottleneck, mirrored ups with two skip concats per stage, a final res block on
the concat with the init residual, and a 1×1 out conv. Layout is channels-last
``[B, X, Y, Z, C]``; time is a ``[B]`` vector; the output is float32.

:class:`UNet2D` (``UNet(ndim=2)``) is the 2-D twin for the toy experiments, on
``[B, H, W, C]``: 7×7 and 3×3 convs (:class:`models.layers.Conv2d`), nearest ×2
upsampling (:class:`Upsample2D`) and space-to-depth downsampling
(:class:`Downsample2D`) in place of the trilinear resizes, and the same blocks
and attention, whose dispatch rules read the token count whatever the spatial
shape.

Every constructor option of the flax module is here: the time embedding
(sinusoidal with ``time_sin_pos``, else LearnedFourier with
``time_learned_emb``, else RandomFourier, whose frozen features are buffers),
``self_condition`` (``x_self_cond``, zeros when absent, concatenated before x
on the channels, so the 7³ input conv takes twice the data channels),
``attn_enabled=False`` (no attention module and no residual add) and
``remat_blocks`` (an activation checkpoint around each ResnetBlock and each
attention module while gradients are on: :func:`models.remat.checkpoint`,
which replays the dropout generator's draws in the recompute).

A UNet is built in eval mode, the deterministic forward that the flax
module's ``deterministic=True`` default gives (and that sampling needs).
``model.train()`` (as ``train.steps.make_train_step`` does) turns on the
dropout of every ResnetBlock's ``block1``; its masks come from the
``generator`` passed to :meth:`UNet.forward`.

With a ``spatial_group`` (the flax module's ``spatial_axis``) the model runs
on one X slab of the volume per rank of that ``torch.distributed`` group:
every conv larger than 1×1 exchanges halos, the resamplings are the sharded
resize, and attention is ring attention or the collective linear attention
(:mod:`parallel.spatial`). The parameters are the same as without it, so the
same ``state_dict`` (or JAX tree) loads into either.

Submodules carry the flax module names (``downs_0_block1``, ``mid_attn``,
``ups_2_upsample``, ...), so the JAX package's parameter tree maps onto this
module's ``state_dict`` leaf by leaf (:func:`models.persistence.params_from_jax`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn

from flowtrain_stochastic_interpolation_torch.config import ModelConfig
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.models.attention import (
    Attention,
    LinearAttention,
)
from flowtrain_stochastic_interpolation_torch.models.layers import (
    Dense,
    Downsample,
    ResnetBlock,
    TimeMLP,
    Upsample,
    conv_nd,
)
from flowtrain_stochastic_interpolation_torch.models.remat import checkpoint


# the config's compute dtype, as the JAX package maps it: "float32" is flax's
# dtype=None (each layer computes in its input's dtype or promotes it to the f32
# params, models.layers), which differs from bf16 only where the inputs are bf16
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def _cast_tuple(v, length: int) -> tuple:
    if isinstance(v, (tuple, list)):
        if len(v) != length:
            raise ValueError(f"expected {length} values, got {len(v)}")
        return tuple(v)
    return (v,) * length


class Upsample2D(nn.Module):
    """Nearest ×2 + 3×3 conv on ``[B, H, W, C]``."""

    def __init__(self, ch_in: int, ch_out: int, *, dtype=None, device=None):
        super().__init__()
        self.conv = conv_nd(ch_in, ch_out, 3, ndim=2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
        return self.conv(x)


class Downsample2D(nn.Module):
    """Space-to-depth (2×2 patches, channels in ``(c, p1, p2)`` order, the
    reference's) + a Dense, on ``[B, H, W, C]``."""

    def __init__(self, ch_in: int, ch_out: int, *, dtype=None, device=None):
        super().__init__()
        self.conv = Dense(ch_in * 4, ch_out, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        return self.conv(x.reshape(b, h // 2, w // 2, c * 4))


class UNet(nn.Module):
    """Attention UNet over ``ndim`` (3 or 2) spatial axes; the arguments mirror
    the flax module's attributes."""

    def __init__(
        self,
        dim: int,
        dim_mults: Sequence[int] = (1, 2, 4, 8),
        data_channels: int = 3,
        self_condition: bool = False,
        time_resolution: int = 64,
        time_sin_pos: bool = False,
        time_bandwidth: float = 100.0,
        time_learned_emb: bool = False,
        attn_enabled: bool = True,
        attn_dim_head: Union[int, Sequence[int]] = 64,
        attn_heads: Union[int, Sequence[int]] = 4,
        full_attn: Optional[Sequence[bool]] = None,
        dropout: float = 0.0,
        flash_attn: bool = True,
        fused_folded_attn: bool = True,
        folded_attn_vjp: Optional[str] = None,
        remat_blocks: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
        spatial_group=None,
        ndim: int = 3,
    ):
        super().__init__()
        if ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {ndim}")
        self.dim = dim
        self.ndim = ndim
        self.spatial_group = spatial_group
        self.self_condition = self_condition
        self.remat_blocks = remat_blocks
        self.dim_mults = tuple(dim_mults)
        self.dtype = dtype
        n_stages = len(self.dim_mults)
        dims = [dim] + [dim * m for m in self.dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        full = tuple(full_attn) if full_attn else (False,) * (n_stages - 1) + (True,)
        heads = _cast_tuple(attn_heads, n_stages)
        dim_heads = _cast_tuple(attn_dim_head, n_stages)
        time_dim = dim * 4
        kw = dict(dtype=dtype, device=device)
        sp = dict(kw, spatial_group=spatial_group)
        nd = dict(sp, ndim=ndim)  # a 2-D conv raises on a spatial_group: 3-D only
        up, down = (Upsample, Downsample) if ndim == 3 else (Upsample2D, Downsample2D)
        resample = sp if ndim == 3 else kw

        def attn(ch, is_full, h, dh):
            if not attn_enabled:
                return None
            if is_full:
                return Attention(ch, h, dh, flash=flash_attn, **sp)
            return LinearAttention(ch, h, dh, fused_folded=fused_folded_attn,
                                   folded_vjp=folded_attn_vjp, **sp)

        def res(ch_in, ch_out):
            return ResnetBlock(ch_in, ch_out, time_dim, dropout=dropout, **nd)

        self._input_convs(data_channels, dim, nd)
        self.time_mlp = TimeMLP(time_resolution, time_dim, sin_pos=time_sin_pos,
                                learned_emb=time_learned_emb, bandwidth=time_bandwidth, **kw)

        skip_dims = []
        for i, (dim_in, dim_out) in enumerate(in_out):
            setattr(self, f"downs_{i}_block1", res(dim_in, dim_in))
            setattr(self, f"downs_{i}_block2", res(dim_in, dim_in))
            setattr(self, f"downs_{i}_attn", attn(dim_in, full[i], heads[i], dim_heads[i]))
            skip_dims += [dim_in, dim_in]
            last = i >= n_stages - 1
            setattr(self, f"downs_{i}_downsample", conv_nd(dim_in, dim_out, 3, **nd) if last
                    else down(dim_in, dim_out, **resample))

        mid_dim = dims[-1]
        self.mid_block1 = res(mid_dim, mid_dim)
        self.mid_attn = attn(mid_dim, True, heads[-1], dim_heads[-1])
        self.mid_block2 = res(mid_dim, mid_dim)

        ch = mid_dim
        for i, ((dim_in, dim_out), fa, hh, dh) in enumerate(
            zip(in_out[::-1], full[::-1], heads[::-1], dim_heads[::-1])
        ):
            setattr(self, f"ups_{i}_block1", res(ch + skip_dims.pop(), dim_out))
            setattr(self, f"ups_{i}_block2", res(dim_out + skip_dims.pop(), dim_out))
            setattr(self, f"ups_{i}_attn", attn(dim_out, fa, hh, dh))
            last = i == n_stages - 1
            setattr(self, f"ups_{i}_upsample",
                    conv_nd(dim_out, dim_in, 3, **nd) if last else up(dim_out, dim_in, **resample))
            ch = dim_in

        self.final_res_block = res(ch + dim, dim)
        self.final_conv = Dense(dim, data_channels, **kw)
        self.n_stages = n_stages
        self.eval()

    def _input_convs(self, data_channels: int, dim: int, kw: dict) -> None:
        self.init_conv = conv_nd(data_channels * (1 + self.self_condition), dim, 7, **kw)

    @staticmethod
    def config_kwargs(cfg: ModelConfig, device=None, spatial_group=None) -> dict:
        """The constructor's arguments for a :class:`config.ModelConfig`."""
        return dict(
            dim=cfg.dim, dim_mults=cfg.dim_mults, data_channels=cfg.data_channels,
            self_condition=cfg.self_condition, time_resolution=cfg.time_resolution,
            time_sin_pos=cfg.time_sin_pos, time_bandwidth=cfg.time_bandwidth,
            time_learned_emb=cfg.time_learned_emb, attn_enabled=cfg.attn_enabled,
            attn_dim_head=cfg.attn_dim_head, attn_heads=cfg.attn_heads,
            full_attn=cfg.full_attn, dropout=cfg.dropout, flash_attn=cfg.flash_attn,
            fused_folded_attn=cfg.fused_folded_attn, folded_attn_vjp=cfg.attn_folded_vjp,
            remat_blocks=cfg.remat_blocks, dtype=COMPUTE_DTYPES.get(cfg.dtype),
            device=resolve_device(device), spatial_group=spatial_group,
        )

    @classmethod
    def from_config(cls, cfg: ModelConfig, *, device=None, spatial_group=None) -> "UNet":
        """The UNet of an unconditional :class:`config.ModelConfig`, X-sharded over
        ``spatial_group`` when one is given.

        Built on ``cuda`` unless ``device`` names another (:func:`device.resolve_device`).
        """
        if cfg.conditional:
            raise ValueError("a conditional config builds a UNet3DCond (models.unet_cond)")
        return cls(**cls.config_kwargs(cfg, device, spatial_group))

    @property
    def downsample_factor(self) -> int:
        return 2 ** (self.n_stages - 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded flax-style initialisation of every parameter."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def check_spatial(self, x: torch.Tensor) -> None:
        """Each (local) spatial dim must divide by the downsampling factor."""
        spatial = tuple(x.shape[1:1 + self.ndim])
        for d in spatial:
            if d % self.downsample_factor:
                raise ValueError(
                    f"spatial dims {spatial} must be divisible by "
                    f"{self.downsample_factor}"
                )

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                x_self_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Velocity ``[B, *spatial, C]`` f32; ``generator`` draws the dropout masks
        in training; ``x_self_cond`` is the self-conditioning input (zeros when
        None) of a model built with ``self_condition``."""
        self.check_spatial(x)
        x = self.with_self_cond(x, x_self_cond)
        x = x.to(self.dtype or x.dtype)
        t = self.time_mlp(time.to(x.dtype))
        return self.trunk(self.init_conv(x), t, generator)

    def with_self_cond(self, x: torch.Tensor, x_self_cond: Optional[torch.Tensor]) -> torch.Tensor:
        """``cat(x_self_cond or zeros, x)`` on the channels with ``self_condition``,
        else x (whose ``x_self_cond`` must then be None)."""
        if not self.self_condition:
            if x_self_cond is not None:
                raise ValueError("x_self_cond given to a model built without self_condition")
            return x
        if x_self_cond is None:
            x_self_cond = torch.zeros_like(x)
        return torch.cat([x_self_cond.to(x.dtype), x], dim=-1)

    def _res(self, name: str, x: torch.Tensor, t: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        block = getattr(self, name)
        if self.remat_blocks and torch.is_grad_enabled():
            return checkpoint(block, x, t, generator=generator)
        return block(x, t, generator)

    def _attn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """``attn(x) + x``, or x where attention is off."""
        attn = getattr(self, name)
        if attn is None:
            return x
        if self.remat_blocks and torch.is_grad_enabled():
            return checkpoint(lambda h, _: attn(h), x) + x
        return attn(x) + x

    def trunk(self, x: torch.Tensor, t: torch.Tensor, generator: Optional[torch.Generator],
              fuse: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
        """Stages, bottleneck and output head, from the input conv's output ``x``
        and the time embedding ``t``. ``fuse(name, x)``, where given, runs at the
        start of every down and up stage (``name`` is ``downs_{i}_atb`` or
        ``ups_{i}_atb``), before its first block."""
        n = self.n_stages
        r = x
        skips = []
        for i in range(n):
            if fuse is not None:
                x = fuse(f"downs_{i}_atb", x)
            x = self._res(f"downs_{i}_block1", x, t, generator)
            skips.append(x)
            x = self._res(f"downs_{i}_block2", x, t, generator)
            x = self._attn(f"downs_{i}_attn", x)
            skips.append(x)
            x = getattr(self, f"downs_{i}_downsample")(x)

        x = self._res("mid_block1", x, t, generator)
        x = self._attn("mid_attn", x)
        x = self._res("mid_block2", x, t, generator)

        for i in range(n):
            if fuse is not None:
                x = fuse(f"ups_{i}_atb", x)
            x = torch.cat([x, skips.pop()], dim=-1)
            x = self._res(f"ups_{i}_block1", x, t, generator)
            x = torch.cat([x, skips.pop()], dim=-1)
            x = self._res(f"ups_{i}_block2", x, t, generator)
            x = self._attn(f"ups_{i}_attn", x)
            x = getattr(self, f"ups_{i}_upsample")(x)

        x = torch.cat([x, r], dim=-1)
        x = self._res("final_res_block", x, t, generator)
        return self.final_conv(x).float()


UNet3D = UNet


class UNet2D(UNet):
    """The 2-D attention UNet: :class:`UNet` with ``ndim=2``."""

    def __init__(self, dim: int, *args, **kwargs):
        super().__init__(dim, *args, ndim=2, **kwargs)
