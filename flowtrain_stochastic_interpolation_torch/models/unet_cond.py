"""The conditional 3-D UNet: velocity conditioned on the observations ATb.

Port of ``flowtrain_stochastic_interpolation_tpu/models/unet_cond.py``.
``ATb`` has the shape of the state ``x``: the embedded volume on the observed
voxels, zero elsewhere. The trained variant, ``v3`` (the default):

* ATb is "opened" once by a 7³ conv at data width (``init_conv_ATb``), and x
  enters through its own 7³ conv (``init_conv_x``);
* at every down and up stage the opened ATb is resized to the stage's
  resolution and embedded to its width (:class:`EmbedATb`: resize, conv5,
  SiLU, conv5), then fused into the feature map by a time-conditioned
  concat-mix residual block (:class:`MixATb`);
* everything else is the unconditional UNet (:class:`models.unet.UNet`), with
  the same blocks and the same attention dispatch (the folded kernels K1 and
  K2 at ≥ 4096 tokens on the card).

``v2`` mixes without the time FiLM and the norm; ``v1`` embeds with conv3s
and adds the embedding to x at the down stages only.

The constructor options of :class:`models.unet.UNet` hold here too, the
``spatial_group`` among them: the towers' resize is then the sharded one and
their convs exchange halos, as the JAX ``EmbedATb`` does under ``spatial_axis``. With
``self_condition`` the self-conditioning input joins x (not ATb) before
``init_conv_x``, which then takes twice the data channels. Under a
whole-forward checkpoint with ``save_atb`` (``train.steps``), the towers run
inside :func:`models.remat.named_region` ``("atb_tower")``, so that the
policy keeps their outputs.

The two towers see only ATb, so they give the same result at every velocity
evaluation of a solve; the forward recomputes them each time, as the JAX
module does.

Submodules carry the flax names (``init_conv_ATb``, ``downs_0_atb_embed``,
``ups_4_atb_mix``, ...), so :func:`models.persistence.params_from_jax` maps the
JAX tree onto the ``state_dict`` leaf by leaf.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from flowtrain_stochastic_interpolation_torch.config import ModelConfig
from flowtrain_stochastic_interpolation_torch.models.layers import Dense, RMSNorm, conv_nd, resize
from flowtrain_stochastic_interpolation_torch.models.remat import named_region
from flowtrain_stochastic_interpolation_torch.models.unet import UNet

VARIANTS = ("v1", "v2", "v3")


class EmbedATb(nn.Module):
    """Resize the opened ATb by ``scale_factor`` (align-corners trilinear), then
    conv → SiLU → conv to ``dim_out`` channels (5³ kernels; 3³ in v1)."""

    def __init__(self, ch_in: int, dim_out: int, scale_factor: float = 1.0, kernel: int = 5,
                 *, spatial_group=None, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.scale_factor = scale_factor
        self.spatial_group = spatial_group
        kw = dict(spatial_group=spatial_group, dtype=dtype, device=device)
        self.conv1 = conv_nd(ch_in, dim_out, kernel, **kw)
        self.conv2 = conv_nd(dim_out, dim_out, kernel, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with named_region("atb_tower"):
            if self.scale_factor != 1.0:
                x = resize(x, self.scale_factor, self.spatial_group)
            return self.conv2(F.silu(self.conv1(x)))


class MixATb(nn.Module):
    """Concat-mix residual fuse of the embedded ATb into the feature map.

    ``cat(x, atb)`` (2·dim channels), FiLMed by the time embedding (SiLU →
    ``Dense(4·dim)`` → scale and shift over the 2·dim channels, applied as
    ``h·(scale + 1) + shift``), then conv3 → RMSNorm → SiLU → conv3, plus x.
    ``time_film=False, use_norm=False`` is the v2 mix.
    """

    def __init__(self, dim: int, time_dim: int, *, time_film: bool = True,
                 use_norm: bool = True, spatial_group=None, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        sp = dict(kw, spatial_group=spatial_group)
        self.time_mlp = Dense(time_dim, dim * 4, **kw) if time_film else None
        self.conv1 = conv_nd(2 * dim, dim, 3, **sp)
        self.norm = RMSNorm(dim, device=device) if use_norm else None
        self.conv2 = conv_nd(dim, dim, 3, **sp)

    def forward(self, x: torch.Tensor, atb: torch.Tensor,
                t: Optional[torch.Tensor]) -> torch.Tensor:
        h = torch.cat([x, atb], dim=-1)
        if self.time_mlp is not None and t is not None:
            tv = self.time_mlp(F.silu(t))
            tv = tv.reshape(tv.shape[0], 1, 1, 1, tv.shape[-1])
            scale, shift = torch.chunk(tv, 2, dim=-1)
            h = h * (scale + 1.0) + shift
        h = self.conv1(h)
        if self.norm is not None:
            h = self.norm(h)
        return self.conv2(F.silu(h)) + x


class UNet3DCond(UNet):
    """Conditional 3-D attention UNet; the arguments are :class:`UNet`'s and
    ``variant`` ("v3", "v2" or "v1")."""

    def __init__(self, dim: int, *args, variant: str = "v3", **kwargs):
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; options: {VARIANTS}")
        super().__init__(dim, *args, **kwargs)
        self.variant = variant
        data_channels = self.init_conv_ATb.weight.shape[1]
        kw = dict(dtype=self.dtype, device=self.init_conv_x.weight.device,
                  spatial_group=self.spatial_group)
        time_dim = dim * 4
        dims = [dim] + [dim * m for m in self.dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n = self.n_stages
        kernel = 3 if variant == "v1" else 5

        def towers(name: str, ch: int, scale: float) -> None:
            setattr(self, f"{name}_embed",
                    EmbedATb(data_channels, ch, scale, kernel, **kw))
            if variant != "v1":
                setattr(self, f"{name}_mix", MixATb(
                    ch, time_dim, time_film=variant == "v3", use_norm=variant == "v3", **kw))

        for i, (dim_in, _) in enumerate(in_out):
            towers(f"downs_{i}_atb", dim_in, 0.5**i)
        if variant != "v1":  # v1 conditions on the down path only
            for i, (_, dim_out) in enumerate(in_out[::-1]):
                towers(f"ups_{i}_atb", dim_out, 0.5 ** (n - i - 1))
        self.eval()

    def _input_convs(self, data_channels: int, dim: int, kw: dict) -> None:
        self.init_conv_ATb = conv_nd(data_channels, data_channels, 7, **kw)
        self.init_conv_x = conv_nd(data_channels * (1 + self.self_condition), dim, 7, **kw)

    @classmethod
    def from_config(cls, cfg: ModelConfig, *, device=None,
                    spatial_group=None) -> "UNet3DCond":
        """The conditional UNet of a :class:`config.ModelConfig` (``cond_variant``),
        X-sharded over ``spatial_group`` when one is given.

        Built on ``cuda`` unless ``device`` names another (:func:`device.resolve_device`).
        """
        if not cfg.conditional:
            raise ValueError("an unconditional config builds a UNet (models.unet)")
        return cls(**cls.config_kwargs(cfg, device, spatial_group), variant=cfg.cond_variant)

    def forward(self, x: torch.Tensor, atb: torch.Tensor, time: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                x_self_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Velocity ``[B, X, Y, Z, C]`` f32 of the state ``x`` given ``atb`` (same
        shape); ``generator`` draws the dropout masks in training;
        ``x_self_cond`` as :meth:`UNet.forward`'s."""
        if x.shape != atb.shape:
            raise ValueError(f"x {tuple(x.shape)} vs ATb {tuple(atb.shape)}")
        self.check_spatial(x)
        dt = self.dtype or x.dtype
        atb_opened = self.init_conv_ATb(atb.to(dt))
        x = self.init_conv_x(self.with_self_cond(x.to(dt), x_self_cond))
        t = self.time_mlp(time.to(dt))

        def fuse(name: str, h: torch.Tensor) -> torch.Tensor:
            embed = getattr(self, f"{name}_embed", None)
            if embed is None:  # v1's up stages
                return h
            atb_scaled = embed(atb_opened)
            if self.variant == "v1":
                return h + atb_scaled
            return getattr(self, f"{name}_mix")(h, atb_scaled, t)

        return self.trunk(x, t, generator, fuse)
