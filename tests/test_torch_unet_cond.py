"""The port's conditional UNet against the flax ``UNet3DCond`` on the same weights
(CPU, f32).

Weights are drawn with numpy from a seed in the shapes of the JAX parameter
tree and reach the port through ``params_from_jax``; x, ATb and t are drawn the
same way and handed to both. Covered: the v3, v2 and v1 forwards at
``tiny_test(conditional=True)``; ``EmbedATb`` and ``MixATb`` alone;
``resize3d`` at the towers' scales; and a ``conditional_64``-width forward at
16³ whose 4096-token linear attentions take the folded path (the kernels'
plain versions on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_unet import random_params, random_tree

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.models import unet_cond as port_cond
from flowtrain_stochastic_interpolation_torch.models import attention
from flowtrain_stochastic_interpolation_torch.models.attention import LinearAttention
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.models.resize import resize3d
from flowtrain_stochastic_interpolation_torch.models.unet_cond import UNet3DCond
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.models import resize as jax_resize
from flowtrain_stochastic_interpolation_tpu.models import unet_cond as jax_cond
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _f32(cfg, **model):
    """``cfg`` in f32 without dropout (and with ``model`` overrides)."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", dropout=0.0, **model))


def _forward_pair(port_cfg, shape, seed):
    """The JAX and the port forward of one conditional config on the same
    numpy-drawn weights, x, ATb and t: ``(port, jax)`` outputs."""
    jax_cfg = jax_config.ExperimentConfig.from_dict(port_cfg.to_dict())
    e = port_cfg.data.embedding_dim
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, e)).astype(np.float32)
    atb = rng.standard_normal((*shape, e)).astype(np.float32)
    atb *= rng.uniform(size=shape)[..., None] < 0.3  # observed on about 30% of voxels
    t = rng.uniform(0.0, 1.0, (shape[0],)).astype(np.float32)
    jmodel = jax_build_model(jax_cfg)
    jx, jatb, jt = map(jnp.asarray, (x, atb, t))
    variables = random_params(jmodel, jx, jt, seed, port_cfg.model.time_bandwidth, atb=jatb)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jx, jatb, jt))

    mc = dataclasses.replace(port_cfg.model, data_channels=e)
    port = UNet3DCond.from_config(mc, device="cpu")
    port.load_state_dict(params_from_jax(variables, port))
    with torch.no_grad():
        out = port(*map(torch.from_numpy, (x, atb, t))).numpy()
    return out, ref


@pytest.mark.parametrize("variant", ["v3", "v2", "v1"])
def test_tiny_conditional_unet_matches_jax(variant):
    cfg = _f32(port_config.tiny_test(conditional=True), cond_variant=variant)
    out, ref = _forward_pair(cfg, (2, 8, 8, 8), 0)
    assert out.shape == ref.shape == (2, 8, 8, 8, 15)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_conditional_64_width_unet_matches_jax_at_16_cubed(monkeypatch):
    """dim 48, mults (1,2,2,3,4), 4 heads x 32, v3 towers at 16³ x b1: the
    4096-token linear attentions (down 0 and up 4) take the folded path on both
    sides, as on the card: the JAX one runs its Pallas kernels in interpret
    mode, the port's wrappers run the kernels' plain versions on CPU tensors.
    Both round p and v to bf16 for the products (the kernels' arithmetic), so
    this is held at the flagship-width tolerance, 2e-3; the einsum path gives
    outputs 2e-3 away from either."""
    folded = []
    monkeypatch.setattr(LinearAttention, "takes_folded", lambda self, qkv: (
        self.fused_folded and qkv.shape[1] >= attention._FOLDED_LINEAR_MIN_TOKENS
        and self.heads * self.dim_head % 128 == 0))  # the rule on the card, without is_cuda
    attend = LinearAttention.attend_folded
    monkeypatch.setattr(LinearAttention, "attend_folded",
                        lambda self, qkv: folded.append(qkv.shape[1]) or attend(self, qkv))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")  # the JAX module's folded rule
    with pltpu.force_tpu_interpret_mode():
        out, ref = _forward_pair(_f32(port_config.conditional_64()), (1, 16, 16, 16), 1)
    assert folded == [4096, 4096]
    assert out.shape == ref.shape == (1, 16, 16, 16, 15)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-3)


def test_embed_atb_matches_jax():
    """conv5 → SiLU → conv5 after a 1/4 resize: 15 → 24 channels, 16³ → 4³."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 16, 15)).astype(np.float32)
    jmod = jax_cond.EmbedATb(24, scale_factor=0.25, kernel=5)
    tree = random_tree(jmod, (jnp.asarray(x),), 2, 1.0)
    ref = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    mod = port_cond.EmbedATb(15, 24, 0.25, 5)
    mod.load_state_dict(params_from_jax(tree, mod))
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 4, 4, 4, 24)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", ["v3", "v2"])
def test_mix_atb_matches_jax(variant):
    """The time-FiLM concat-mix (v3) and the plain one (v2) at dim 12 with a
    time embedding of width 32: scale and shift span the 24-channel concat."""
    rng = np.random.default_rng(3)
    x, atb = (rng.standard_normal((2, 4, 4, 4, 12)).astype(np.float32) for _ in range(2))
    t = rng.standard_normal((2, 32)).astype(np.float32)
    v3 = variant == "v3"
    jmod = jax_cond.MixATb(12, time_film=v3, use_norm=v3)
    args = tuple(map(jnp.asarray, (x, atb, t)))
    tree = random_tree(jmod, args, 3, 1.0)
    ref = np.asarray(jmod.apply(tree, *args))
    mod = port_cond.MixATb(12, 32, time_film=v3, use_norm=v3)
    state = params_from_jax(tree, mod)
    assert ("time_mlp.weight" in state) == v3 and ("norm.g" in state) == v3
    if v3:
        assert state["time_mlp.weight"].shape == (48, 32)
    mod.load_state_dict(state)
    with torch.no_grad():
        out = mod(*map(torch.from_numpy, (x, atb, t))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("side", [64, 32, 16])
@pytest.mark.parametrize("scale", [1.0, 0.5, 0.25, 0.125, 0.0625])
def test_resize3d_matches_jax_at_the_tower_scales(side, scale):
    """``F.interpolate(align_corners=True)`` against JAX's dense align-corners
    matrices, with the same floor sizing (16 x 1/16 = 1 reads voxel 0). The
    source coordinate ``i·(n_in - 1)/(n_out - 1)`` is rounded to f32 by
    ``F.interpolate`` and taken in f64 by JAX: up to 3.5e-5 apart on these
    unit-normal inputs (64 -> 16), exact where the ratio is a power of two."""
    rng = np.random.default_rng(side)
    x = rng.standard_normal((1, side, side, side, 3)).astype(np.float32)
    ref = np.asarray(jax_resize.resize3d(jnp.asarray(x), scale))
    out = resize3d(torch.from_numpy(x), scale).numpy()
    n = int(np.floor(side * scale))
    assert out.shape == ref.shape == (1, n, n, n, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_from_config_defaults_to_cuda_and_raises_for_what_is_not_ported(monkeypatch):
    mc = port_config.conditional_64().model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UNet3DCond.from_config(mc)
    tiny = port_config.tiny_test(conditional=True).model
    # every constructor option is ported now (tests/test_torch_unet_options.py
    # holds each against JAX): each builds and runs
    for change in (dict(self_condition=True), dict(time_sin_pos=True),
                   dict(time_learned_emb=False), dict(attn_enabled=False),
                   dict(remat_blocks=True)):
        built = UNet3DCond.from_config(dataclasses.replace(tiny, **change), device="cpu")
        x = torch.zeros(1, 8, 8, 8, 15)
        assert built(x, x, torch.zeros(1)).shape == x.shape
    with pytest.raises(ValueError, match="unconditional"):
        UNet3DCond.from_config(port_config.tiny_test().model, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        UNet3DCond.from_config(dataclasses.replace(tiny, cond_variant="v4"), device="cpu")
    model = UNet3DCond.from_config(tiny, device="cpu")
    x = torch.zeros(1, 8, 8, 8, 15)
    with pytest.raises(ValueError, match="ATb"):
        model(x, x[..., :3], torch.zeros(1))
