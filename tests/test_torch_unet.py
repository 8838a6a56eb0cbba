"""The port's UNet3D forward against the flax UNet3D on the same weights (CPU, f32).

Weights are drawn with numpy from a seed in the shapes of the JAX model's
parameter tree (non-zero biases, gains away from 1) and reach the port through
``params_from_jax``; inputs are drawn the same way and handed to both.
Convolutions and matmuls run in full f32 on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.models import UNet3D

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _jax_unet(mc):
    return UNet3D(
        dim=mc.dim, dim_mults=tuple(mc.dim_mults), data_channels=mc.data_channels,
        dropout=0.0, time_resolution=mc.time_resolution,
        time_bandwidth=mc.time_bandwidth, time_learned_emb=mc.time_learned_emb,
        attn_dim_head=mc.attn_dim_head, attn_heads=mc.attn_heads, dtype=None,
    )


def random_params(model, x, t, seed, bandwidth, atb=None):
    """Seeded numpy parameters in the shapes of ``model.init``'s tree (a
    conditional model's ``init(x, atb, t)`` where ``atb`` is given)."""
    return random_tree(model, (x, t) if atb is None else (x, atb, t), seed, bandwidth)


def random_tree(model, args, seed, bandwidth):
    """Seeded numpy parameters in the shapes of ``model.init(key, *args)``'s tree."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.standard_normal(leaf.shape) / np.sqrt(fan_in)
        if name == "bias":
            return 0.1 * rng.standard_normal(leaf.shape)
        if name == "g":
            return 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        if name == "freqs":
            return bandwidth * rng.standard_normal(leaf.shape)
        if name == "phases":
            return rng.uniform(0.0, 1.0, leaf.shape)
        return rng.standard_normal(leaf.shape)  # mem_kv

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _forward_pair(jax_cfg, port_cfg, shape, seed):
    mc = jax_cfg.model
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((shape[0], *shape[1:], mc.data_channels)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, (shape[0],)).astype(np.float32)
    model = _jax_unet(mc)
    variables = random_params(model, jnp.asarray(x), jnp.asarray(t), seed, mc.time_bandwidth)
    ref = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x), jnp.asarray(t)))

    port = UNet.from_config(dataclasses.replace(port_cfg.model, dtype="float32"), device="cpu")
    port.load_state_dict(params_from_jax(variables, port))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    return out, ref


def test_tiny_unet_matches_jax():
    out, ref = _forward_pair(jax_config.tiny_test(), port_config.tiny_test(), (2, 8, 8, 8), 0)
    assert out.shape == ref.shape == (2, 8, 8, 8, 15)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_flagship_width_unet_matches_jax_at_16_cubed():
    """dim 48, mults (1,1,2,3,4), 4 heads x 32: every flagship layer shape that
    fits the CPU, at 16³ x b1 (downs_0 sees 4096 tokens)."""
    out, ref = _forward_pair(
        jax_config.unconditional_64(), port_config.unconditional_64(), (1, 16, 16, 16), 1
    )
    assert out.shape == ref.shape == (1, 16, 16, 16, 18)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-3)
