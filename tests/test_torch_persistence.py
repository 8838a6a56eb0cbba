"""``params_from_jax``: the JAX UNet3D parameter tree onto the port's ``state_dict``.

Trees come from ``jax.eval_shape`` of the flax ``init`` (tiny preset and the
flagship's full width) and are filled with numpy draws, so every leaf carries
distinct values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_unet import random_params

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_tpu.models import UNet3D


def _tree(mc, side):
    model = UNet3D(
        dim=mc.dim, dim_mults=tuple(mc.dim_mults), data_channels=mc.data_channels,
        dropout=0.0, time_resolution=mc.time_resolution, time_bandwidth=mc.time_bandwidth,
        time_learned_emb=True, attn_dim_head=mc.attn_dim_head, attn_heads=mc.attn_heads,
        full_attn=mc.full_attn,
    )
    x = jnp.zeros((1, side, side, side, mc.data_channels))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, jnp.zeros((1,)))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes
    )


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


FA16 = (False, False, True, False, True)  # full attention at 16³ and at 4³


def _fa16(**overrides):
    cfg = port_config.unconditional_64(**overrides)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, full_attn=FA16))


PRESETS = {
    "tiny": (port_config.tiny_test, 8),
    "flagship_width": (port_config.unconditional_64, 16),
    "fa16_flagship_width": (_fa16, 16),
}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_leaf_round_trips(preset):
    make, side = PRESETS[preset]
    mc = dataclasses.replace(make().model, dtype="float32")
    tree = _tree(mc, side)
    model = UNet.from_config(mc, device="cpu")
    state = params_from_jax(tree, model)
    expected = model.state_dict()
    assert set(state) == set(expected)
    n_leaves = 0
    for path, leaf in _leaves(tree["params"]):
        n_leaves += 1
        name = "weight" if path[-1] == "kernel" else path[-1]
        got = state[".".join(path[:-1] + (name,))].numpy()
        assert got.shape == tuple(expected[".".join(path[:-1] + (name,))].shape)
        if path[-1] == "kernel" and leaf.ndim == 5:
            back = got.transpose(2, 3, 4, 1, 0)   # OIDHW -> DHWIO
        elif path[-1] == "kernel":
            back = got.T                          # [out, in] -> [in, out]
        else:
            back = got
        np.testing.assert_array_equal(back, leaf, err_msg="/".join(path))
    assert n_leaves == len(state)
    model.load_state_dict(state)  # strict


def test_missing_extra_or_misshapen_keys_raise():
    mc = dataclasses.replace(port_config.tiny_test().model, dtype="float32")
    tree = _tree(mc, 8)["params"]
    model = UNet.from_config(mc, device="cpu")

    missing = {k: v for k, v in tree.items() if k != "mid_attn"}
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(missing, model)

    extra = dict(tree, stray={"bias": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="stray.bias"):
        params_from_jax(extra, model)

    misshapen = dict(tree, final_conv={"kernel": np.zeros((3, 3), np.float32),
                                       "bias": tree["final_conv"]["bias"]})
    with pytest.raises(ValueError, match="final_conv.weight"):
        params_from_jax(misshapen, model)

    unknown = dict(tree, final_conv=dict(tree["final_conv"], scale=np.ones(3, np.float32)))
    with pytest.raises(KeyError, match="scale"):
        params_from_jax(unknown)


def test_fa16_tree_has_full_attention_at_stage_2():
    mc = dataclasses.replace(_fa16().model, dtype="float32")
    state = params_from_jax(_tree(mc, 16), UNet.from_config(mc, device="cpu"))
    for name in ("downs_2_attn", "ups_2_attn", "downs_4_attn", "ups_0_attn", "mid_attn"):
        assert f"{name}.to_qkv.weight" in state and f"{name}.out_norm.g" not in state, name
    for name in ("downs_0_attn", "downs_1_attn", "downs_3_attn", "ups_4_attn"):
        assert f"{name}.out_norm.g" in state, name  # linear attention keeps its output norm


def test_tiny_full_attention_forward_matches_jax():
    """Full attention at 12³ (1,728 tokens, head width 8): both sides take the
    flash path, the JAX kernel in interpret mode. f32, within 1e-4 as the tiny
    forward of test_torch_unet."""
    mc = dataclasses.replace(port_config.tiny_test().model, full_attn=(True, True),
                             attn_dim_head=8)
    model = UNet3D(
        dim=mc.dim, dim_mults=tuple(mc.dim_mults), data_channels=mc.data_channels,
        dropout=0.0, time_resolution=mc.time_resolution, time_bandwidth=mc.time_bandwidth,
        time_learned_emb=True, attn_dim_head=mc.attn_dim_head, attn_heads=mc.attn_heads,
        full_attn=mc.full_attn,
    )
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 12, 12, mc.data_channels)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, 2).astype(np.float32)
    variables = random_params(model, jnp.asarray(x), jnp.asarray(t), 11, mc.time_bandwidth)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x), jnp.asarray(t)))
    port = UNet.from_config(mc, device="cpu").eval()
    port.load_state_dict(params_from_jax(variables, port))
    assert port.downs_0_attn.takes_flash(12**3) and not port.mid_attn.takes_flash(6**3)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
