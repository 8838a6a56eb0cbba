"""The port's 2-D family against the flax modules on the same weights (CPU, f32).

``Upsample2D``, ``Downsample2D`` and ``UNet2D`` (dim 8, mults (1, 2), 2 heads
× 8, every ``full_attn`` pattern, 16² and 32²) with seeded numpy weights in
the JAX trees' shapes, carried by ``params_from_jax``. At 32² the first stage
has 1024 tokens, so a full attention there takes the flash path on both sides:
the port's plain flash version, JAX's Pallas kernel in interpret mode. The
tolerance is a relative L2 error of 1e-5 (f32 on both sides, sums in another
order). Also: the rank-4 kernels' round trip through ``params_to_jax``, a
reference-layout 2-D state dict (``tests/torch_lightning_layout.py``) through
both converters, and the models built with only their required arguments
(``UNet``, ``UNet3DCond``, ``UNet2D``): the same parameter names as JAX's and
the same output on carried weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flowtrain_stochastic_interpolation_torch.models import UNet2D, Unet2D
from flowtrain_stochastic_interpolation_torch.models import persistence
from flowtrain_stochastic_interpolation_torch.models.unet import (
    Downsample2D,
    UNet,
    Upsample2D,
)
from flowtrain_stochastic_interpolation_torch.models.unet_cond import UNet3DCond
from flowtrain_stochastic_interpolation_tpu.models import UNet2D as JaxUNet2D
from flowtrain_stochastic_interpolation_tpu.models import UNet3D as JaxUNet3D
from flowtrain_stochastic_interpolation_tpu.models import UNet3DCond as JaxUNet3DCond
from flowtrain_stochastic_interpolation_tpu.models import persistence as jax_persistence
from flowtrain_stochastic_interpolation_tpu.models.unet import Downsample2D as JaxDownsample2D
from flowtrain_stochastic_interpolation_tpu.models.unet import Upsample2D as JaxUpsample2D

from test_torch_unet import random_tree
from torch_lightning_layout import reference_state_dict

REL_L2 = 1e-5
SMALL = dict(dim=8, dim_mults=(1, 2), data_channels=3, attn_heads=2, attn_dim_head=8,
             time_resolution=16, time_bandwidth=10.0)
PATTERNS = [(False, True), (True, True), (False, False), (True, False)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_forward(model, variables, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(model.apply)(variables, *map(jnp.asarray, args)))


def port_forward(model, variables, *args):
    model.load_state_dict(persistence.params_from_jax(variables, model))
    with torch.no_grad():
        return model(*map(torch.from_numpy, args)).numpy()


@pytest.mark.parametrize("module", ["up", "down"])
def test_resamplers_match_jax(module):
    x = normal(0, (2, 8, 6, 5))
    jax_mod = JaxUpsample2D(7) if module == "up" else JaxDownsample2D(7)
    port = (Upsample2D if module == "up" else Downsample2D)(5, 7)
    variables = {"params": random_tree(jax_mod, (jnp.asarray(x),), 1, 1.0)["params"]}
    want = jax_forward(jax_mod, variables, x)
    got = port_forward(port, variables, x)
    assert got.shape == want.shape == ((2, 16, 12, 7) if module == "up" else (2, 4, 3, 7))
    assert rel_l2(got, want) <= REL_L2


@pytest.mark.parametrize("side", [16, 32])
@pytest.mark.parametrize("full_attn", PATTERNS)
def test_unet2d_matches_jax(side, full_attn):
    x, t = normal(2, (2, side, side, 3)), np.array([0.25, 0.7], np.float32)
    jax_model = JaxUNet2D(**SMALL, full_attn=full_attn, time_learned_emb=True)
    variables = random_tree(jax_model, (jnp.asarray(x), jnp.asarray(t)), 3, 10.0)
    want = jax_forward(jax_model, variables, x, t)
    port = UNet2D(**SMALL, full_attn=full_attn, time_learned_emb=True, device="cpu")
    got = port_forward(port, variables, x, t)
    assert got.shape == want.shape == (2, side, side, 3) and got.dtype == np.float32
    assert rel_l2(got, want) <= REL_L2


def test_rank4_kernels_round_trip():
    port = UNet2D(**SMALL, device="cpu")
    port.reset_parameters(torch.Generator().manual_seed(4))
    tree = persistence.variables_to_jax(port)
    assert tree["params"]["init_conv"]["kernel"].shape == (7, 7, 3, 8)  # HWIO
    state = persistence.params_from_jax(tree, port)
    for key, value in port.state_dict().items():
        assert torch.equal(state[key], value), key
    x = jnp.zeros((1, 16, 16, 3))
    want = jax.eval_shape(JaxUNet2D(**SMALL).init, jax.random.PRNGKey(0), x, jnp.zeros((1,)))
    assert jax.tree_util.tree_map(np.shape, tree) == jax.tree_util.tree_map(
        lambda a: a.shape, want)


def test_reference_2d_state_dict_through_both_converters():
    x, t = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,))
    jax_model = JaxUNet2D(**SMALL, time_learned_emb=True)
    params = random_tree(jax_model, (x, t), 5, 10.0)["params"]
    sd, _ = reference_state_dict(params, None, conditional=False, n_stages=2, ndim=2)
    assert sd["net.downs.0.3.1.weight"].shape == (8, 32, 1, 1)
    assert sd["net.ups.0.3.1.weight"].shape == (8, 16, 3, 3)
    sd = {k[len("net."):]: v for k, v in sd.items()}
    ours = persistence.convert_unet3d(sd, n_stages=2, ndim=2)
    theirs = jax_persistence.convert_unet3d(sd, n_stages=2, ndim=2)
    flat = lambda tree: dict(persistence._leaves(tree))
    assert flat(ours).keys() == flat(theirs).keys() == flat(params).keys()
    for path, value in flat(theirs).items():
        np.testing.assert_array_equal(flat(ours)[path], value)
        np.testing.assert_array_equal(flat(params)[path], value)


@pytest.mark.parametrize("name", ["unet", "unet3d_cond", "unet2d"])
def test_required_arguments_only_build_jax_model(name):
    """Only ``dim``: RandomFourier time (JAX's ``time_learned_emb=False``), the
    default widths, heads and stages."""
    if name == "unet2d":
        jax_model, port, shape = JaxUNet2D(dim=8), Unet2D(dim=8), (1, 16, 16, 3)
    elif name == "unet":
        jax_model, port, shape = JaxUNet3D(dim=8), UNet(dim=8), (1, 8, 8, 8, 3)
    else:
        jax_model, port, shape = JaxUNet3DCond(dim=8), UNet3DCond(dim=8), (1, 8, 8, 8, 3)
    x, t = normal(6, shape), np.array([0.4], np.float32)
    args = (x, normal(7, shape), t) if name == "unet3d_cond" else (x, t)
    variables = random_tree(jax_model, tuple(map(jnp.asarray, args)), 8, 100.0)
    assert set(variables) == {"params", "constants"}
    names = lambda tree: sorted("/".join(p) for p, _ in persistence._leaves(tree))
    assert names(persistence.variables_to_jax(port)["params"]) == names(variables["params"])
    assert names(dict(port.named_buffers())) == [
        "time_mlp.embed.freqs", "time_mlp.embed.phases"]
    want = jax_forward(jax_model, variables, *args)
    got = port_forward(port, variables, *args)
    assert rel_l2(got, want) <= REL_L2
