"""The port's X-sharded UNet and UNet3DCond v3 on 4 gloo ranks against the JAX
models under ``shard_map`` (``spatial_axis="spatial"``) and against the port's
unsharded models; and ``make_spatial_sampler`` against ``make_sampler``.

The JAX package's spatial tests' configuration (``dim=8``, ``dim_mults=(1,
2)``, ``[2, 16, 8, 8, 6]``, 4 spatial shards): the weights are seeded numpy
arrays in the JAX tree (``tests/test_torch_unet.py::random_params``), read
by ``params_from_jax``; the ranks (``tests/torch_parallel_cases.py::
unet_forward_backward``, spawned once) load them into their sharded models.
Tolerances: the forward 2e-4 of the largest output, as the JAX spatial test
holds its sharded forward to its plain one; the parameter gradients 2e-4 of
each leaf's largest entry; the sampler's decode equal and its prominence
within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flowtrain_stochastic_interpolation_torch.inference import make_sampler
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_torch.models.unet_cond import UNet3DCond
from flowtrain_stochastic_interpolation_torch.parallel.launch import spawn
from flowtrain_stochastic_interpolation_tpu.models import UNet3D as JaxUNet3D
from flowtrain_stochastic_interpolation_tpu.models.unet_cond import UNet3DCond as JaxUNet3DCond
from flowtrain_stochastic_interpolation_tpu.parallel import create_mesh

import torch_parallel_cases as cases
from test_torch_unet import random_params

CFG = cases.UNET_KW
REL = 2e-4


def inputs():
    rng = np.random.default_rng(11)
    x, atb, cot, x0 = (rng.standard_normal(cases.UNET_X).astype(np.float32) for _ in range(4))
    t = np.asarray([0.3, 0.7], np.float32)
    return x, atb, t, cot, x0


def jax_models(name):
    if name == "unet":
        return JaxUNet3D(**CFG), JaxUNet3D(**CFG, spatial_axis="spatial")
    return (JaxUNet3DCond(**CFG, variant="v3"),
            JaxUNet3DCond(**CFG, variant="v3", spatial_axis="spatial"))


def port_model(name, **kw):
    if name == "unet":
        return UNet(**CFG, device="cpu", **kw)
    return UNet3DCond(**CFG, device="cpu", variant="v3", **kw)


@pytest.fixture(scope="module")
def setup():
    x, atb, t, cot, x0 = inputs()
    variables, weights = {}, {}
    for i, name in enumerate(("unet", "cond")):
        plain, _ = jax_models(name)
        variables[name] = random_params(plain, jnp.asarray(x), jnp.asarray(t), 20 + i,
                                        CFG["time_bandwidth"],
                                        atb=None if name == "unet" else jnp.asarray(atb))
        weights[name] = params_from_jax(variables[name], port_model(name))
    table = torch.eye(cases.UNET_X[-1])
    as_t = torch.from_numpy
    ranks = spawn(cases.unet_forward_backward, cases.SPATIAL,
                  (weights["unet"], weights["cond"], as_t(x), as_t(atb), as_t(t), as_t(cot),
                   table, as_t(x0)), threads=1, deadline_s=300)
    return dict(x=x, atb=atb, t=t, cot=cot, x0=x0, variables=variables, weights=weights,
                table=table, ranks=ranks)


def joined(ranks, key):
    return torch.cat([r[key] for r in ranks], dim=1).numpy()


def close(got, want, rel=REL, err_msg=""):
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0,
                               err_msg=err_msg)


def args_of(name, s, wrap=jnp.asarray):
    return (wrap(s["x"]),) + ((wrap(s["atb"]),) if name == "cond" else ()) + (wrap(s["t"]),)


@pytest.mark.parametrize("name", ["unet", "cond"])
def test_sharded_forward_matches_jax_sharded_and_the_unsharded_port(setup, name):
    _, sharded = jax_models(name)
    mesh = create_mesh(n_data=1, n_spatial=cases.SPATIAL)
    vol = P(None, "spatial")
    in_specs = (P(), vol) + ((vol,) if name == "cond" else ()) + (P(),)
    apply = jax.jit(jax.shard_map(lambda v, *a: sharded.apply(v, *a), mesh=mesh,
                                  in_specs=in_specs, out_specs=vol))
    ref = np.asarray(apply(setup["variables"][name], *args_of(name, setup)))
    model = port_model(name)
    model.load_state_dict(setup["weights"][name])
    with torch.no_grad():
        want = model(*args_of(name, setup, torch.from_numpy)).numpy()
    got = joined(setup["ranks"], name)
    close(got, ref)
    close(got, want)


@pytest.mark.parametrize("name", ["unet", "cond"])
def test_sharded_parameter_gradients_match_the_unsharded_port(setup, name):
    model = port_model(name)
    model.load_state_dict(setup["weights"][name])
    out = model(*args_of(name, setup, torch.from_numpy))
    (out * torch.from_numpy(setup["cot"])).sum().backward()
    for key, p in model.named_parameters():
        got = sum(r[f"{name}_grads"][key] for r in setup["ranks"]).numpy()
        close(got, p.grad.numpy(), err_msg=key)


def test_the_jax_tree_loads_into_the_sharded_model(setup):
    """A JAX ``spatial_axis`` model has the plain tree (``SpatialConv3D`` is
    layout-identical), and the port's sharded model the plain ``state_dict``."""
    sentinel = object()  # a group is only stored at construction
    for name in ("unet", "cond"):
        sharded = port_model(name, spatial_group=sentinel)
        assert sharded.state_dict().keys() == setup["weights"][name].keys()
        sharded.load_state_dict(setup["weights"][name])
        convs = [m for m in sharded.modules() if type(m).__name__ == "SpatialConv3d"]
        assert convs and all(m.spatial_group is sentinel for m in convs)


@pytest.mark.parametrize("name", ["unet", "cond"])
def test_spatial_sampler_matches_make_sampler(setup, name):
    model = port_model(name)
    model.load_state_dict(setup["weights"][name])
    sampler = make_sampler(model, setup["table"], conditional=name == "cond", n_frames=3,
                           substeps=1, with_prominence=True)
    x0 = torch.from_numpy(setup["x0"])
    want = sampler(x0, torch.from_numpy(setup["atb"])) if name == "cond" else sampler(x0)
    got = {k: torch.cat([r[f"{name}_sample"][k] for r in setup["ranks"]], dim=1)
           for k in ("decoded", "prominence")}
    assert torch.equal(got["decoded"], want["decoded"])
    np.testing.assert_allclose(got["prominence"].numpy(), want["prominence"].numpy(), atol=1e-5)


def test_spatial_sampler_needs_a_spatial_mesh():
    from flowtrain_stochastic_interpolation_torch.inference import make_spatial_sampler
    from flowtrain_stochastic_interpolation_torch.parallel.mesh import Mesh

    model = port_model("unet")
    with pytest.raises(ValueError, match="'spatial' axis is required"):
        make_spatial_sampler(model, torch.eye(6), Mesh(1, 1))
    with pytest.raises(ValueError, match="built with the mesh's spatial group"):
        make_spatial_sampler(model, torch.eye(6), Mesh(1, 4, spatial_group=object()))
