"""The port's ``make_sampler`` modes: ``method="sde"``, ``adaptive`` and
``frame_dispatch``, and the batch runners' ``sampler=`` and SDE seeding.

At ``tiny_test()`` (8³, f32) and ``tiny_test(conditional=True)``:

* ``sde`` raises without a generator and with the options JAX refuses; the
  same seed gives the same decode, another seed another; it differs from the
  ODE's decode; batch b's noise comes from ``fold_seed(seed, b, 7919)``
  (unconditional) or ``fold_seed(seed + b, 7919)`` (conditional);
* ``adaptive`` against JAX's ``make_sampler(adaptive=True)`` on the same
  weights (``params_from_jax``) and x0: the NFE within one attempt (6
  evaluations), the final states within 1e-3 and the decoded maps on at least
  99.9% of voxels;
* ``frame_dispatch`` decodes bit for bit as the plain sampler, trajectory,
  prominence and all, unconditional and conditional;
* ``sample_conditional`` with a prebuilt ``sampler=`` gives what it gives
  without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import random_params

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.inference import (
    initial_noise,
    make_sampler,
    sample_conditional,
    sample_unconditional,
)
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_torch.train.loop import init_model_variables
from flowtrain_stochastic_interpolation_torch.utils.rng import generator
from flowtrain_stochastic_interpolation_tpu import inference as jax_inference
from flowtrain_stochastic_interpolation_tpu.models import UNet3D

SHAPE, E = (8, 8, 8), 15
CPU = torch.device("cpu")
TABLE = torch.from_numpy(simplex_embedding(E, E))
SDE = dict(t0=1e-3, tf=1 - 1e-3, n_frames=4, substeps=2, method="sde", sde_epsilon=0.5,
           sde_eps_schedule="linear_decay")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several workers
    at once, and a full thread pool in each oversubscribes the cores (small
    operations then wait on spinning threads, a hundredfold slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return init_model_variables(port_config.tiny_test(), seed=3, device=CPU).eval()


@pytest.fixture(scope="module")
def cond_model():
    return init_model_variables(port_config.tiny_test(conditional=True), seed=4,
                                device=CPU).eval()


def _x0(seed, batch=2):
    return initial_noise(torch.Generator().manual_seed(seed), batch, SHAPE, E, torch.float32, CPU)


def _uncond(model, **kw):
    return sample_unconditional(model, TABLE, n_samples=3, batch_size=2, data_shape=SHAPE,
                                embedding_dim=E, device="cpu", verbose=False, **kw)


def test_sde_sampler_is_seeded_and_differs_from_the_ode(model):
    r1, r2 = _uncond(model, seed=7, **SDE), _uncond(model, seed=7, **SDE)
    assert r1.decoded.shape == (3, *SHAPE) and r1.nfe == 3 * 2
    assert 0 <= r1.decoded.min() and r1.decoded.max() < E
    np.testing.assert_array_equal(r1.decoded, r2.decoded)
    assert (r1.decoded != _uncond(model, seed=8, **SDE).decoded).any()
    ode = _uncond(model, seed=7, **{**SDE, "method": "euler"})
    assert (r1.decoded != ode.decoded).mean() > 0.0
    # batch b's noise: fold_seed(seed, b, 7919); its x0 the seed's one stream
    gen = torch.Generator().manual_seed(7)
    sampler = make_sampler(model, TABLE, **SDE)
    first = initial_noise(gen, 2, SHAPE, E, torch.float32, CPU)
    second = initial_noise(gen, 1, SHAPE, E, torch.float32, CPU)
    by_hand = [sampler(first, generator=generator(CPU, 7, 0, 7919))["decoded"],
               sampler(second, generator=generator(CPU, 7, 1, 7919))["decoded"]]
    np.testing.assert_array_equal(r1.decoded, torch.cat(by_hand).numpy())


def test_sde_sampler_raises_without_a_generator_and_with_what_jax_refuses(model):
    sampler = make_sampler(model, TABLE, **SDE)
    with pytest.raises(ValueError, match="torch.Generator"):
        sampler(_x0(0))
    for option in ("adaptive", "frame_dispatch", "variables_as_arg"):
        with pytest.raises(ValueError, match="incompatible"):
            make_sampler(model, TABLE, **SDE, **{option: True})
    for option in ("adaptive", "variables_as_arg"):
        with pytest.raises(ValueError, match="frame_dispatch is incompatible"):
            make_sampler(model, TABLE, frame_dispatch=True, **{option: True})
    with pytest.raises(ValueError, match="variables_as_arg is not ported"):
        make_sampler(model, TABLE, variables_as_arg=True)
    x0 = _x0(1)
    kept = x0.clone()
    out = make_sampler(model, TABLE, n_frames=3, substeps=1, donate_x0=True)(x0)
    assert torch.equal(x0, kept) and out["nfe"] == 2 * 4  # donate_x0 does nothing


def test_adaptive_sampler_matches_jax():
    mc = port_config.tiny_test().model
    jmodel = UNet3D(dim=mc.dim, dim_mults=mc.dim_mults, data_channels=E, dropout=0.0,
                    time_resolution=mc.time_resolution, time_bandwidth=mc.time_bandwidth,
                    time_learned_emb=True, attn_dim_head=mc.attn_dim_head,
                    attn_heads=mc.attn_heads, dtype=None)
    variables = random_params(jmodel, jnp.zeros((1, *SHAPE, E)), jnp.zeros((1,)), 8,
                              mc.time_bandwidth)
    port = UNet.from_config(mc, device="cpu").eval()
    port.load_state_dict(params_from_jax(variables, port))
    kw = dict(t0=1e-3, tf=1.0, n_frames=3, adaptive=True, atol=1e-5, rtol=1e-5,
              keep_trajectory=True)
    x0 = _x0(9)
    out = make_sampler(port, TABLE, **kw)(x0)
    ref = jax_inference.make_sampler(jmodel, variables, jnp.asarray(TABLE.numpy()), **kw)(
        jnp.asarray(x0.numpy()))
    assert out["nfe"] > 0 and int(ref["nfe"]) > 0
    assert abs(out["nfe"] - int(ref["nfe"])) <= 6, (out["nfe"], int(ref["nfe"]))
    assert out["trajectory"].shape == (3, 2, *SHAPE, E)
    np.testing.assert_allclose(out["trajectory"][-1].numpy(), np.asarray(ref["trajectory"][-1]),
                               rtol=0, atol=1e-3)
    assert np.mean(out["decoded"].numpy() == np.asarray(ref["decoded"])) >= 0.999


def test_adaptive_through_sample_unconditional_reports_the_signed_nfe(model):
    result = _uncond(model, seed=2, t0=1e-3, tf=1.0, n_frames=3, adaptive=True, atol=1e-4,
                     rtol=1e-4)
    assert result.nfe > 0 and (result.nfe - 1) % 6 == 0
    assert result.decoded.shape == (3, *SHAPE) and len(result.seconds_per_batch) == 2


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_frame_dispatch_is_the_plain_sampler_bit_for_bit(model, method):
    kw = dict(n_frames=4, substeps=2, method=method, keep_trajectory=True, with_prominence=True)
    x0 = _x0(5)
    plain = make_sampler(model, TABLE, **kw)(x0)
    framed = make_sampler(model, TABLE, frame_dispatch=True, **kw)(x0)
    assert framed["nfe"] == plain["nfe"] == 3 * 2 * {"euler": 1, "heun": 2, "rk4": 4}[method]
    assert framed["trajectory"].device == CPU
    for key in ("decoded", "prominence", "trajectory"):
        assert torch.equal(framed[key], plain[key]), key
    lean = make_sampler(model, TABLE, frame_dispatch=True, n_frames=4, substeps=2,
                        method=method)(x0)
    assert "trajectory" not in lean and torch.equal(lean["decoded"], plain["decoded"])


def test_frame_dispatch_conditional(cond_model):
    x0, atb = _x0(6), _x0(7)
    kw = dict(n_frames=3, substeps=1, method="heun", conditional=True)
    plain = make_sampler(cond_model, TABLE, **kw)(x0, atb)
    framed = make_sampler(cond_model, TABLE, frame_dispatch=True, **kw)(x0, atb)
    assert torch.equal(framed["decoded"], plain["decoded"])


@pytest.mark.parametrize("method", ["euler", "sde"])
def test_sample_conditional_with_a_prebuilt_sampler(cond_model, method):
    atb = _x0(8, batch=1)[0]
    kw = dict(t0=1e-3, tf=1 - 1e-3, n_frames=3, substeps=2, method=method)
    common = dict(n_samples=3, batch_size=2, seed=42, device="cpu", verbose=False)
    fresh = sample_conditional(cond_model, TABLE, atb, **common, **kw)
    sampler = make_sampler(cond_model, TABLE, conditional=True, **kw)
    prebuilt = sample_conditional(cond_model, TABLE, atb, sampler=sampler, method=method,
                                  **common)
    np.testing.assert_array_equal(prebuilt.decoded, fresh.decoded)
    assert prebuilt.nfe == fresh.nfe == 2 * 2
    if method == "sde":
        x0 = initial_noise(torch.Generator().manual_seed(43), 1, SHAPE, E, torch.float32, CPU)
        last = sampler(x0, atb[None], generator=generator(CPU, 43, 7919))
        np.testing.assert_array_equal(fresh.decoded[2:], last["decoded"].numpy())
        with pytest.raises(ValueError, match="torch.Generator"):
            sample_conditional(cond_model, TABLE, atb, sampler=sampler, **common)

