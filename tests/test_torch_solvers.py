"""The port's samplers against the JAX package's ``solvers``.

* The fixed-step steppers (euler, heun, midpoint, rk4, rk4_tableau) through
  ``solve_ode`` on the toy fields of ``tests/test_solvers.py``: float32 within
  1e-6 relative, a bf16 state within two bf16 ulps of the state's scale; the
  frame advancer driven on ``frame_grid`` equals the port's ``solve_ode``
  bit for bit and JAX's within 1e-6; ``frozen_mask`` on every solver;
  ``ode_sol_rk4``; ``ODEFlowSolver``; heun, midpoint and rk4_tableau on the
  8³ tiny UNet within 1e-4.
* dopri5 against ``solve_ode_adaptive``: on the linear, cosine and a wavy
  field the same NFE and the trajectories within 1e-6; bit for bit with JAX
  run op by op on the linear field; JAX's ``max_steps`` truncation makes both
  NFEs the same negative number; a bf16 state at atol = rtol = 1e-4 takes
  JAX's NFE; on the tiny UNet the NFE is within one attempt (6 evaluations)
  of JAX's. With a frozen mask the port takes JAX's op-by-op NFE (XLA's
  compiled loop contracts the error estimate's multiply-adds and takes two
  attempts fewer there); its trajectory is within 1e-5 of either.
* The one-sided denoiser: the velocity <-> denoiser maps, both eps schedules,
  the denoising ODE (fixed and adaptive), and the two SDEs fed JAX's own
  draws (the same ``jax.random.split`` chain as JAX's solver): float32 within
  1e-5 relative and 1e-6 absolute, a bf16 state within two bf16 ulps of the
  state's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import random_params

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch import solvers as S
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_tpu import solvers as J
from flowtrain_stochastic_interpolation_tpu.interpolants import (
    LinearInterpolant as JaxLinearInterpolant,
)
from flowtrain_stochastic_interpolation_tpu.models import UNet3D

FIXED = ["euler", "heun", "midpoint", "rk4", "rk4_tableau"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several workers
    at once, and a full thread pool in each oversubscribes the cores (small
    operations then wait on spinning threads, a hundredfold slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the toy fields, on both sides
def linear_t(x, t):
    return -x


def linear_j(x, t):
    return -x


def cosine_t(x, t):
    tb = t.reshape(t.shape[0], *([1] * (x.ndim - 1)))
    return torch.cos(2 * np.pi * tb) * torch.ones_like(x)


def cosine_j(x, t):
    tb = t.reshape(t.shape[0], *([1] * (x.ndim - 1)))
    return jnp.cos(2 * jnp.pi * tb) * jnp.ones_like(x)


def wavy_t(x, t):
    tb = t.reshape(t.shape[0], *([1] * (x.ndim - 1)))
    return -x * (1.0 + 0.5 * torch.sin(3.0 * tb)) + torch.sin(x)


def wavy_j(x, t):
    tb = t.reshape(t.shape[0], *([1] * (x.ndim - 1)))
    return -x * (1.0 + 0.5 * jnp.sin(3.0 * tb)) + jnp.sin(x)


FIELDS = {"linear": (linear_t, linear_j), "cosine": (cosine_t, cosine_j),
          "wavy": (wavy_t, wavy_j)}


def _x0(shape=(2, 3, 5), seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, rtol=1e-6, atol=1e-6):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Fixed-step solvers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("method", FIXED)
def test_fixed_steppers_match_jax(method, field):
    ft, fj = FIELDS[field]
    x0 = _x0()
    kw = dict(t0=0.001, tf=1.0, n_frames=5, substeps=3, method=method)
    got = S.solve_ode(ft, torch.from_numpy(x0), **kw)
    want = J.solve_ode(fj, jnp.asarray(x0), **kw)
    assert got.shape == want.shape == (5, 2, 3, 5)
    _close(got, want)
    final = S.solve_ode_final(ft, torch.from_numpy(x0), **kw)
    assert torch.equal(final, got[-1])
    assert S.stages(method) == {"euler": 1, "heun": 2, "midpoint": 2}.get(method, 4)


@pytest.mark.parametrize("method", ["heun", "midpoint", "rk4_tableau"])
def test_tableau_steppers_keep_a_bf16_state(method):
    x0 = _x0()
    kw = dict(t0=0.001, tf=1.0, n_frames=4, substeps=2, method=method)
    got = S.solve_ode(wavy_t, torch.from_numpy(x0).bfloat16(), **kw)
    want = J.solve_ode(wavy_j, jnp.asarray(x0, jnp.bfloat16), **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # two bf16 ulps (2^-7 each) of the state's scale
    _close(got, np.asarray(want, np.float32), rtol=0, atol=2 * 2 ** -7 * np.abs(x0).max())


@pytest.mark.parametrize("method", FIXED)
def test_frame_advancer_on_the_frame_grid(method):
    x0 = torch.from_numpy(_x0(seed=1))
    frame_ts, h = S.frame_grid(x0.dtype, 0.001, 1.0, 6, 2)
    jts, jh = J.frame_grid(jnp.float32, 0.001, 1.0, 6, 2)
    # correctly rounded here; jnp.linspace's float32 arithmetic (which XLA
    # reassociates differently eager and under jit) may be an ulp away
    np.testing.assert_allclose(frame_ts, jts, rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(np.float32(h), jh, rtol=5e-7, atol=0)
    advance = S.make_frame_advancer(wavy_t, substeps=2, method=method)
    x, frames = x0, [x0]
    for t_start in frame_ts[:-1]:
        x = advance(x, float(t_start), h)
        frames.append(x)
    plain = S.solve_ode(wavy_t, x0, t0=0.001, tf=1.0, n_frames=6, substeps=2, method=method)
    assert torch.equal(torch.stack(frames), plain)
    jadv = J.make_frame_advancer(wavy_j, substeps=2, method=method)
    jx = jnp.asarray(x0.numpy())
    for i, t_start in enumerate(jts[:-1]):
        jx = jadv(jx, jnp.asarray(t_start), jnp.asarray(jh))
        _close(frames[i + 1], jx)


def test_frozen_mask_on_every_solver():
    x0 = np.ones((1, 4), np.float32)
    mask = np.array([[True, False, True, False]])
    tx, tm, jx, jm = torch.from_numpy(x0), torch.from_numpy(mask), jnp.asarray(x0), jnp.asarray(mask)
    for method in FIXED:
        kw = dict(n_frames=5, substeps=4, method=method)
        got = S.solve_ode(linear_t, tx, frozen_mask=tm, **kw)
        _close(got, J.solve_ode(linear_j, jx, frozen_mask=jm, **kw))
        assert torch.equal(got[-1, 0, [0, 2]], torch.ones(2))
        assert torch.equal(S.solve_ode_final(linear_t, tx, frozen_mask=tm, **kw), got[-1])
        adv = S.make_frame_advancer(linear_t, substeps=2, method=method, frozen_mask=tm)
        assert torch.equal(adv(tx, 0.0, 0.1)[0, [0, 2]], torch.ones(2))
    # dopri5 with JAX run op by op: XLA's compiled loop contracts the error
    # estimate's multiply-adds (31 evaluations here against 43 op by op)
    traj, nfe = S.solve_ode_adaptive(linear_t, tx, n_frames=5, frozen_mask=tm)
    with jax.disable_jit():
        jtraj, jnfe = J.solve_ode_adaptive(linear_j, jx, n_frames=5, frozen_mask=jm)
    assert nfe == int(jnfe) > 0
    _close(traj, jtraj)
    assert torch.equal(traj[-1, 0, [0, 2]], torch.ones(2))
    np.testing.assert_allclose(traj[-1, 0, [1, 3]].numpy(), np.exp(-1.0), rtol=1e-5)
    ctraj, _ = J.solve_ode_adaptive(linear_j, jx, n_frames=5, frozen_mask=jm)
    _close(traj, ctraj, rtol=1e-5, atol=1e-6)


def test_ode_sol_rk4_and_the_solver_wrapper_match_jax():
    x0 = _x0(seed=2)
    got = S.ode_sol_rk4(torch.from_numpy(x0), wavy_t, nsteps=40, tf=1.0)
    want = J.ode_sol_rk4(jnp.asarray(x0), wavy_j, nsteps=40, tf=1.0)
    assert got.shape == want.shape == (40, 2, 3, 5)
    _close(got, want)
    for adaptive in (False, True):
        mine = S.ODEFlowSolver(wavy_t, adaptive=adaptive, method="heun", substeps=3)
        theirs = J.ODEFlowSolver(wavy_j, adaptive=adaptive, method="heun", substeps=3)
        _close(mine.solve(torch.from_numpy(x0), t0=0.0, tf=1.0, n_steps=8),
               theirs.solve(jnp.asarray(x0), t0=0.0, tf=1.0, n_steps=8))
    with pytest.raises(ValueError, match="unknown method"):
        S.solve_ode(linear_t, torch.zeros(1, 2), method="rk5")


# ---------------------------------------------------------------------------
# The tiny UNet
# ---------------------------------------------------------------------------
SHAPE, E = (8, 8, 8), 15


@pytest.fixture(scope="module")
def tiny_unet():
    mc = port_config.tiny_test().model
    jmodel = UNet3D(dim=mc.dim, dim_mults=mc.dim_mults, data_channels=E, dropout=0.0,
                    time_resolution=mc.time_resolution, time_bandwidth=mc.time_bandwidth,
                    time_learned_emb=True, attn_dim_head=mc.attn_dim_head,
                    attn_heads=mc.attn_heads, dtype=None)
    variables = random_params(jmodel, jnp.zeros((1, *SHAPE, E)), jnp.zeros((1,)), 5,
                              mc.time_bandwidth)
    port = UNet.from_config(mc, device="cpu").eval()
    port.load_state_dict(params_from_jax(variables, port))
    x0 = np.random.default_rng(6).standard_normal((2, *SHAPE, E)).astype(np.float32)
    return port, lambda x, t: jmodel.apply(variables, x, t), x0


@pytest.mark.parametrize("method", ["heun", "midpoint", "rk4_tableau"])
def test_tableau_steppers_on_the_tiny_unet(tiny_unet, method):
    port, japply, x0 = tiny_unet
    kw = dict(t0=0.001, tf=1.0, n_frames=3, substeps=1, method=method)
    with torch.inference_mode():
        got = S.solve_ode_final(port, torch.from_numpy(x0), **kw)
    want = jax.jit(lambda x: J.solve_ode_final(japply, x, **kw))(jnp.asarray(x0))
    _close(got, want, rtol=0, atol=1e-4)


def test_dopri5_on_the_tiny_unet_within_one_attempt(tiny_unet):
    port, japply, x0 = tiny_unet
    kw = dict(t0=0.001, tf=1.0, n_frames=3, atol=1e-4, rtol=1e-4)
    with torch.inference_mode():
        traj, nfe = S.solve_ode_adaptive(port, torch.from_numpy(x0), **kw)
    jtraj, jnfe = jax.jit(lambda x: J.solve_ode_adaptive(japply, x, **kw))(jnp.asarray(x0))
    assert nfe > 0 and int(jnfe) > 0
    assert abs(nfe - int(jnfe)) <= 6, (nfe, int(jnfe))
    _close(traj[-1], jtraj[-1], rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# dopri5
# ---------------------------------------------------------------------------
DOPRI_CASES = {
    "linear-1e-6": ("linear", dict(t0=0.0, tf=1.0, n_frames=16, atol=1e-6, rtol=1e-6)),
    "linear-1e-3": ("linear", dict(t0=0.0, tf=1.0, n_frames=4, atol=1e-3, rtol=1e-3)),
    "cosine-1e-6": ("cosine", dict(t0=0.0, tf=0.75, n_frames=4, atol=1e-6, rtol=1e-6)),
    "cosine-1e-5": ("cosine", dict(t0=0.001, tf=1.0, n_frames=8, atol=1e-5, rtol=1e-5)),
    "wavy-1e-5": ("wavy", dict(t0=0.001, tf=1.0, n_frames=5, atol=1e-5, rtol=1e-5)),
}


@pytest.mark.parametrize("case", list(DOPRI_CASES))
def test_dopri5_matches_jax_with_the_same_nfe(case):
    field, kw = DOPRI_CASES[case]
    ft, fj = FIELDS[field]
    x0 = _x0(seed=3)
    traj, nfe = S.solve_ode_adaptive(ft, torch.from_numpy(x0), **kw)
    jtraj, jnfe = J.solve_ode_adaptive(fj, jnp.asarray(x0), **kw)
    assert nfe == int(jnfe) > 1 and (nfe - 1) % 6 == 0
    assert traj.shape == jtraj.shape == (kw["n_frames"], 2, 3, 5)
    _close(traj, jtraj)


def test_dopri5_is_jax_op_by_op_bit_for_bit_on_the_linear_field():
    """The controller's float32 arithmetic and the state's sums are JAX's, op
    for op: with JAX run op by op the trajectories are equal."""
    x0 = _x0(seed=3)
    kw = DOPRI_CASES["linear-1e-6"][1]
    traj, nfe = S.solve_ode_adaptive(linear_t, torch.from_numpy(x0), **kw)
    with jax.disable_jit():
        jtraj, jnfe = J.solve_ode_adaptive(linear_j, jnp.asarray(x0), **kw)
    assert nfe == int(jnfe)
    np.testing.assert_array_equal(traj.numpy(), np.asarray(jtraj))


@pytest.mark.parametrize("max_steps", [1, 3])
def test_dopri5_truncation_makes_both_nfes_negative(max_steps):
    x0 = _x0(seed=4)
    kw = dict(t0=0.0, tf=1.0, n_frames=3, atol=1e-6, rtol=1e-6, max_steps=max_steps)
    traj, nfe = S.solve_ode_adaptive(linear_t, torch.from_numpy(x0), **kw)
    _, jnfe = J.solve_ode_adaptive(linear_j, jnp.asarray(x0), **kw)
    assert nfe == int(jnfe) < 0 and (-nfe - 1) % 6 == 0
    # where a segment stops short its state depends on which attempts passed:
    # the trajectory is JAX's op by op (the compiled error estimate differs)
    with jax.disable_jit():
        jtraj, jnfe = J.solve_ode_adaptive(linear_j, jnp.asarray(x0), **kw)
    assert nfe == int(jnfe)
    _close(traj, jtraj)


def test_dopri5_bf16_state_takes_jax_nfe():
    x0 = np.ones((1, 8), np.float32)
    kw = dict(t0=0.0, tf=1.0, n_frames=16, atol=1e-4, rtol=1e-4)
    traj, nfe = S.solve_ode_adaptive(linear_t, torch.from_numpy(x0).bfloat16(), **kw)
    jtraj, jnfe = J.solve_ode_adaptive(linear_j, jnp.asarray(x0, jnp.bfloat16), **kw)
    assert traj.dtype == torch.bfloat16
    assert nfe == int(jnfe) > 0
    _close(traj, np.asarray(jtraj, np.float32), rtol=0, atol=2 ** -7)
    np.testing.assert_allclose(traj[:, 0, 0].float().numpy(), np.exp(-np.linspace(0, 1, 16)),
                               rtol=2e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# The one-sided denoiser and the SDEs
# ---------------------------------------------------------------------------
MU = 2.0


def delta_denoiser_t(x, t):
    """The perfect denoiser of a delta target at MU."""
    it = LinearInterpolant(one_sided=True)
    tb = t.reshape(t.shape[0], *([1] * (x.ndim - 1)))
    return (x - it.beta(tb) * MU) / it.alpha(tb)


def delta_denoiser_j(x, t):
    it = JaxLinearInterpolant(one_sided=True)
    tb = t.reshape(t.shape[0], *([1] * (x.ndim - 1)))
    return (x - it.beta(tb) * MU) / it.alpha(tb)


def sin_denoiser_t(x, t):
    return torch.sin(x) * (1.0 + t.reshape(t.shape[0], *([1] * (x.ndim - 1))))


def sin_denoiser_j(x, t):
    return jnp.sin(x) * (1.0 + t.reshape(t.shape[0], *([1] * (x.ndim - 1))))


def test_velocity_denoiser_maps_match_jax_and_invert():
    it, jt = LinearInterpolant(one_sided=True), JaxLinearInterpolant(one_sided=True)
    vel = S.denoiser_to_velocity(sin_denoiser_t, it)
    jvel = J.denoiser_to_velocity(sin_denoiser_j, jt)
    back, jback = S.velocity_to_denoiser(vel, it), J.velocity_to_denoiser(jvel, jt)
    x = _x0((4, 7), seed=5)
    for tval in (1e-3, 0.3, 0.77, 1 - 1e-3):
        t = np.full((4,), tval, np.float32)
        tt, xt, tj, xj = torch.from_numpy(t), torch.from_numpy(x), jnp.asarray(t), jnp.asarray(x)
        _close(vel(xt, tt), jvel(xj, tj), rtol=1e-5, atol=1e-5)
        _close(back(xt, tt), jback(xj, tj), rtol=1e-5, atol=1e-5)
        _close(back(xt, tt), sin_denoiser_t(xt, tt), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="one-sided"):
        S.denoiser_to_velocity(sin_denoiser_t, LinearInterpolant())


@pytest.mark.parametrize("name", ["constant", "linear_decay"])
def test_eps_schedules_match_jax(name):
    mine, theirs = S.eps_schedule(name, 0.7), J.eps_schedule(name, 0.7)
    for t in np.linspace(0.001, 0.999, 11, dtype=np.float32):
        assert np.float32(mine(float(t))) == np.float32(theirs(jnp.float32(t)))
    with pytest.raises(ValueError, match="unknown eps schedule"):
        S.eps_schedule("cosine", 0.5)


@pytest.mark.parametrize("adaptive", [False, True])
def test_denoising_ode_matches_jax(adaptive):
    it, jt = LinearInterpolant(one_sided=True), JaxLinearInterpolant(one_sided=True)
    x0 = np.array([[1.0, -2.0, 0.5]], np.float32)
    kw = dict(t0=1e-3, tf=1 - 1e-3, n_frames=8, substeps=4, method="rk4", adaptive=adaptive,
              atol=1e-6, rtol=1e-6)
    got = S.solve_denoising_ode(delta_denoiser_t, it, torch.from_numpy(x0), **kw)
    want = J.solve_denoising_ode(delta_denoiser_j, jt, jnp.asarray(x0), **kw)
    if adaptive:
        (got, nfe), (want, jnfe) = got, want
        assert nfe == int(jnfe) > 0
    _close(got, want, rtol=1e-5, atol=1e-5)
    x0_lat = (x0 - 1e-3 * MU) / (1 - 1e-3)
    np.testing.assert_allclose(got[-1].numpy(), 1e-3 * x0_lat + (1 - 1e-3) * MU, atol=5e-4)


def jax_draws(key, n_steps, shape, dtype):
    """The draws of JAX's SDE samplers: substep j takes normal(sub_j) where
    ``k_{j+1}, sub_j = split(k_j)`` from ``k_0 = key``."""
    out, k = [], key
    for _ in range(n_steps):
        k, sub = jax.random.split(k)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, dtype), np.float32)))
    return out


SDE_KW = dict(t0=1e-3, tf=1 - 1e-3, n_frames=6, substeps=3)


@pytest.mark.parametrize("schedule", ["constant", "linear_decay"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_velocity_sde_on_jax_noise(schedule, dtype):
    """The velocity is a toy field, as a velocity model would be. A constant
    eps makes the score term stiff near t = 1 (its 1 / alpha), so that schedule
    stops at t = 0.9."""
    it, jt = LinearInterpolant(one_sided=True), JaxLinearInterpolant(one_sided=True)
    x0 = _x0((3, 4, 5), seed=7)
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    kw = dict(SDE_KW, tf=0.9) if schedule == "constant" else SDE_KW
    key = jax.random.PRNGKey(11)
    draws = jax_draws(key, 5 * 3, x0.shape, jdtype)
    noise = lambda i, shape, dt: draws[i].to(dt)
    got = S.solve_velocity_sde(wavy_t, it, torch.from_numpy(x0).to(tdtype), noise=noise,
                               epsilon=S.eps_schedule(schedule, 0.5), **kw)
    want = J.solve_velocity_sde(wavy_j, jt, jnp.asarray(x0, jdtype), key,
                                epsilon=J.eps_schedule(schedule, 0.5), **kw)
    assert got.dtype == tdtype and got.shape == want.shape == (6, 3, 4, 5)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        _close(got, want, rtol=1e-5, atol=1e-6)
    else:  # two bf16 ulps (2^-7 each) of the state's scale
        _close(got, want, rtol=0, atol=2 * 2 ** -7 * np.abs(want).max())
    final = S.solve_velocity_sde(wavy_t, it, torch.from_numpy(x0).to(tdtype), noise=noise,
                                 epsilon=S.eps_schedule(schedule, 0.5), keep_trajectory=False,
                                 **kw)
    assert torch.equal(final, got[-1])


def test_denoising_sde_on_jax_noise():
    it, jt = LinearInterpolant(one_sided=True), JaxLinearInterpolant(one_sided=True)
    x0 = _x0((64, 1), seed=8)
    key = jax.random.PRNGKey(1)
    kw = dict(t0=1e-3, tf=1 - 1e-3, n_frames=16, substeps=4)
    draws = jax_draws(key, 15 * 4, x0.shape, jnp.float32)
    got = S.solve_denoising_sde(delta_denoiser_t, it, torch.from_numpy(x0),
                                noise=lambda i, shape, dt: draws[i],
                                epsilon=lambda t: 0.5 * (1 - t), **kw)
    want = J.solve_denoising_sde(delta_denoiser_j, jt, jnp.asarray(x0), key,
                                 epsilon=lambda t: 0.5 * (1 - t), **kw)
    _close(got, want, rtol=1e-5, atol=1e-5)
    assert abs(float(got[-1].mean()) - MU) < 0.2 and float(got[-1].std()) < 0.3


def test_sdes_draw_from_a_generator_and_raise_without_one():
    it = LinearInterpolant(one_sided=True)
    x0 = torch.from_numpy(_x0((2, 3), seed=9))
    runs = [S.solve_velocity_sde(linear_t, it, x0, torch.Generator().manual_seed(s),
                                 epsilon=0.5, **SDE_KW) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    # with epsilon = 0 the velocity SDE is the Euler ODE on the same grid
    euler = S.solve_ode(linear_t, x0, method="euler", **SDE_KW)
    quiet = S.solve_velocity_sde(linear_t, it, x0, torch.Generator(), epsilon=0.0, **SDE_KW)
    _close(quiet, euler)
    for fn in (S.solve_velocity_sde, S.solve_denoising_sde):
        with pytest.raises(ValueError, match="torch.Generator"):
            fn(linear_t, it, x0, epsilon=0.5, **SDE_KW)
