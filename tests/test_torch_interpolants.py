"""The port's interpolants against the JAX package's.

Every interpolant, two-sided and one-sided, on one t grid: alpha, beta, gamma
and their derivatives within 1e-6 (both sides compute in float32); the
``StochasticInterpolator`` methods on the same numpy-drawn x0, x1, z and a
per-sample t within 1e-6 (the score, a division by gamma or alpha, within
1e-5 relative); the golden values of ``tests/test_interpolants.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch import interpolants as port
from flowtrain_stochastic_interpolation_tpu import interpolants as ref

CASES = [
    ("LinearInterpolant", {}),
    ("LinearInterpolant", {"one_sided": True}),
    ("LinearInterpolant", {"gamma_a": 0.5}),
    ("TrigInterpolant", {}),
    ("TrigInterpolant", {"one_sided": True}),
    ("EncDecInterpolant", {}),
    ("SBDMInterpolant", {}),
    ("MirrorInterpolant", {}),
]
IDS = [f"{name}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'}" for name, kw in CASES]
TS = np.linspace(0.02, 0.98, 49, dtype=np.float32)
FIELDS = ("alpha", "beta", "gamma", "alpha_dot", "beta_dot", "gamma_dot")


def _pair(name, kw):
    return getattr(port, name)(**kw), getattr(ref, name)(**kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_schedule_and_derivatives_match_jax(name, kw):
    mine, theirs = _pair(name, kw)
    assert mine.one_sided == theirs.one_sided
    for field in FIELDS:
        got = getattr(mine, field)(torch.from_numpy(TS))
        want = getattr(theirs, field)(jnp.asarray(TS))
        assert got.dtype == torch.float32, field
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6,
                                   err_msg=field)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_stochastic_interpolator_methods_match_jax(name, kw):
    mine, theirs = _pair(name, kw)
    si, sj = port.StochasticInterpolator(mine), ref.StochasticInterpolator(theirs)
    assert repr(si) == repr(sj)
    rng = np.random.default_rng(3)
    x0, x1, z = (rng.standard_normal((4, 3, 5)).astype(np.float32) for _ in range(3))
    t = np.array([0.1, 0.35, 0.6, 0.9], np.float32)
    tt, xt0, xt1, zt = (torch.from_numpy(a) for a in (t, x0, x1, z))
    tj, xj0, xj1, zj = (jnp.asarray(a) for a in (t, x0, x1, z))
    z_args = ((), ()) if mine.one_sided else ((zt,), (zj,))

    pairs = {
        "get_XT": (si.get_XT(tt, xt0, xt1, *z_args[0]), sj.get_XT(tj, xj0, xj1, *z_args[1])),
        "get_BT": (si.get_BT(tt, xt0, xt1, *z_args[0]), sj.get_BT(tj, xj0, xj1, *z_args[1])),
        "get_VT": (si.get_VT(tt, xt0, xt1), sj.get_VT(tj, xj0, xj1)),
    }
    for a, b in zip(si.flow_objective(tt, xt0, xt1, *z_args[0]),
                    sj.flow_objective(tj, xj0, xj1, *z_args[1])):
        pairs.setdefault("flow_objective", []).append((a, b))
    for a, b in zip(si.denoising_objective(tt, xt0, xt1, *z_args[0]),
                    sj.denoising_objective(tj, xj0, xj1, *z_args[1])):
        pairs.setdefault("denoising_objective", []).append((a, b))
    vt, vj = pairs["get_VT"]
    pairs["get_BT_from_score"] = (si.get_BT_from_score(tt, vt, zt),
                                  sj.get_BT_from_score(tj, vj, zj))
    for method, pair in pairs.items():
        for got, want in (pair if isinstance(pair, list) else [pair]):
            assert got.shape == want.shape, method
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6,
                                       err_msg=method)
    # the score divides by gamma (alpha when one-sided), zero for Mirror's alpha
    score, want = si.get_ST(tt, zt), sj.get_ST(tj, zj)
    np.testing.assert_allclose(score.numpy(), np.asarray(want), rtol=1e-5, atol=0)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_scalar_time_matches_jax(name, kw):
    mine, theirs = _pair(name, kw)
    x0 = np.full((2, 3), 0.5, np.float32)
    for t in (0.25, 0.75):
        for field in FIELDS:
            np.testing.assert_allclose(_np(getattr(mine, field)(t)),
                                       np.asarray(getattr(theirs, field)(jnp.float32(t))),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{field}({t})")
        if mine.one_sided:
            got = mine.get_xt(t, torch.from_numpy(x0), torch.from_numpy(2 * x0))
            want = theirs.get_xt(t, jnp.asarray(x0), jnp.asarray(2 * x0))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_golden_values():
    t = torch.tensor([0.25])
    it = port.LinearInterpolant()
    np.testing.assert_allclose(it.gamma(t), [np.sqrt(2.0 * 0.25 * 0.75)], rtol=1e-6)
    np.testing.assert_allclose(it.gamma_dot(t), [0.5 / np.sqrt(2.0 * 0.25 * 0.75)], rtol=1e-6)
    half = torch.tensor([0.5])
    tr = port.TrigInterpolant()
    np.testing.assert_allclose(tr.alpha(half), [np.cos(np.pi / 4)], rtol=1e-6)
    np.testing.assert_allclose(tr.beta(half), [np.sin(np.pi / 4)], rtol=1e-6)
    sb = port.SBDMInterpolant()
    assert sb.one_sided
    np.testing.assert_allclose(sb.alpha(half), [np.sqrt(0.75)], rtol=1e-6)
    np.testing.assert_allclose(sb.alpha_dot(half), [-0.5 / np.sqrt(0.75)], rtol=1e-6)
    ed = port.EncDecInterpolant()
    tq = torch.tensor([0.25, 0.75])
    np.testing.assert_allclose(ed.alpha(tq), [np.cos(np.pi * 0.25) ** 2, 0.0], atol=1e-7)
    np.testing.assert_allclose(ed.beta(tq), [0.0, np.cos(np.pi * 0.75) ** 2], atol=1e-7)
    mi = port.MirrorInterpolant()
    x0, x1, z = (torch.randn(4, 8, generator=torch.Generator().manual_seed(i)) for i in range(3))
    np.testing.assert_allclose(mi.get_xt(torch.full((4,), 0.3), x0, x1, z).numpy(),
                               (x1 + np.sqrt(2 * 0.3 * 0.7) * z).numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="Z must be provided"):
        port.TrigInterpolant().flow_objective(tq, x0[:2], x1[:2])
    assert set(port.INTERPOLANTS) == set(ref.INTERPOLANTS)
    assert all(port.INTERPOLANTS[k].__name__ == ref.INTERPOLANTS[k].__name__
               for k in ref.INTERPOLANTS)
