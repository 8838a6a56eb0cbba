"""The port's profiling and debug utilities against the JAX package's.

``grad_health`` on the same gradient tree (seeded numpy arrays, one with a NaN
and an infinity) gives JAX's three statistics within f32 rounding (1e-6
relative); ``check_finite`` raises ``FloatingPointError`` where JAX's does and
names the leaf; ``enable_nan_checking`` turns autograd's anomaly mode on and
off; ``StepTimer`` keeps JAX's ``summary()`` keys and leaves out its warm-up
calls; ``compile_time`` times one call; ``trace`` writes a Chrome trace that
holds the traced operations.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch.utils import debug, profiling
from flowtrain_stochastic_interpolation_tpu.utils import debug as jax_debug
from flowtrain_stochastic_interpolation_tpu.utils import profiling as jax_profiling


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def grads(bad: bool):
    rng = np.random.default_rng(0)
    tree = {"conv": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                     "bias": rng.standard_normal(8).astype(np.float32)},
            "dense": {"kernel": 5 * rng.standard_normal((8, 2)).astype(np.float32)}}
    if bad:
        tree["conv"]["bias"][3] = np.nan
        tree["dense"]["kernel"][1, 1] = np.inf
    return tree


def as_torch(tree):
    return {k: as_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def as_jax(tree):
    return {k: as_jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("bad", [False, True])
def test_grad_health_matches_jax(bad):
    tree = grads(bad)
    got = debug.grad_health(as_torch(tree))
    want = jax_debug.grad_health(as_jax(tree))
    assert set(got) == set(want) == {"grad_norm", "grad_max_abs", "grad_finite_frac"}
    for key in want:
        assert got[key].ndim == 0
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-6)


def test_check_finite_names_the_leaf():
    debug.check_finite(as_torch(grads(False)), "grads")
    jax_debug.check_finite(as_jax(grads(False)), "grads")
    with pytest.raises(FloatingPointError) as ours:
        debug.check_finite(as_torch(grads(True)), "grads")
    with pytest.raises(FloatingPointError) as theirs:
        jax_debug.check_finite(as_jax(grads(True)), "grads")
    assert str(ours.value) == "non-finite values in grads:conv/bias"
    assert str(theirs.value).startswith("non-finite values in grads:")
    assert "conv" in str(theirs.value) and "bias" in str(theirs.value)
    with pytest.raises(FloatingPointError, match="states:1"):
        debug.check_finite([np.zeros(3), np.array([1.0, np.nan])], "states")


def test_enable_nan_checking():
    try:
        debug.enable_nan_checking()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        debug.enable_nan_checking(False)
    assert not torch.is_anomaly_enabled()


def test_step_timer_summary_as_jax():
    ours, theirs = profiling.StepTimer(warmup=2), jax_profiling.StepTimer(warmup=2)
    for _ in range(5):
        assert ours(torch.ones, 4).shape == (4,)
        theirs(jnp.ones, 4)
    assert set(ours.summary()) == set(theirs.summary())
    assert ours.summary()["n"] == theirs.summary()["n"] == 3
    assert ours.summary()["p50_s"] > 0
    assert profiling.StepTimer().summary() == {}
    assert profiling.compile_time(torch.zeros, 3, device="cpu") > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    path = tmp_path / profiling.TRACE_FILE
    assert os.path.getsize(path) > 0
    names = {event.get("name") for event in json.loads(path.read_text())["traceEvents"]}
    assert "aten::mm" in names
