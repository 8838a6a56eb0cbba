"""The port's GEMM probes P1 and P2 against the JAX package's Pallas probes.

The JAX side is the probe kernels of ``tools/bench_pallas_gemm.py``
(``pallas_mm``, ``pallas_mm_t``) and ``tools/bench_mxu_shapes.py``
(``_make_probe_kernel``, in a ``pl.pallas_call`` built here with ``_run``'s
specs) under ``pltpu.force_tpu_interpret_mode()``. The port's side is its
wrappers on CPU tensors, which run the plain PyTorch versions. Inputs are
drawn with numpy from a seed and handed to both, in bf16. Both sum exact
products of bf16 values in f32 in another order and round once to bf16:
within one bf16 ulp plus 1e-3·RMS.

Importing the two tools sets ``jax_compilation_cache_dir`` and
``jax_persistent_cache_min_compile_time_secs`` for the whole process; the
fixture that imports them puts both back at once, so no other test sees them.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flowtrain_stochastic_interpolation_torch.ops import gemm_probes as gp

_SETTINGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def tools():
    """``(bench_pallas_gemm, bench_mxu_shapes)``, with the JAX settings that their
    import changes restored."""
    saved = {name: getattr(jax.config, name) for name in _SETTINGS}
    try:
        return (importlib.import_module("tools.bench_pallas_gemm"),
                importlib.import_module("tools.bench_mxu_shapes"))
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)


def test_importing_the_tools_leaves_the_jax_settings_as_they_were(tools):
    assert jax.config.jax_compilation_cache_dir != tools[0]._CACHE_DIR
    assert jax.config.jax_persistent_cache_min_compile_time_secs != 5.0


def _bf16(rng, *shape, scale=1.0):
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)


def _assert_ulp_close(out, ref):
    out = out.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    rms = np.sqrt(np.mean(ref**2))
    ulp = np.abs(ref) * 2.0**-7  # one bf16 ulp is at most 2^-7 of the value
    assert np.all(np.abs(out - ref) <= ulp + 1e-3 * rms), np.abs(out - ref).max()


@pytest.mark.parametrize("k,n", [(144, 48), (1296, 48), (96, 128)])
def test_p1_matches_pallas_mm_and_pallas_mm_t(tools, k, n):
    gemm = tools[0]
    rng = np.random.default_rng(k + n)
    a, a_j = _bf16(rng, 1024, k)
    b, b_j = _bf16(rng, k, n, scale=0.02)
    with pltpu.force_tpu_interpret_mode():
        want = gemm.pallas_mm(a_j, b_j)
        want_t = gemm.pallas_mm_t(a_j, b_j.T)
    gp.reset_launch_counts()
    out, out_t = gp.gemm_probe(a, b), gp.gemm_probe_t(a, b.T.contiguous())
    assert gp.launch_counts == {"gemm_probe": 0, "gemm_probe_t": 0, "mma_probe": 0}
    assert out.dtype == out_t.dtype == torch.bfloat16
    assert out.shape == (1024, n) and out_t.shape == (n, 1024)
    _assert_ulp_close(out, want)
    _assert_ulp_close(out_t, want_t)


def _pallas_probe(mxu, a, b, reps):
    """``_make_probe_kernel`` in a ``pl.pallas_call`` with ``_run``'s specs."""
    grid, rows, k = a.shape
    m_block, n = rows - 32 * 8, b.shape[1]
    with pltpu.force_tpu_interpret_mode():
        return pl.pallas_call(
            mxu._make_probe_kernel(m_block, reps),
            grid=(grid,),
            in_specs=[
                pl.BlockSpec((1, rows, k), lambda i: (i, 0, 0)),
                pl.BlockSpec((k, n), lambda i: (0, 0)),
            ],
            out_specs=pl.BlockSpec((m_block, n), lambda i: (0, 0)),
            out_shape=jax.ShapeDtypeStruct((m_block, n), jnp.bfloat16),
        )(a, b)


@pytest.mark.parametrize("k,n", [(48, 48), (144, 40)])
def test_p2_matches_the_pallas_probe_kernel(tools, k, n):
    """m_block 16, grid 2, R = 40: every window of the 32 and 8 of them twice."""
    rng = np.random.default_rng(k)
    a, a_j = _bf16(rng, 2, 16 + gp.WINDOW_PAD, k)
    b, b_j = _bf16(rng, k, n, scale=0.02)
    want = _pallas_probe(tools[1], a_j, b_j, 40)
    gp.reset_launch_counts()
    out = gp.mma_probe(a, b, 40)
    assert gp.launch_counts == {"gemm_probe": 0, "gemm_probe_t": 0, "mma_probe": 0}
    assert out.dtype == torch.bfloat16 and out.shape == (16, n)
    assert (out >= 0).all()
    _assert_ulp_close(out, want)


def test_p2_plain_version_takes_every_product_it_is_asked_for():
    """R = 8 products see windows 0..7 only: a peak that only window 9 reaches is
    missed at R = 8 and found at R = 40."""
    a = torch.zeros(1, 16 + gp.WINDOW_PAD, 8, dtype=torch.bfloat16)
    b = torch.ones(8, 4, dtype=torch.bfloat16)
    a[0, 8 * 9] = 1.0  # row 0 of window 9
    assert gp.mma_probe_plain(a, b, 8).abs().max() == 0
    assert torch.equal(gp.mma_probe_plain(a, b, 40)[0], torch.full((4,), 8.0).bfloat16())
