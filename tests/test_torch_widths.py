"""The head widths and dtypes the widened kernels take, against the JAX package.

Head widths that the port's dispatch admits, up to 128 and past it, and f32 as
well as bf16 operands, through the CPU wrappers (the plain versions of K1/K2,
K3 and K4a/K4b) against the JAX Pallas kernels under
``pltpu.force_tpu_interpret_mode()``. Inputs are drawn with numpy from a seed
and handed to both.

* The folded path (K1 + K2) at 8 × 32, 4 × 64 and 2 × 64, and past 128 at
  16 × 136 (the fewest heads of 136 whose h·d is a multiple of 128) and
  1 × 256: both round p, v and ctx to bf16, but the Pallas kernel rounds
  exp(k - m) with a running max per 128-token block where the plain version
  uses the global max, so the tolerance is that of
  ``tests/test_torch_linear_attention.py``: atol 3e-4 + rtol 1e-2·|JAX|
  elementwise and 5e-3 in relative L2.
* Flash attention (K3) at d ∈ {8, 16, 48, 128, 136, 256}: both compute in f32
  and differ in the order of the sums only, so f32 within 2e-5 and bf16
  within one bf16 ulp plus 1e-3·RMS, as ``tests/test_torch_flash_attention.py``.
* The v1 path (K4a + K4b) at d ∈ {136, 256}: all f32 on both sides, so the
  tolerance of ``tests/test_torch_linear_attention_v1.py``: f32 within atol
  1e-5 and rtol 1e-4, bf16 within one bf16 ulp plus 1e-3·RMS.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flowtrain_stochastic_interpolation_torch.ops import flash_attention as fa
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from flowtrain_stochastic_interpolation_tpu.ops.linear_attention import (
    linear_attention as jax_linear_attention,
)
from flowtrain_stochastic_interpolation_tpu.ops.linear_attention import (
    linear_attention_folded as jax_linear_attention_folded,
)


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,d", [(8, 32), (4, 64), (2, 64), (16, 136), (1, 256)])
def test_folded_widths_match_jax_pallas_interpret(heads, d, dtype):
    hd, n, m = heads * d, 256, 300
    arrays = _draw(heads * d, (2, n, hd), (2, m, hd), (2, m, hd), (4, hd), (4, hd))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_linear_attention_folded(
            *(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays), heads=heads, block_n=128)
    ref = np.asarray(ref.astype(jnp.float32))
    out = la.linear_attention_folded(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays), heads=heads)
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, n, hd)
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=3e-4)
    assert np.linalg.norm(out - ref) <= 5e-3 * np.linalg.norm(ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 48, 128, 136, 256])
def test_flash_widths_match_jax_pallas_interpret(d, dtype):
    n, m = 256, 260
    arrays = _draw(d, (2, n, 2, d), (2, m, 2, d), (2, m, 2, d))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_attention(*(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays))
    ref = np.asarray(ref.astype(jnp.float32))
    out, lse = fa.flash_attention_forward(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays))
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, n, 2, d)
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, n)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    else:
        _assert_ulp_close(out, ref)


def _assert_ulp_close(out, ref):
    rms = np.sqrt(np.mean(ref**2))
    ulp = np.abs(ref) * 2.0**-7  # one bf16 ulp is at most 2^-7 of the value
    assert np.all(np.abs(out - ref) <= ulp + 1e-3 * rms), np.abs(out - ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [136, 256])
def test_v1_widths_match_jax_pallas_interpret(d, dtype):
    n, m = 256, 260
    arrays = _draw(d + 1, (2, n, 2, d), (2, m, 2, d), (2, m, 2, d))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_linear_attention(*(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays),
                                   block_n=128)
    ref = np.asarray(ref.astype(jnp.float32))
    out = la.linear_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays))
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, n, 2, d)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    else:
        _assert_ulp_close(out, ref)
