"""The port's folded linear attention against the JAX package's Pallas kernels.

The JAX side runs ``linear_attention_folded`` (K1 ``_folded_context_kernel`` and
K2 ``_folded_project_kernel``) under ``pltpu.force_tpu_interpret_mode()`` with
``block_n=128``, as ``tests/test_linear_attention.py`` does; the port's side is
the wrappers on CPU tensors, which run the plain PyTorch versions of its CUDA
kernels. Inputs are drawn with numpy from a seed and handed to both. Both
round p, v and ctx to bf16, but the Pallas kernel rounds exp(k - m) with a
running max per 128-token block where the plain version uses the global max.
Outputs are about 1e-2 (RMS) at these shapes and the two differ by at most
about 1.2e-4, so the tolerance is atol 3e-4 + rtol 1e-2·|JAX| elementwise and
5e-3 in relative L2.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_tpu.ops.linear_attention import (
    linear_attention_folded as jax_linear_attention_folded,
)

HEADS, D = 4, 32


def _inputs(seed, n, m, batch=2):
    rng = np.random.default_rng(seed)
    draw = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (draw(batch, n, HEADS * D), draw(batch, m, HEADS * D), draw(batch, m, HEADS * D),
            draw(4, HEADS * D), draw(4, HEADS * D))


def _jax(arrays, dtype):
    fn = functools.partial(jax_linear_attention_folded, heads=HEADS, block_n=128)
    with pltpu.force_tpu_interpret_mode():
        out = fn(*(jnp.asarray(a, dtype) for a in arrays))
    return np.asarray(out.astype(jnp.float32))


def _assert_close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=3e-4)
    assert np.linalg.norm(out - ref) <= 5e-3 * np.linalg.norm(ref)


def _port(arrays, dtype):
    tensors = [torch.from_numpy(a).to(dtype) for a in arrays]
    return la.linear_attention_folded(*tensors, heads=HEADS).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m", [(256, 384), (512, 512)])
def test_folded_matches_jax_pallas_interpret(n, m, dtype):
    arrays = _inputs(3, n, m)
    out = _port(arrays, getattr(torch, dtype))
    ref = _jax(arrays, getattr(jnp, dtype))
    assert out.shape == ref.shape == (2, n, HEADS * D)
    _assert_close(out, ref)


def test_folded_survives_cross_head_logit_spread():
    """Head 0's q logits 200 below head 3's: a row-max shift would underflow
    head 0 to 0/0; the per-head shift keeps every group finite."""
    arrays = list(_inputs(6, 128, 128, batch=1))
    arrays[0][..., :D] -= 200.0
    arrays[0][..., 3 * D:] += 50.0
    out = _port(arrays, torch.float32)
    ref = _jax(arrays, jnp.float32)
    assert np.isfinite(out).all()
    _assert_close(out, ref)


def test_folded_rejects_width_not_multiple_of_128():
    q = torch.zeros(1, 8, 96)
    with pytest.raises(ValueError, match="multiple of 128"):
        la.linear_attention_folded(q, q, q, torch.zeros(4, 96), torch.zeros(4, 96), heads=3)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    arrays = _inputs(9, 64, 96)
    q, k, v, mk, mv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    la.reset_launch_counts()
    ctx = la.folded_context(k, v, mk, mv, HEADS)
    out = la.folded_project(q, ctx, HEADS)
    assert la.launch_counts == {"folded_context": 0, "folded_project": 0,
                                "linear_context": 0, "linear_project": 0}
    torch.testing.assert_close(ctx, la.folded_context_plain(k, v, mk, mv, HEADS), rtol=0, atol=0)
    torch.testing.assert_close(out, la.folded_project_plain(q, ctx, HEADS), rtol=0, atol=0)
