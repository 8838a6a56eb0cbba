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

The CUDA K1 on 4 × 32 bf16 heads sums in its own order: a running column max
per 64-token tile inside each block's contiguous token range, p rounded to
bf16 against that running max, and the ranges merged after the memory tokens
with the exp(m_c − M) rescale. A plain emulation of that order is held against
the JAX ``_folded_context_kernel`` (and the port's plain version) within the
tolerance ``chip_smoke.py`` holds the kernel to.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_tpu.ops.linear_attention import (
    _folded_context_kernel,
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


def _jax_context(k, v, mem_k, mem_v, block_n=128):
    """The JAX K1 alone (``_folded_context_kernel``, as ``_folded_fwd`` calls it),
    in interpret mode: f32 ``[B, h·d, h·d]``."""
    b, m, hd = k.shape
    with pltpu.force_tpu_interpret_mode():
        ctx = pl.pallas_call(
            functools.partial(_folded_context_kernel, n_keys=m, block_k=block_n, heads=HEADS,
                              dim_head=D),
            grid=(b, pl.cdiv(m, block_n)),
            in_specs=[
                pl.BlockSpec((1, block_n, hd), lambda bb, ki: (bb, ki, 0)),
                pl.BlockSpec((1, block_n, hd), lambda bb, ki: (bb, ki, 0)),
                pl.BlockSpec(mem_k.shape, lambda bb, ki: (0, 0)),
                pl.BlockSpec(mem_v.shape, lambda bb, ki: (0, 0)),
            ],
            out_specs=pl.BlockSpec((1, hd, hd), lambda bb, ki: (bb, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((b, hd, hd), jnp.float32),
            scratch_shapes=[pltpu.VMEM((1, hd), jnp.float32), pltpu.VMEM((1, hd), jnp.float32),
                            pltpu.VMEM((hd, hd), jnp.float32)],
        )(k, v, mem_k, mem_v)
    return np.asarray(ctx)


def _cuda_k1_order(k, v, mem_k, mem_v, blocks, tile=64):
    """The CUDA K1's sums in plain PyTorch (f32, bf16 p and v in the products).

    As ``folded_context_partial`` cuts the tokens: each block walks
    ``ceil(tiles · B / blocks)`` tiles of 64 tokens of one batch item, keeping a
    running column max per tile, p = exp(k − m) rounded to bf16 against it, and
    the sum in f32; then ``folded_context_combine`` seeds with the memory tokens
    in f32 and merges the ranges in order with the exp(m_c − M) rescale."""
    b, n, hd = k.shape
    kf, vb = k.float(), v.float()
    tiles = -(-n // tile)
    per_range = -(-tiles * b // blocks)
    parts = []
    for first in range(0, tiles, per_range):
        m = torch.full((b, hd), -torch.inf)
        s = torch.zeros(b, hd)
        c = torch.zeros(b, hd, hd)
        for t in range(first, min(first + per_range, tiles)):
            kt, vt = kf[:, t * tile:(t + 1) * tile], vb[:, t * tile:(t + 1) * tile]
            m_new = torch.maximum(m, kt.amax(dim=1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(kt - m_new[:, None])
            s = s * alpha + p.sum(dim=1)
            c = c * alpha[:, :, None] + torch.einsum(
                "bnd,bne->bde", p.to(torch.bfloat16).float(), vt)
            m = m_new
        parts.append((m, s, c))
    mk, mv = mem_k.float(), mem_v.float()
    m0 = mk.amax(dim=0)
    p0 = torch.exp(mk - m0)
    big_m = torch.stack([m0.expand(b, hd)] + [m for m, _, _ in parts]).amax(dim=0)
    w = torch.exp(m0 - big_m)
    s, c = p0.sum(dim=0) * w, (p0.T @ mv)[None] * w[:, :, None]
    for m_c, s_c, c_c in parts:
        w = torch.exp(m_c - big_m)
        s, c = s + s_c * w, c + c_c * w[:, :, None]
    head = torch.arange(hd) // D
    return torch.where(head[:, None] == head[None, :], c / s[:, :, None], 0.0)


def _assert_k1_tolerance(got, want):
    """chip_smoke.py's rule for K1: exactly 0 off the head-diagonal blocks;
    3e-2·RMS + 1e-2·|want| elementwise (RMS over the blocks) and 1e-2 in
    relative L2."""
    head = torch.arange(HEADS * D) // D
    diag = head[:, None] == head[None, :]
    assert torch.count_nonzero(got[:, ~diag]) == 0
    rms = want[:, diag].square().mean().sqrt().item()
    torch.testing.assert_close(got, want, rtol=1e-2, atol=3e-2 * rms)
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.parametrize("mem_shift", [0.0, 12.0])
def test_cuda_k1_order_of_sums_holds_the_k1_tolerance(mem_shift):
    """Batch 2 × 597 tokens (ten 64-token tiles, the last 21 tokens) over 8
    blocks: ranges of 3 tiles, 4 per item, the last one tile; against the JAX
    kernel's 128-token blocks. With ``mem_shift`` the 4 memory tokens outweigh
    the keys (e^12), so the merge leans on the seed."""
    arrays = list(_inputs(12, 597, 597))
    arrays[3] = arrays[3] + mem_shift
    q, k, v, mk, mv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = _cuda_k1_order(k, v, mk, mv, blocks=8)
    want = torch.from_numpy(_jax_context(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                           for t in (k, v, mk, mv))))
    _assert_k1_tolerance(got, want)
    _assert_k1_tolerance(got, la.folded_context_plain(k, v, mk, mv, HEADS))
