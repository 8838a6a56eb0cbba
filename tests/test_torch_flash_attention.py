"""The port's flash attention (K3) against the JAX package's Pallas kernel.

The JAX side runs ``flash_attention`` (``_fa_kernel``, with its blockwise
backward) under ``pltpu.force_tpu_interpret_mode()``, as
``tests/test_flash_attention.py`` does; the port's side is the wrappers on
CPU tensors, which run the plain PyTorch version of the CUDA kernel. Inputs
are drawn with numpy from a seed and handed to both. Both compute the scores,
probabilities and products in f32, so they differ only in the order of the
sums: f32 outputs within 2e-5 (JAX's own bound against its reference), bf16
outputs within one bf16 ulp plus 1e-3·RMS, gradients within 1e-4. The CUDA
kernel's bf16 path passes p to p·v as two bf16 terms; a plain emulation of
that is held to the same bf16 rule against the JAX kernel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flowtrain_stochastic_interpolation_torch.models.attention import Attention
from flowtrain_stochastic_interpolation_torch.ops import flash_attention as fa
from flowtrain_stochastic_interpolation_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)


def _inputs(seed, n, m, batch=2, heads=2, d=32):
    rng = np.random.default_rng(seed)
    draw = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return draw(batch, n, heads, d), draw(batch, m, heads, d), draw(batch, m, heads, d)


def _jax_out(arrays, dtype, **blocks):
    fn = functools.partial(jax_flash_attention, **blocks)
    with pltpu.force_tpu_interpret_mode():
        out = fn(*(jnp.asarray(a, dtype) for a in arrays))
    return np.asarray(out.astype(jnp.float32))


def _port(arrays, dtype):
    return fa.flash_attention_forward(*(torch.from_numpy(a).to(dtype) for a in arrays))


@pytest.mark.parametrize("n,m", [(256, 260), (300, 304), (1000, 1004)])
def test_plain_matches_jax_interpret_f32(n, m):
    arrays = _inputs(n, n, m)
    out, lse = _port(arrays, torch.float32)
    ref = _jax_out(arrays, jnp.float32)
    assert out.shape == ref.shape == (2, n, 2, 32) and lse.shape == (2, 2, n)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n,m", [(256, 260), (1000, 1004)])
def test_plain_matches_jax_interpret_bf16(n, m):
    arrays = _inputs(n + 1, n, m)
    out, _ = _port(arrays, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    ref = _jax_out(arrays, jnp.bfloat16)
    rms = np.sqrt(np.mean(ref**2))
    ulp = np.abs(ref) * 2.0**-7  # one bf16 ulp is at most 2^-7 of the value
    assert np.all(np.abs(out - ref) <= ulp + 1e-3 * rms), np.abs(out - ref).max()


def _kernel_numerics(arrays, split):
    """The CUDA kernel's bf16 path (``flash_mma``) in plain PyTorch: bf16 q, k,
    v; scores and p in f32; p·v with p rounded to bf16 (``split=False``) or as
    the kernel takes it, p_hi + p_lo in two bf16 terms; out rounded to bf16."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().transpose(1, 2) for a in arrays)
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    taken = hi + (p - hi).bfloat16().float() if split else hi
    out = (taken @ v) / p.sum(-1, keepdim=True)
    return out.transpose(1, 2).bfloat16().float().numpy()


@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_kernel_split_p_holds_the_k3_tolerance_and_bf16_p_does_not(q_scale):
    """Why the kernel passes p to p·v as p_hi + p_lo: against the JAX kernel's
    bf16 output (f32 p), the split holds K3's tolerance (one bf16 ulp plus
    1e-3·RMS elementwise, 4e-3 relative L2) and bf16 p alone does not."""
    arrays = _inputs(11, 256, 260)
    arrays = (arrays[0] * q_scale, *arrays[1:])
    ref = _jax_out(arrays, jnp.bfloat16)
    rms = np.sqrt(np.mean(ref**2))
    limit = np.abs(ref) * 2.0**-7 + 1e-3 * rms
    split, rounded = _kernel_numerics(arrays, True), _kernel_numerics(arrays, False)
    assert np.all(np.abs(split - ref) <= limit), np.abs(split - ref).max() / rms
    assert np.linalg.norm(split - ref) <= 4e-3 * np.linalg.norm(ref)
    assert np.count_nonzero(np.abs(rounded - ref) > limit) > 0


@pytest.mark.parametrize("n,m", [(256, 260), (300, 304)])
def test_lse_is_the_log_sum_exp_of_the_scores(n, m):
    arrays = _inputs(n + 2, n, m)
    _, lse = _port(arrays, torch.float32)
    q, k, _ = (a.astype(np.float64) for a in arrays)
    s = np.einsum("bihd,bjhd->bhij", q, k) / np.sqrt(q.shape[-1])
    peak = s.max(axis=-1, keepdims=True)
    want = (peak + np.log(np.exp(s - peak).sum(axis=-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


def test_backward_matches_jax_grad_of_the_interpret_kernel():
    arrays = _inputs(7, 128, 132, batch=1, heads=2, d=16)

    def jax_loss(q, k, v):
        out = jax_flash_attention(q, k, v, block_q=128, block_k=128)
        return jnp.sum(out * jnp.cos(out))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fa.flash_attention(*tensors)
    (out * torch.cos(out)).sum().backward()
    for t, w in zip(tensors, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_backward_blocks_cover_a_ragged_query_count():
    """300 queries are a block of 256 and a ragged one of 44: the blockwise
    backward equals autograd of the plain version, to f32 rounding (the
    gradients are below 1; they differ by at most about 2e-7)."""
    arrays = _inputs(8, 300, 304, batch=1)
    a = [torch.from_numpy(x).requires_grad_() for x in arrays]
    b = [torch.from_numpy(x).requires_grad_() for x in arrays]
    dout = torch.from_numpy(_inputs(9, 300, 1, batch=1)[0])
    fa.flash_attention(*a).backward(dout)
    fa.flash_attention_plain(*b)[0].backward(dout)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    arrays = _inputs(10, 64, 68)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    fa.reset_launch_counts()
    out, lse = fa.flash_attention_forward(q, k, v)
    assert fa.launch_counts == {"flash_attention": 0}
    want_out, want_lse = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)


@pytest.mark.parametrize("side,dim_head,flash,takes", [
    (16, 32, True, True),     # 4096 tokens, d % 8 == 0
    (10, 8, True, False),     # 1000 tokens: below the gate
    (12, 8, True, True),      # 1728 tokens
    (12, 4, True, False),     # d % 8 != 0
    (16, 32, False, False),   # flash off
])
def test_attention_dispatch(monkeypatch, side, dim_head, flash, takes):
    attn = Attention(8, heads=2, dim_head=dim_head, flash=flash)
    gen = torch.Generator().manual_seed(0)
    for mod in attn.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)
    calls = []
    real = fa.flash_attention

    def spy(q, k, v):
        calls.append((q.shape, k.shape))
        return real(q, k, v)

    monkeypatch.setattr("flowtrain_stochastic_interpolation_torch.models.attention.flash_attention", spy)
    x = torch.randn(1, side, side, side, 8, generator=gen)
    out = attn(x)
    assert attn.takes_flash(side**3) is takes
    assert len(calls) == int(takes)
    if takes:
        assert calls[0] == ((1, side**3, 2, dim_head), (1, side**3 + 4, 2, dim_head))
    assert out.shape == x.shape and torch.isfinite(out).all()
