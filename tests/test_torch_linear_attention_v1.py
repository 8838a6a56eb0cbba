"""The port's v1 linear attention against the JAX package's v1 Pallas path.

The JAX side runs ``linear_attention`` (K4a ``_context_kernel`` and K4b
``_project_kernel``, with its closed-form ``_bwd``) under
``pltpu.force_tpu_interpret_mode()`` with ``block_n=128``, as
``tests/test_linear_attention.py`` does, so its online softmax runs over
several blocks with a ragged tail. The port's side is the wrappers on CPU
tensors, which run the plain PyTorch versions of its CUDA kernels, and its
closed-form backward. Inputs are drawn with numpy from a seed and handed to
both. Both compute every product in f32, so they differ only in the order of
the sums and in the softmax shift (a running max per block against the
global max): f32 outputs within atol 1e-5 and rtol 1e-4, bf16 outputs within
one bf16 ulp plus 1e-3·RMS, gradients within 1e-4 in relative L2.

The module test holds ``LinearAttention(fused=True, fused_folded=False)``
against the flax module built with ``fused=True`` at 32³ = 32,768 tokens, the
v1 dispatch threshold, on the same weights (``params_from_jax``), f32, at
atol/rtol 1e-4.

The 4 × 32 bf16 kernels' arithmetic, emulated in f32 torch (no card here):
K4a's token ranges, running max per 64-token tile and p_hi + p_lo products
with the fixed combine order, and K4b's three products p_hi·c_hi + p_lo·c_hi +
p_hi·c_lo, against the JAX kernels in interpret mode, at near-f32 accuracy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flowtrain_stochastic_interpolation_torch.models import attention as port_attention
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_tpu.models import attention as jax_attention
from flowtrain_stochastic_interpolation_tpu.ops import linear_attention as jax_la

HEADS, D = 2, 32


def _inputs(seed, n, m, batch=2, heads=HEADS, d=D):
    rng = np.random.default_rng(seed)
    draw = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return draw(batch, n, heads, d), draw(batch, m, heads, d), draw(batch, m, heads, d)


def _jax(arrays, dtype):
    with pltpu.force_tpu_interpret_mode():
        out = jax_la.linear_attention(*(jnp.asarray(a, dtype) for a in arrays), block_n=128)
    return np.asarray(out.astype(jnp.float32))


def _port(arrays, dtype):
    return la.linear_attention(*(torch.from_numpy(a).to(dtype) for a in arrays))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m", [(256, 260), (300, 304), (512, 512)])
def test_v1_matches_jax_pallas_interpret(n, m, dtype):
    arrays = _inputs(n + m, n, m)
    out = _port(arrays, getattr(torch, dtype))
    ref = _jax(arrays, getattr(jnp, dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape == (2, n, HEADS, D)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    else:
        rms = np.sqrt(np.mean(ref**2))
        ulp = np.abs(ref) * 2.0**-7  # one bf16 ulp is at most 2^-7 of the value
        assert np.all(np.abs(out - ref) <= ulp + 1e-3 * rms), np.abs(out - ref).max()


@pytest.mark.parametrize("n,m,d", [(128, 132, 16), (300, 304, 32)])
def test_v1_gradients_match_jax_grad_of_the_interpret_kernel(n, m, d):
    arrays = _inputs(n, n, m, batch=1, d=d)
    cot = np.random.default_rng(n + 1).standard_normal((1, n, HEADS, d)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jax_la.linear_attention(q, k, v, block_n=128) * cot)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    la.linear_attention(*tensors).backward(torch.from_numpy(cot))
    for got, ref in zip(tensors, want):
        ref = np.asarray(ref)
        assert np.linalg.norm(got.grad.numpy() - ref) <= 1e-4 * np.linalg.norm(ref)


def test_reference_matches_jax_reference():
    arrays = _inputs(5, 200, 204)
    out = la.linear_attention_reference(*(torch.from_numpy(a) for a in arrays)).numpy()
    ref = np.asarray(jax_la.linear_attention_reference(*(jnp.asarray(a) for a in arrays)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(9, 64, 68))
    la.reset_launch_counts()
    ctx = la.linear_context(k, v)
    out = la.linear_project(q, ctx)
    assert la.launch_counts == {"folded_context": 0, "folded_project": 0,
                                "linear_context": 0, "linear_project": 0}
    assert ctx.dtype == torch.float32 and ctx.shape == (2, HEADS, D, D)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(ctx, la.linear_context_plain(k, v), rtol=0, atol=0)
    torch.testing.assert_close(out, la.linear_project_plain(q, ctx), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The 4 × 32 bf16 kernels' order of sums and split products
# ---------------------------------------------------------------------------
# The kernels carry each f32 operand x of a product as two bf16 terms, x_hi =
# bf16(x) and x_lo = bf16(x - x_hi): bf16 keeps 8 significant bits, so
# |x - x_hi| <= 2^-8·|x| and x_hi + x_lo is within 2^-16·|x| of x. K4a splits
# p (v is bf16), so each product p·v is within 2^-16 of its f32 value; K4b
# splits p and ctx and drops p_lo·c_lo, so within 3·2^-16. A sum of products
# Σ a·b is then within that much of Σ |a|·|b|, to which the sums' own f32
# rounding (in another order on each side) adds a little. Elementwise, the
# context is held within 2^-16 and the output within 3·2^-16 of Σ |a|·|b|
# (the scale is Σ |a|·|b|, not the value: v and ctx are signed, and their sums
# cancel); both within 2^-16 in relative L2, where the rounding errors, of
# either sign, mostly cancel. p rounded to bf16 alone, K1's rounding (2^-8·|p|
# at worst), misses that by far.
NEAR_F32 = 2.0**-16
SPLIT_TERMS = {"context": 1, "output": 3}  # products whose rounding bounds the error


def _split(x):
    """(x_hi, x_lo) in f32: x_hi = bf16(x), x_lo = bf16(x - x_hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _cuda_k4a_order(k, v, blocks, split=True, tile=64):
    """K4a's sums in plain PyTorch, f32 ``[B, h, d, d]``.

    As ``linear_context_partial`` cuts the tokens: each block walks
    ``ceil(tiles · B / blocks)`` tiles of 64 tokens of one batch item, keeping
    a running column max per tile and the sum in f32; p = exp(k − m) enters
    p·v as p_lo·v + p_hi·v (``split``) or as bf16(p)·v alone (K1's rounding);
    v is bf16. Then ``linear_context_combine`` merges the ranges in order with
    the exp(m_c − M) rescale, with no memory seed."""
    b, n, h, d = k.shape
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))  # [b, h, n, d]
    tiles = -(-n // tile)
    per_range = -(-tiles * b // blocks)
    parts = []
    for first in range(0, tiles, per_range):
        m = torch.full((b, h, d), -torch.inf)
        s = torch.zeros(b, h, d)
        c = torch.zeros(b, h, d, d)
        for t in range(first, min(first + per_range, tiles)):
            kt, vt = kf[:, :, t * tile:(t + 1) * tile], vf[:, :, t * tile:(t + 1) * tile]
            m_new = torch.maximum(m, kt.amax(dim=2))
            alpha = torch.exp(m - m_new)
            p = torch.exp(kt - m_new[:, :, None])
            s = s * alpha + p.sum(dim=2)
            hi, lo = _split(p) if split else (p.to(torch.bfloat16).float(), torch.zeros_like(p))
            product = lambda a: torch.einsum("bhnd,bhne->bhde", a, vt)
            c = c * alpha[..., None] + product(lo) + product(hi)
            m = m_new
        parts.append((m, s, c))
    big_m = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    s, c = torch.zeros(b, h, d), torch.zeros(b, h, d, d)
    for m_c, s_c, c_c in parts:
        w = torch.exp(m_c - big_m)
        s, c = s + s_c * w, c + c_c * w[..., None]
    return c / s[..., None]


def _cuda_k4b_products(q, ctx):
    """K4b's arithmetic in plain PyTorch: p = softmax_d(q)·d^-½ and ctx each
    split in two bf16 terms, out = p_lo·c_hi + p_hi·c_lo + p_hi·c_hi in f32
    (before the output's rounding to q's dtype)."""
    p = torch.softmax(q.float(), dim=-1) * q.shape[-1] ** -0.5
    (p_hi, p_lo), (c_hi, c_lo) = _split(p), _split(ctx)
    product = lambda a, c: torch.einsum("bnhd,bhde->bnhe", a, c)
    return product(p_lo, c_hi) + product(p_hi, c_lo) + product(p_hi, c_hi)


def _jax_v1_context(k, v, block_n=128):
    """The JAX K4a alone (``_context_kernel``, as ``_linear_attn_fwd_bhnd`` calls
    it on ``[B·h, M, d]``) in interpret mode: f32 ``[B, h, d, d]``."""
    b, m, h, d = k.shape
    bhnd = lambda t: jnp.asarray(np.ascontiguousarray(t.transpose(0, 2, 1, 3)).reshape(b * h, m, d))
    with pltpu.force_tpu_interpret_mode():
        ctx = pl.pallas_call(
            functools.partial(jax_la._context_kernel, n_keys=m, block_k=block_n),
            grid=(b * h, pl.cdiv(m, block_n)),
            in_specs=[pl.BlockSpec((1, block_n, d), lambda i, ki: (i, ki, 0)),
                      pl.BlockSpec((1, block_n, d), lambda i, ki: (i, ki, 0))],
            out_specs=pl.BlockSpec((1, d, d), lambda i, ki: (i, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((b * h, d, d), jnp.float32),
            scratch_shapes=[pltpu.VMEM((1, d), jnp.float32), pltpu.VMEM((1, d), jnp.float32),
                            pltpu.VMEM((d, d), jnp.float32)],
        )(bhnd(k), bhnd(v))
    return torch.from_numpy(np.array(ctx).reshape(b, h, d, d))


def _near_f32_error(got, want, scale):
    """(relative L2 error, worst elementwise error over ``NEAR_F32``·scale)."""
    rel = ((got - want).norm() / want.norm()).item()
    return rel, ((got - want).abs() / (NEAR_F32 * scale)).max().item()


def _k4_scales(q, k, v, ctx):
    """Σ |a|·|b| of each entry of K4a's context (softmax_N(k)ᵀ·|v|) and of K4b's
    output (softmax_d(q)·d^-½ @ |ctx|), in f32."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    p_k = torch.softmax(k, dim=1)
    p_q = torch.softmax(q, dim=-1) * q.shape[-1] ** -0.5
    return (torch.einsum("bmhd,bmhe->bhde", p_k, v.abs()),
            torch.einsum("bnhd,bhde->bnhe", p_q, ctx.abs()))


def _k4_case(name):
    """Batch 2 × 597 queries × 601 keys (4 memory tokens first, drawn apart
    from the others, then ten 64-token tiles, the last 25 tokens) × 4 heads ×
    32, bf16 values; ``peaked``: the keys × 8."""
    n, m = 597, 601
    q, k, v = (a.astype(jnp.bfloat16).astype(np.float32)
               for a in _inputs(11, n, m, heads=4, d=32))
    if name == "peaked":
        k = k * 8  # exact in bf16
    return q, k, v


@pytest.mark.parametrize("case", ["ragged", "peaked"])
def test_cuda_k4_arithmetic_holds_near_f32_against_the_jax_kernels(case):
    """Over 8 blocks (ranges of 3 tiles, 4 per batch item, the last one tile),
    the emulated K4a context and K4b output against the JAX kernels' f32 in
    interpret mode (``block_n`` 128): within ``NEAR_F32`` in relative L2, and
    within ``SPLIT_TERMS``·``NEAR_F32`` of Σ |a|·|b| elementwise."""
    q, k, v = _k4_case(case)
    ctx = _cuda_k4a_order(*(torch.from_numpy(a).to(torch.bfloat16) for a in (k, v)), blocks=8)
    want_ctx = _jax_v1_context(k, v)
    out = _cuda_k4b_products(torch.from_numpy(q).to(torch.bfloat16), ctx)
    want_out = torch.from_numpy(_jax((q, k, v), jnp.float32))
    scales = _k4_scales(q, k, v, want_ctx)
    for name, got, want, scale in zip(SPLIT_TERMS, (ctx, out), (want_ctx, want_out), scales):
        rel, worst = _near_f32_error(got, want, scale)
        assert rel <= NEAR_F32 and worst <= SPLIT_TERMS[name], (name, rel, worst)


@pytest.mark.parametrize("case", ["ragged", "peaked"])
def test_bf16_p_alone_misses_the_near_f32_tolerance(case):
    """K1's rounding of p to bf16 in K4a's order of sums: its context misses
    ``NEAR_F32`` by far, so the split is what holds the tolerance above."""
    q, k, v = _k4_case(case)
    ctx = _cuda_k4a_order(*(torch.from_numpy(a).to(torch.bfloat16) for a in (k, v)), blocks=8,
                          split=False)
    want = _jax_v1_context(k, v)
    rel, worst = _near_f32_error(ctx, want, _k4_scales(q, k, v, want)[0])
    assert rel > 8 * NEAR_F32 and worst > 8 * SPLIT_TERMS["context"], (rel, worst)


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------
def _random_tree(module, x, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])
        if name == "g":
            return 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        return 0.5 * rng.standard_normal(leaf.shape)  # bias, mem_kv

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def recorded(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, recorded)


def test_linear_attention_module_v1_matches_flax_fused_at_32_cubed(monkeypatch):
    dim, heads, dim_head = 8, 2, 8
    x = np.random.default_rng(0).standard_normal((1, 32, 32, 32, dim)).astype(np.float32)
    module = jax_attention.LinearAttention(dim=dim, heads=heads, dim_head=dim_head, fused=True)
    variables = _random_tree(module, jnp.asarray(x), 1)
    jax_calls, port_calls = [], []
    _spy(monkeypatch, jax_la, "linear_attention", jax_calls)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(module.apply(variables, jnp.asarray(x)))
    assert jax_calls == ["linear_attention"]  # the flax module took the v1 kernels

    port = port_attention.LinearAttention(dim, heads, dim_head, fused=True, fused_folded=False,
                                          device="cpu")
    port.load_state_dict(params_from_jax(variables, port))
    _spy(monkeypatch, port_attention, "linear_attention", port_calls)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert port_calls == ["linear_attention"] and port.takes_v1(32 ** 3)
    assert out.shape == ref.shape == (1, 32, 32, 32, dim)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_dispatch_checks_folded_before_v1(monkeypatch):
    """With ``fused`` and ``fused_folded`` both set, the folded rule is tried
    first, as in the JAX module. CPU tensors never take the folded kernels, so
    they go to v1, as JAX does on a backend that is not a TPU; where the folded
    rule holds, the folded path is taken and v1 is not."""
    calls = []
    _spy(monkeypatch, port_attention, "linear_attention", calls)
    _spy(monkeypatch, port_attention, "linear_attention_folded", calls)
    gen = torch.Generator().manual_seed(0)
    attn = port_attention.LinearAttention(8, heads=4, dim_head=32, fused=True, device="cpu")
    for m in attn.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    x = torch.randn(1, 32, 32, 32, 8, generator=gen)
    with torch.no_grad():
        attn(x)
        assert calls == ["linear_attention"]
        monkeypatch.setattr(attn, "takes_folded", lambda qkv: True)
        attn(x)
        assert calls == ["linear_attention", "linear_attention_folded"]
        attn.fused = False
        monkeypatch.setattr(attn, "takes_folded", lambda qkv: False)
        attn(x)  # neither: the einsum form
    assert calls == ["linear_attention", "linear_attention_folded"]
    assert not attn.takes_v1(32 ** 3) and not port_attention.LinearAttention(
        8, fused=True, device="cpu").takes_v1(32 ** 3 - 1)
