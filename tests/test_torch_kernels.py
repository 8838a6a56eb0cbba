"""The kernels K1 and K2 (folded linear attention), K3 (flash attention),
K4a and K4b (v1 linear attention), K5a and K5b (the tap-folded conv) and the
GEMM probes P1 and P2, their plain versions, and the backwards that train
through them.

Imports nothing of JAX, so it runs where JAX is not installed, with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``. Tests
marked ``gpu`` build and launch the CUDA kernels and skip where there is no
card; the rest run anywhere.
"""

import pytest
import torch
import torch.nn.functional as F

from flowtrain_stochastic_interpolation_torch.models.attention import LinearAttention
from flowtrain_stochastic_interpolation_torch.ops import flash_attention as fa
from flowtrain_stochastic_interpolation_torch.ops import gemm_probes as gp
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_torch.ops import tap_conv as tc
from flowtrain_stochastic_interpolation_torch.tools import ab_flash_attention as ab_flash
from flowtrain_stochastic_interpolation_torch.tools import ab_gemm_conv
from flowtrain_stochastic_interpolation_torch.tools import ab_linear_attention as ab_la
from flowtrain_stochastic_interpolation_torch.tools import bench_mma_shapes as bms
from flowtrain_stochastic_interpolation_torch.tools import variants

HEADS, WIDTH = 4, 128


def _launched(**counts):
    """``la.launch_counts`` after the given launches and no others."""
    return {**dict.fromkeys(("folded_context", "folded_project", "linear_context",
                             "linear_project"), 0), **counts}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(batch, n, device, seed=0, dtype=torch.bfloat16, contiguous=False, spread=False,
         mem_shift=0.0):
    """q, k, v as column slices of one [B, N, 384] tensor (or contiguous [B, N,
    128] tensors), and memory KV [4, 128]; with ``spread`` head 0's q and k
    logits sit 250 below head 3's, and ``mem_shift`` lifts the memory keys."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(batch, n, 3 * WIDTH, generator=gen, device=device)
    mem = torch.randn(2, 4, WIDTH, generator=gen, device=device)
    mem[0] += mem_shift
    if spread:
        d = WIDTH // HEADS
        for part in (0, 1):
            qkv[..., part * WIDTH:part * WIDTH + d] -= 200.0
            qkv[..., (part + 1) * WIDTH - d:(part + 1) * WIDTH] += 50.0
    qkv, mem = qkv.to(dtype), mem.to(dtype)
    q, k, v = qkv[..., :WIDTH], qkv[..., WIDTH:2 * WIDTH], qkv[..., 2 * WIDTH:]
    if contiguous:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v, mem[0].contiguous(), mem[1].contiguous()


def _einsum_reference(q, k, v, mk, mv):
    """Linear attention in f32 with no bf16 rounding: softmax_d(q)·d^-½ @ softmax_N([mk;k])ᵀ[mv;v]."""
    b, n, _ = q.shape
    d = WIDTH // HEADS
    split = lambda t: t.float().reshape(t.shape[0], -1, HEADS, d)
    kk = torch.cat([mk.float().expand(b, -1, -1), k.float()], dim=1)
    vv = torch.cat([mv.float().expand(b, -1, -1), v.float()], dim=1)
    qs = torch.softmax(split(q), dim=-1) * d**-0.5
    ctx = torch.einsum("bnhd,bnhe->bhde", torch.softmax(split(kk), dim=1), split(vv))
    return torch.einsum("bnhd,bhde->bnhe", qs, ctx).reshape(b, n, WIDTH)


def _assert_close_to_plain(got, want, *, atol_frac, rtol, rel_l2=1e-2):
    """chip_smoke.py's rule: elementwise within atol_frac·RMS(want) + rtol·|want|
    (RMS over the nonzero entries), and within rel_l2 in relative L2."""
    got, want = got.float(), want.float()
    rms = want[want != 0].square().mean().sqrt().item()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol_frac * rms)
    assert ((got - want).norm() / want.norm()).item() <= rel_l2


# ---------------------------------------------------------------------------
# Plain versions (anywhere)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [100, 1000])
def test_plain_versions_match_the_unrounded_reference(n):
    q, k, v, mk, mv = _qkv(2, n, torch.device("cpu"), seed=n, dtype=torch.float32)
    ctx = la.folded_context_plain(k, v, mk, mv, HEADS)
    out = la.folded_project_plain(q, ctx, HEADS)
    torch.testing.assert_close(out, _einsum_reference(q, k, v, mk, mv), rtol=3e-2, atol=3e-3)


def test_plain_context_is_zero_off_the_head_diagonal():
    _, k, v, mk, mv = _qkv(1, 50, torch.device("cpu"))
    ctx = la.folded_context_plain(k, v, mk, mv, HEADS)
    d = WIDTH // HEADS
    head = torch.arange(WIDTH) // d
    off = head[:, None] != head[None, :]
    assert ctx.dtype == torch.float32
    assert torch.count_nonzero(ctx[0][off]) == 0
    assert torch.count_nonzero(ctx[0][~off]) == off.numel() - off.sum()


def test_plain_project_keeps_q_dtype():
    q, k, v, mk, mv = _qkv(1, 40, torch.device("cpu"))
    out = la.folded_project_plain(q, la.folded_context_plain(k, v, mk, mv, HEADS), HEADS)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 40, WIDTH)


def test_flash_variants_of_the_ab_tool_still_apply_to_the_source():
    """tools/ab_flash_attention.py builds K3 variants by substituting lines of
    csrc/flash_attention.cu: every substitution must still find its line."""
    for subs, _ in ab_flash.VARIANTS.values():
        assert ab_flash.variant_source(subs) != ab_flash.variant_source([])


def test_linear_attention_variants_of_the_ab_tool_still_apply_to_the_source():
    """tools/ab_linear_attention.py builds K1, K2, K4a and K4b variants by
    substituting lines of csrc/linear_attention.cu: each substitution must still
    find its line."""
    for subs, *_ in ab_la.VARIANTS.values():
        assert variants.variant_source(la.SOURCE, subs) != variants.variant_source(la.SOURCE, [])


@pytest.mark.parametrize("source,table", [
    (gp.SOURCE, ab_gemm_conv.P1_VARIANTS), (gp.SOURCE, ab_gemm_conv.P2_VARIANTS),
    (tc.SOURCE, ab_gemm_conv.K5A_VARIANTS)])
def test_gemm_and_conv_variants_of_the_ab_tool_still_apply_to_the_sources(source, table):
    """tools/ab_gemm_conv.py builds P1, P2 and K5a variants by substituting lines
    of their sources: each substitution must still find its line."""
    for subs, _ in table.values():
        assert variants.variant_source(source, subs) != variants.variant_source(source, [])


# ---------------------------------------------------------------------------
# CUDA kernels (on the card)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("batch,n,options", [
    (2, 4096 + 37, {}), (3, 8192, {}), (1, 1, {}),
    # the 4 x 32 kernels' edges: under one tile, a last tile partly past n at
    # 64³, contiguous [B, N, 128] operands, the cross-head spread, the memory
    # tokens carrying most of the weight
    (1, 5, {}), (8, 1, {}), (8, 5, {}), (8, 262144 + 37, {}), (1, 262144, {}),
    (8, 32768, dict(contiguous=True)), (1, 4096 + 37, dict(contiguous=True)),
    (8, 5, dict(contiguous=True)), (8, 4096, dict(spread=True)),
    (8, 262144, dict(mem_shift=12.0)),
])
def test_kernels_match_plain_versions(cuda, batch, n, options):
    q, k, v, mk, mv = _qkv(batch, n, cuda, seed=n, **options)
    la.reset_launch_counts()
    ctx = la.folded_context(k, v, mk, mv, HEADS)
    ctx_again = la.folded_context(k, v, mk, mv, HEADS)
    ctx_plain = la.folded_context_plain(k, v, mk, mv, HEADS)
    out = la.folded_project(q, ctx_plain, HEADS)
    out_again = la.folded_project(q, ctx_plain, HEADS)
    out_plain = la.folded_project_plain(q, ctx_plain, HEADS)
    torch.cuda.synchronize()
    assert la.launch_counts == _launched(folded_context=2, folded_project=2)
    assert torch.equal(ctx, ctx_again) and torch.equal(out, out_again)
    head = torch.arange(WIDTH, device=cuda) // (WIDTH // HEADS)
    assert torch.count_nonzero(ctx[:, head[:, None] != head[None, :]]) == 0
    # the tolerances chip_smoke.py holds the kernels to
    _assert_close_to_plain(ctx, ctx_plain, atol_frac=3e-2, rtol=1e-2)
    _assert_close_to_plain(out, out_plain, atol_frac=3e-2, rtol=2e-2)


@pytest.mark.gpu
def test_kernels_survive_cross_head_logit_spread(cuda):
    q, k, v, mk, mv = _qkv(1, 4096, cuda, seed=5, dtype=torch.float32)
    d = WIDTH // HEADS
    for t in (q, k):
        t[..., :d] -= 200.0
        t[..., 3 * d:] += 50.0
    q, k, v, mk, mv = (t.to(torch.bfloat16) for t in (q, k, v, mk, mv))
    out = la.linear_attention_folded(q, k, v, mk, mv, heads=HEADS)
    assert torch.isfinite(out).all()
    ref = la.folded_project_plain(q, la.folded_context_plain(k, v, mk, mv, HEADS), HEADS)
    _assert_close_to_plain(out, ref, atol_frac=3e-2, rtol=2e-2)


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v, mk, mv = _qkv(1, 256, cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        la.folded_context(k.half(), v.half(), mk.half(), mv.half(), HEADS)
    with pytest.raises(ValueError, match="float32"):
        la.folded_context(k.float(), v.float(), mk, mv, HEADS)  # memory tokens in bf16
    with pytest.raises(ValueError, match="heads"):
        la.folded_context(k, v, mk, mv, 3)
    with pytest.raises(ValueError, match="multiples of 8"):
        la.folded_context(k, v, mk, mv, 32)  # d = 4
    every_other = torch.zeros(1, 256, 2 * WIDTH, device=cuda, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        la.folded_project(every_other, torch.zeros(1, WIDTH, WIDTH, device=cuda), HEADS)
    with pytest.raises(ValueError, match="ctx"):
        la.folded_project(q, torch.zeros(1, WIDTH, WIDTH, device=cuda, dtype=torch.bfloat16), HEADS)


def _linear_attention_16cubed(device, dtype):
    """A LinearAttention block (hidden 128) with seeded weights, and a 16³ input."""
    gen = torch.Generator(device=device).manual_seed(0)
    attn = LinearAttention(16, heads=HEADS, dim_head=WIDTH // HEADS, device=device)
    for m in attn.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    x = torch.randn(1, 16, 16, 16, 16, generator=gen, device=device)
    return attn, x.to(dtype)


@pytest.mark.gpu
def test_linear_attention_f32_on_cuda_raises_instead_of_taking_einsum(cuda):
    """4096 tokens and hidden 128 on CUDA take the folded kernels whatever the
    dtype: f32 launches them (the general path), and so does a head of 256,
    wider than 128, instead of the block running einsum; it agrees with the
    einsum form up to the kernels' bf16 roundings of p, v and ctx."""
    attn, x = _linear_attention_16cubed(cuda, torch.float32)
    la.reset_launch_counts()
    with torch.inference_mode():
        out = attn(x)
    assert la.launch_counts == _launched(folded_context=1, folded_project=1)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    wide = LinearAttention(16, heads=1, dim_head=256, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for m in wide.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    la.reset_launch_counts()
    with torch.inference_mode():
        out = wide(x)
        wide.fused_folded = False
        ref = wide(x)  # einsum
    assert la.launch_counts == _launched(folded_context=1, folded_project=1)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert _rel_l2(out, ref) <= 1e-2


@pytest.mark.gpu
def test_linear_attention_bf16_on_cuda_launches_the_kernels(cuda):
    attn, x = _linear_attention_16cubed(cuda, torch.bfloat16)
    la.reset_launch_counts()
    with torch.inference_mode():
        out = attn(x)
    assert la.launch_counts == _launched(folded_context=1, folded_project=1)
    assert out.shape == x.shape and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# K3 and the backwards (on the card)
# ---------------------------------------------------------------------------
def _attention_operands(batch, n, m, device, seed=0, heads=4, d=32, q_scale=1.0):
    """q as a column slice of a [B, N, 3, h, d] bf16 projection (as the UNet hands
    it over); k and v contiguous [B, M, h, d] bf16 (the memory concatenation)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(batch, n, 3, heads, d, generator=gen, device=device)
    qkv[:, :, 0] *= q_scale
    k = torch.randn(batch, m, heads, d, generator=gen, device=device)
    v = torch.randn(batch, m, heads, d, generator=gen, device=device)
    return qkv.to(torch.bfloat16)[:, :, 0], k.to(torch.bfloat16), v.to(torch.bfloat16)


def assert_flash_close(out, lse, want_out, want_lse):
    """The rule chip_smoke.py holds K3 to: out within 1e-3·RMS + one bf16 ulp
    (2^-7·|plain|) elementwise and 4e-3 in relative L2; lse within
    1e-4 + 1e-5·|plain|. The plain version computes in f32; the kernel's scores
    are exact bf16 products summed in f32 and its p enters p·v as two bf16
    terms (p_hi + p_lo, near f32), so the two differ in the order of the sums
    and by about 2^-16 in p, then round out to bf16."""
    got, want = out.float(), want_out.float()
    rms = want.square().mean().sqrt().item()
    torch.testing.assert_close(got, want, rtol=2.0**-7, atol=1e-3 * rms)
    assert ((got - want).norm() / want.norm()).item() <= 4e-3
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n,m,d,q_scale", [
    (4, 4096, 4100, 32, 1.0),       # the fa16 stage, training batch
    (1, 1024 + 37, 1024 + 41, 32, 1.0),   # ragged queries and keys
    (2, 4096, 4100, 32, 8.0),       # peaked softmax
    (1, 300, 260, 64, 1.0),         # the UNet's default head width
    # the bf16 tensor-core path: d padded to 16 in the k-steps, fewer keys than
    # one 64-key tile, and M = N + 4 whose last tile holds 4 real keys
    *((2, 1024 + 37, 1024 + 41, d, 1.0) for d in (8, 24, 40, 64, 128)),
    (3, 5, 9, 32, 1.0),
    (1, 4096, 4100, 32, 1.0),
])
def test_flash_kernel_matches_plain_version(cuda, batch, n, m, d, q_scale):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _attention_operands(batch, n, m, cuda, seed=n + d, d=d, q_scale=q_scale)
    fa.reset_launch_counts()
    out, lse = fa.flash_attention_forward(q, k, v)
    want_out, want_lse = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.launch_counts == {"flash_attention": 1}
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and out.is_contiguous()
    assert lse.shape == (batch, 4, n) and lse.dtype == torch.float32
    assert_flash_close(out, lse, want_out, want_lse)


@pytest.mark.gpu
def test_flash_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v = _attention_operands(1, 64, 68, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_forward(q.float(), k, v)
    wq, wk, wv = _attention_operands(1, 64, 68, cuda, seed=1, d=136)  # wider than 128: runs
    fa.reset_launch_counts()
    out, lse = fa.flash_attention_forward(wq, wk, wv)
    assert fa.launch_counts == {"flash_attention": 1}
    assert_flash_close(out, lse, *fa.flash_attention_plain(wq, wk, wv))
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.flash_attention_forward(q[..., :12], k[..., :12], v[..., :12])
    every_other = torch.zeros(1, 64, 4, 64, device=cuda, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_forward(every_other, k, v)


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.gpu
def test_flash_backward_bf16_matches_autograd_of_the_f32_plain_version(cuda):
    """16³ b1: 4096 queries, 4100 keys (4 memory tokens), 4 heads × 32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _attention_operands(1, 4096, 4100, cuda, seed=3)
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(4),
                       device=cuda).to(torch.bfloat16)
    ours = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*ours).backward(dout)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_plain(*ref)[0].backward(dout.float())
    for a, b in zip(ours, ref):
        assert a.grad.dtype == torch.bfloat16
        assert _rel_l2(a.grad, b.grad) <= 2e-2


@pytest.mark.gpu
def test_folded_backward_bf16_matches_autograd_of_the_f32_reference(cuda):
    """16³ b1: K1 + K2 forward, closed_form_bf16 backward, against autograd of
    the f32 einsum composition on the same bf16 inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mk, mv = _qkv(1, 4096, cuda, seed=6)
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(7),
                       device=cuda).to(torch.bfloat16)
    ours = [t.detach().clone().requires_grad_() for t in (q, k, v, mk, mv)]
    la.reset_launch_counts()
    la.linear_attention_folded(*ours, heads=HEADS).backward(dout)
    assert la.launch_counts == _launched(folded_context=1, folded_project=1)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v, mk, mv)]
    _einsum_reference(*ref).backward(dout.float())
    for a, b in zip(ours, ref):
        assert a.grad.dtype == torch.bfloat16
        assert _rel_l2(a.grad, b.grad) <= 2e-2


# ---------------------------------------------------------------------------
# The widened K1/K2/K3 and the v1 kernels K4a/K4b (on the card)
# ---------------------------------------------------------------------------
def _folded_operands(batch, n, heads, d, device, seed=0, dtype=torch.bfloat16):
    """q, k, v as column slices of one [B, N, 3·h·d] tensor, and memory KV [4, h·d]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    hd = heads * d
    qkv = torch.randn(batch, n, 3 * hd, generator=gen, device=device).to(dtype)
    mem = torch.randn(2, 4, hd, generator=gen, device=device).to(dtype)
    return qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:], mem[0].contiguous(), mem[1].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d,dtype", [
    (8, 32, torch.bfloat16), (4, 64, torch.bfloat16), (2, 64, torch.bfloat16),
    (4, 32, torch.float32),
])
def test_widened_folded_kernels_match_plain_versions(cuda, heads, d, dtype):
    """The general path of K1 and K2 at b2 × 32,768 + 37 tokens, held to the
    specialisation's tolerances."""
    q, k, v, mk, mv = _folded_operands(2, 32768 + 37, heads, d, cuda, seed=heads * d, dtype=dtype)
    la.reset_launch_counts()
    ctx = la.folded_context(k, v, mk, mv, heads)
    ctx_plain = la.folded_context_plain(k, v, mk, mv, heads)
    out = la.folded_project(q, ctx_plain, heads)
    out_plain = la.folded_project_plain(q, ctx_plain, heads)
    torch.cuda.synchronize()
    assert la.launch_counts == _launched(folded_context=1, folded_project=1)
    assert out.dtype == dtype and ctx.dtype == torch.float32
    head = torch.arange(heads * d, device=cuda) // d
    assert torch.count_nonzero(ctx[:, head[:, None] != head[None, :]]) == 0
    _assert_close_to_plain(ctx, ctx_plain, atol_frac=3e-2, rtol=1e-2)
    _assert_close_to_plain(out, out_plain, atol_frac=3e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype", [
    (8, torch.bfloat16), (16, torch.bfloat16), (48, torch.bfloat16), (128, torch.bfloat16),
    (32, torch.float32),
])
def test_widened_flash_kernel_matches_plain_version(cuda, d, dtype):
    """K3 at b2 × 4096 queries × 4100 keys for every head-width bucket and f32."""
    q, k, v = _attention_operands(2, 4096, 4100, cuda, seed=d, d=d)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    fa.reset_launch_counts()
    out, lse = fa.flash_attention_forward(q, k, v)
    want_out, want_lse = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.launch_counts == {"flash_attention": 1}
    assert out.dtype == dtype and out.shape == q.shape
    assert_flash_close(out, lse, want_out, want_lse)


def _v1_operands(batch, n, heads, d, device, seed=0, dtype=torch.bfloat16, k_scale=1.0,
                 mem_shift=0.0, contiguous=False):
    """q as a slice of a [B, N, 3, h, d] projection (contiguous with
    ``contiguous``), and k, v [B, 4 + N, h, d] with 4 memory tokens first
    (shifted up by ``mem_shift`` in k)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(batch, n, 3, heads, d, generator=gen, device=device)
    qkv[:, :, 1] *= k_scale
    mem = torch.randn(2, 4, heads, d, generator=gen, device=device)
    mem[0] += mem_shift
    qkv, mem = qkv.to(dtype), mem.to(dtype)
    cat = lambda i: torch.cat([mem[i].expand(batch, -1, -1, -1), qkv[:, :, i + 1]], dim=1)
    q = qkv[:, :, 0]
    return q.contiguous() if contiguous else q, cat(0), cat(1)


def _assert_v1_close(got, want):
    """K4a and K4b against their plain versions: the plain versions compute in
    f32; the kernels compute in f32 (the general path) or take each f32
    product through bf16 terms within 2^-16 of it (3·2^-16 for K4b; 4 x 32
    bf16), and differ in the order of the sums and in the range max, so one
    bf16 ulp (2^-7·|plain|) plus 1e-3·RMS elementwise and 4e-3 in relative L2."""
    got, want = got.float(), want.float()
    rms = want.square().mean().sqrt().item()
    torch.testing.assert_close(got, want, rtol=2.0**-7, atol=1e-3 * rms)
    assert _rel_l2(got, want) <= 4e-3


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n,heads,d,dtype,options", [
    (2, 32768, 4, 32, torch.bfloat16, {}),                     # the 32³ stage
    (1, 32768 + 37, 4, 32, torch.bfloat16, {}),                # ragged
    (1, 32768, 4, 32, torch.bfloat16, dict(k_scale=8.0)),      # peaked column max
    (1, 32768, 4, 32, torch.bfloat16, dict(mem_shift=12.0)),   # memory tokens dominate
    (1, 32768, 4, 32, torch.float32, {}),
    (1, 4096 + 37, 2, 8, torch.bfloat16, {}),
    (1, 4096 + 37, 2, 48, torch.bfloat16, {}),
    (1, 4096 + 37, 2, 64, torch.bfloat16, {}),
    (1, 4096 + 37, 1, 128, torch.float32, {}),
])
def test_v1_kernels_match_plain_versions(cuda, batch, n, heads, d, dtype, options):
    """The 4 x 32 bf16 kernels where the shape and dtype take them, else the
    general path (f32, other heads or widths)."""
    q, k, v = _v1_operands(batch, n, heads, d, cuda, seed=n + d, dtype=dtype, **options)
    specialised = dtype == torch.bfloat16 and (heads, d) == (4, 32)
    assert la._v1_specialised(k, v) == la._v1_specialised(q) == specialised
    la.reset_launch_counts()
    ctx = la.linear_context(k, v)
    ctx_plain = la.linear_context_plain(k, v)
    out = la.linear_project(q, ctx_plain)
    out_plain = la.linear_project_plain(q, ctx_plain)
    torch.cuda.synchronize()
    assert la.launch_counts == _launched(linear_context=1, linear_project=1)
    assert ctx.shape == (batch, heads, d, d) and ctx.dtype == torch.float32
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
    _assert_v1_close(ctx, ctx_plain)
    _assert_v1_close(out, out_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n,contiguous", [
    (1, 1, False), (8, 1, False),    # M = 5: one query token and the memory tokens
    (1, 32768 + 37, False),          # ragged, batch 1
    (8, 32768, True),                # q contiguous beside the projection's slice
    (2, 4096 + 37, True),
])
def test_v1_4x32_kernels_match_plain_versions_and_repeat(cuda, batch, n, contiguous):
    """K4a and K4b on 4 x 32 bf16 heads at their edges, each launched twice
    with bit-identical outputs (a fixed order of sums, no atomics)."""
    q, k, v = _v1_operands(batch, n, 4, 32, cuda, seed=n + batch, contiguous=contiguous)
    assert la._v1_specialised(k, v) and la._v1_specialised(q)
    la.reset_launch_counts()
    ctx, ctx_again = la.linear_context(k, v), la.linear_context(k, v)
    ctx_plain = la.linear_context_plain(k, v)
    out, out_again = la.linear_project(q, ctx_plain), la.linear_project(q, ctx_plain)
    torch.cuda.synchronize()
    assert la.launch_counts == _launched(linear_context=2, linear_project=2)
    assert ctx.shape == (batch, 4, 32, 32) and out.shape == q.shape and out.is_contiguous()
    assert torch.equal(ctx, ctx_again) and torch.equal(out, out_again)
    _assert_v1_close(ctx, ctx_plain)
    _assert_v1_close(out, la.linear_project_plain(q, ctx_plain))


@pytest.mark.gpu
def test_every_wrapper_raises_past_a_head_width_of_128(cuda):
    """Past 128 a head width must still be a multiple of 8: d = 132 raises in
    every wrapper (the [B, N, h, d] wrappers refuse its rows, which are not
    16-byte aligned, first). d = 136, a multiple of 8, runs in every wrapper
    and matches its plain version (the widths wider still: the test below)."""
    q, k, v = _v1_operands(1, 64, 1, 132, cuda)
    refused = "multiples of 8|16-byte aligned"
    with pytest.raises(ValueError, match=refused):
        la.linear_context(k, v)
    with pytest.raises(ValueError, match=refused):
        la.linear_project(q, torch.zeros(1, 1, 132, 132, device=cuda))
    with pytest.raises(ValueError, match=refused):
        fa.flash_attention_forward(q, k, v)
    fq, fk, fv, mk, mv = _folded_operands(1, 64, 32, 132, cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        la.folded_context(fk, fv, mk, mv, 32)
    with pytest.raises(ValueError, match="multiples of 8"):
        la.folded_project(fq, torch.zeros(1, 4224, 4224, device=cuda), 32)
    q, k, v = _v1_operands(1, 64, 1, 136, cuda)
    ctx_plain = la.linear_context_plain(k, v)
    _assert_v1_close(la.linear_context(k, v), ctx_plain)
    _assert_v1_close(la.linear_project(q, ctx_plain), la.linear_project_plain(q, ctx_plain))
    assert_flash_close(*fa.flash_attention_forward(q, k, v), *fa.flash_attention_plain(q, k, v))
    fq, fk, fv, mk, mv = _folded_operands(1, 64, 16, 136, cuda)
    ctx_plain = la.folded_context_plain(fk, fv, mk, mv, 16)
    _assert_close_to_plain(la.folded_context(fk, fv, mk, mv, 16), ctx_plain, atol_frac=3e-2,
                           rtol=1e-2)
    _assert_close_to_plain(la.folded_project(fq, ctx_plain, 16),
                           la.folded_project_plain(fq, ctx_plain, 16), atol_frac=3e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [136, 256, 512])
def test_wide_head_kernels_match_plain_versions(cuda, d, dtype):
    """K1-K4b past a head width of 128 (in column tiles of 128): K1 and K2 at
    4096 + 37 tokens (16 heads at d = 136, the fewest whose h·d is a multiple
    of 128; else 1), K4a and K4b at 2 heads, K3 at 1024 + 37 queries x 1024 +
    41 keys; each held to its kernel's tolerance."""
    heads = 16 if d == 136 else 1
    q, k, v, mk, mv = _folded_operands(1, 4096 + 37, heads, d, cuda, seed=d, dtype=dtype)
    la.reset_launch_counts()
    ctx = la.folded_context(k, v, mk, mv, heads)
    ctx_plain = la.folded_context_plain(k, v, mk, mv, heads)
    out = la.folded_project(q, ctx_plain, heads)
    torch.cuda.synchronize()
    head = torch.arange(heads * d, device=cuda) // d
    assert torch.count_nonzero(ctx[:, head[:, None] != head[None, :]]) == 0
    _assert_close_to_plain(ctx, ctx_plain, atol_frac=3e-2, rtol=1e-2)
    _assert_close_to_plain(out, la.folded_project_plain(q, ctx_plain, heads), atol_frac=3e-2,
                           rtol=2e-2)
    q, k, v = _v1_operands(1, 4096 + 37, 2, d, cuda, seed=d + 1, dtype=dtype)
    ctx = la.linear_context(k, v)
    ctx_plain = la.linear_context_plain(k, v)
    out = la.linear_project(q, ctx_plain)
    torch.cuda.synchronize()
    assert la.launch_counts == _launched(folded_context=1, folded_project=1, linear_context=1,
                                         linear_project=1)
    assert out.dtype == dtype and ctx.shape == (1, 2, d, d)
    _assert_v1_close(ctx, ctx_plain)
    _assert_v1_close(out, la.linear_project_plain(q, ctx_plain))
    q, k, v = _attention_operands(1, 1024 + 37, 1024 + 41, cuda, seed=d + 2, heads=2, d=d)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    fa.reset_launch_counts()
    out, lse = fa.flash_attention_forward(q, k, v)
    assert fa.launch_counts == {"flash_attention": 1}
    assert out.dtype == dtype and out.shape == q.shape
    assert_flash_close(out, lse, *fa.flash_attention_plain(q, k, v))


@pytest.mark.gpu
def test_v1_backward_bf16_matches_autograd_of_the_f32_plain_version(cuda):
    """32³ b1: K4a + K4b forward, the closed-form backward, against autograd of
    the f32 plain composition on the same bf16 inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _v1_operands(1, 32768, 4, 32, cuda, seed=8)
    dout = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(9),
                       device=cuda).to(torch.bfloat16)
    ours = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    la.reset_launch_counts()
    la.linear_attention(*ours).backward(dout)
    assert la.launch_counts == _launched(linear_context=1, linear_project=1)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    la.linear_attention_reference(*ref).backward(dout.float())
    for a, b in zip(ours, ref):
        assert a.grad.dtype == torch.bfloat16
        assert _rel_l2(a.grad, b.grad) <= 2e-2


@pytest.mark.gpu
def test_linear_attention_fused_on_cuda_launches_the_v1_kernels(cuda):
    """32³ = 32,768 tokens, 4 heads × 32, bf16: the v1 dispatch, one K4a and
    one K4b per forward, within 1e-2 relative L2 of the folded form."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    v1 = LinearAttention(48, fused=True, fused_folded=False, dtype=torch.bfloat16, device=cuda)
    for m in v1.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    folded = LinearAttention(48, dtype=torch.bfloat16, device=cuda)
    folded.load_state_dict(v1.state_dict())
    x = torch.randn(1, 32, 32, 32, 48, generator=gen, device=cuda).to(torch.bfloat16)
    la.reset_launch_counts()
    with torch.inference_mode():
        out = v1(x)
    assert la.launch_counts == _launched(linear_context=1, linear_project=1)
    with torch.inference_mode():
        ref = folded(x)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert _rel_l2(out, ref) <= 1e-2


# ---------------------------------------------------------------------------
# The tap-folded conv K5a, K5b and its VJP, and the GEMM probes P1 and P2 (on the card)
# ---------------------------------------------------------------------------
def _conv_operands(batch, spatial, cin, cout, device, seed=0, dtype=torch.bfloat16):
    """x [B, X, Y, Z, Cin] and w [3, 3, 3, Cin, Cout] in ``dtype`` (w scaled by
    (27 Cin)^-1/2, as the JAX tool's), b [Cout] f32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(batch, *spatial, cin, generator=gen, device=device).to(dtype)
    w = (torch.randn(3, 3, 3, cin, cout, generator=gen, device=device) * (27 * cin) ** -0.5)
    b = torch.randn(cout, generator=gen, device=device) * 0.1
    return x, w.to(dtype), b


def _assert_ulp_close(got, want, dtype):
    """One rounding to ``dtype`` apart, where both sides sum exact products in f32
    in another order: within one bf16 ulp (2^-7·|plain|) plus 1e-3·RMS for bf16,
    1e-5·|plain| plus 1e-5·RMS for f32."""
    got, want = got.float(), want.float()
    rms = want.square().mean().sqrt().item()
    rtol, atol = (2.0**-7, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-5)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol * rms)


def _conv_reference(x, w, b):
    """autograd-able f32 ``F.conv3d`` (TF32 off) on the channels-last layout."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b, padding=1)
    return y.permute(0, 2, 3, 4, 1)


# K5a's box path on a non-cubic volume at batch 2, whose box columns meet every
# face (Z = 24 is one and a half boxes of 16) and the batch boundary; then the
# shapes that the C entry point sends to the tile kernel on the same volume:
# the 18-channel input conv and its data gradient, and f32
BOX_VOLUME = (2, (8, 16, 24))
BOX_FORWARD_CASES = (
    *((*BOX_VOLUME, cin, cout, torch.bfloat16) for cin in (8, 48, 96) for cout in (8, 48, 96, 128)),
    (*BOX_VOLUME, 18, 48, torch.bfloat16),
    (*BOX_VOLUME, 48, 18, torch.bfloat16),
    (*BOX_VOLUME, 48, 48, torch.float32),
)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,spatial,cin,cout,dtype", [
    (2, (8, 8, 8), 5, 7, torch.float32),           # odd channels, one element at a time
    (2, (16, 8, 16), 3, 4, torch.float32),
    (1, (16, 16, 16), 48, 48, torch.float32),
    (2, (16, 16, 16), 48, 48, torch.bfloat16),      # the flagship's width
    (1, (16, 16, 16), 18, 48, torch.bfloat16),      # ragged K = 486
    (1, (8, 16, 8), 96, 96, torch.bfloat16),
    (1, (8, 8, 8), 48, 256, torch.bfloat16),       # the data gradient's widest output
    *BOX_FORWARD_CASES,
])
def test_tap_conv_forward_matches_plain_version(cuda, batch, spatial, cin, cout, dtype):
    """Against the plain version and F.conv3d, and the same on a second call."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, b = _conv_operands(batch, spatial, cin, cout, cuda, seed=cin + cout, dtype=dtype)
    tc.reset_launch_counts()
    out = tc.tap_conv_forward(x, w, b)
    again = tc.tap_conv_forward(x, w, b)
    want = tc.tap_conv_forward_plain(x, w, b)
    torch.cuda.synchronize()
    assert tc.launch_counts == {"tap_conv_forward": 2, "tap_conv_weight_grad": 0}
    assert out.dtype == dtype and out.shape == (batch, *spatial, cout)
    assert torch.equal(out, again)
    _assert_ulp_close(out, want, dtype)
    ref = _conv_reference(x.float(), w.float(), b)
    assert _rel_l2(out, ref) <= (1e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,spatial,cin,cout,dtype", [
    (2, (8, 8, 8), 5, 7, torch.float32),
    (2, (16, 16, 16), 48, 48, torch.bfloat16),
    (1, (16, 16, 16), 18, 48, torch.bfloat16),
    (1, (16, 8, 8), 96, 128, torch.float32),
    # the bf16 box path on a non-cubic volume at batch 2: boxes meet every face
    # (Z = 24 is one and a half boxes of 16) and the batch boundary, which must
    # contribute nothing; then f32 with a ragged Cin, which the C entry point
    # sends to the chunked kernel
    *((2, (8, 16, 24), cin, cout, torch.bfloat16) for cin in (8, 96) for cout in (8, 48, 128)),
    (2, (8, 16, 24), 18, 48, torch.float32),
])
def test_tap_conv_weight_grad_matches_plain_version(cuda, batch, spatial, cin, cout, dtype):
    """dw in f32 on both sides, the sums over voxels in another order: 1e-4·|plain|
    plus 1e-4·RMS, and the same on a second call (no atomics)."""
    x, _, _ = _conv_operands(batch, spatial, cin, cout, cuda, seed=cin, dtype=dtype)
    g, _, _ = _conv_operands(batch, spatial, cout, 1, cuda, seed=cout + 1, dtype=dtype)
    tc.reset_launch_counts()
    dw = tc.tap_conv_weight_grad(x, g)
    again = tc.tap_conv_weight_grad(x, g)
    want = tc.tap_conv_weight_grad_plain(x, g)
    torch.cuda.synchronize()
    assert tc.launch_counts == {"tap_conv_forward": 0, "tap_conv_weight_grad": 2}
    assert dw.dtype == torch.float32 and dw.shape == (3, 3, 3, cin, cout)
    assert torch.equal(dw, again)
    rms = want.square().mean().sqrt().item()
    torch.testing.assert_close(dw, want, rtol=1e-4, atol=1e-4 * rms)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tap_conv3d_vjp_matches_autograd_of_f32_conv(cuda, dtype):
    """The custom VJP: one K5a forward, then one K5a (dx) and one K5b (dw) launch;
    dx, dw and db against the plain backward and against autograd of the f32
    F.conv3d on the same inputs."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, b = _conv_operands(2, (16, 16, 16), 48, 48, cuda, seed=3, dtype=dtype)
    g = torch.randn(2, 16, 16, 16, 48, generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda).to(dtype)
    ours = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    tc.reset_launch_counts()
    tc.tap_conv3d(*ours).backward(g)
    assert tc.launch_counts == {"tap_conv_forward": 2, "tap_conv_weight_grad": 1}
    w_flip = torch.flip(w, (0, 1, 2)).transpose(3, 4)
    plain = (tc.tap_conv_forward_plain(g, w_flip).to(dtype),
             tc.tap_conv_weight_grad_plain(x, g).to(dtype),
             g.sum(dim=(0, 1, 2, 3), dtype=torch.float32).to(dtype).float())
    ref = [t.detach().float().requires_grad_() for t in (x, w, b)]
    _conv_reference(*ref).backward(g.float())
    limit = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for got, want, r in zip(ours, plain, ref):
        assert got.grad.dtype == got.dtype
        _assert_ulp_close(got.grad, want, dtype)
        assert _rel_l2(got.grad, r.grad) <= limit


@pytest.mark.gpu
def test_tap_conv_wrappers_raise_instead_of_falling_back(cuda):
    x, w, b = _conv_operands(1, (8, 8, 8), 8, 8, cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tc.tap_conv_forward(x.half(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        tc.tap_conv_forward(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="output channels"):
        tc.tap_conv_forward(x, torch.zeros(3, 3, 3, 8, 264, device=cuda), None)
    with pytest.raises(ValueError, match="multiples of 8"):
        tc.tap_conv3d(x[:, :4], w, b)


def _probe_operands(m, k, n, device, seed=0, grid=None):
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (m, k) if grid is None else (grid, m + gp.WINDOW_PAD, k)
    a = torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)
    b = (torch.randn(k, n, generator=gen, device=device) * 0.02).to(torch.bfloat16)
    return a, b


# P1 at the tools' M plus a ragged last tile of 37 rows: the streaming path at
# K in {1296, 144} (a ragged last K slice of 16) and N in {8, 48, 128}, then a
# K that is not a multiple of 8, which the C entry point sends to gemm_p1
PROBE_M = 524288 + 37


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [
    (1000, 1296, 48), (4096, 144, 128), (300, 100, 37),
    *((PROBE_M, k, n) for k in (1296, 144) for n in (8, 48, 128)),
    (PROBE_M, 100, 48),
])
def test_gemm_probe_matches_plain_version(cuda, m, k, n):
    """Both layouts against their plain versions, and the same on a second call."""
    a, b = _probe_operands(m, k, n, cuda, seed=k)
    bt = b.T.contiguous()
    gp.reset_launch_counts()
    out, out_t = gp.gemm_probe(a, b), gp.gemm_probe_t(a, bt)
    again, again_t = gp.gemm_probe(a, b), gp.gemm_probe_t(a, bt)
    torch.cuda.synchronize()
    assert gp.launch_counts == {"gemm_probe": 2, "gemm_probe_t": 2, "mma_probe": 0}
    assert out.shape == (m, n) and out_t.shape == (n, m) and out.dtype == torch.bfloat16
    assert torch.equal(out, again) and torch.equal(out_t, again_t)
    _assert_ulp_close(out, gp.gemm_probe_plain(a, b), torch.bfloat16)
    _assert_ulp_close(out_t, gp.gemm_probe_t_plain(a, bt), torch.bfloat16)


# P2 at the window path's edges, (m_block, K, N, grid, R), as chip_smoke.py's
# P2_EDGE_CASES: m_block under one 64-row tile, ragged against it and 2048 + 37;
# K 48, 1296 (a last 64-k slice of 16) and 1600; N 8 to 1296, 130 a ragged
# column tile; R from one product to 256, with passes of fewer than 8 windows
# and a round short of 32 or one past it. K = 100 takes the block-tile kernel.
P2_EDGES = [
    (16, 48, 48, 2, 40), (200, 432, 130, 3, 40), (2048, 1296, 48, 2, 40),
    (16, 48, 48, 2, 1), (200, 1296, 40, 3, 7), (2048 + 37, 1296, 48, 2, 31),
    (200, 100, 48, 2, 32), (16, 1600, 64, 2, 33), (200, 1600, 130, 2, 40),
    (2048 + 37, 144, 8, 2, 256), (512, 48, 1296, 2, 40), (200, 432, 128, 3, 256),
    (2048 + 37, 1296, 64, 2, 40),
]


@pytest.mark.gpu
@pytest.mark.parametrize("m_block,k,n,grid,reps", P2_EDGES)
def test_mma_probe_matches_plain_version(cuda, m_block, k, n, grid, reps):
    """R products per grid step against the plain version, and the same output on
    a second launch (the max over grid steps lands by atomics, in any order)."""
    a, b = _probe_operands(m_block, k, n, cuda, seed=m_block, grid=grid)
    gp.reset_launch_counts()
    out, again = gp.mma_probe(a, b, reps), gp.mma_probe(a, b, reps)
    torch.cuda.synchronize()
    assert gp.launch_counts == {"gemm_probe": 0, "gemm_probe_t": 0, "mma_probe": 2}
    assert out.shape == (m_block, n) and out.dtype == torch.bfloat16
    assert torch.equal(out, again)
    _assert_ulp_close(out, gp.mma_probe_plain(a, b, reps), torch.bfloat16)


@pytest.mark.gpu
def test_mma_probe_slope_rate_stays_under_the_peak(cuda):
    """The max is idempotent, so a kernel that skipped or repeated products would
    give the same output: the rate of the products between R = 256 and 32, at each
    of the tool's ten cases, must stay at or under the card's 989 TF/s."""
    for case in bms.CASES:
        tflops, _ = bms.probe(*case, device=cuda)
        assert 0 < tflops <= 989.0, (case, tflops)
