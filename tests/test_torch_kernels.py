"""The kernels K1 and K2 (folded linear attention) and K3 (flash attention),
their plain versions, and the backwards that train through them.

Imports nothing of JAX, so it runs where JAX is not installed, with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``. Tests
marked ``gpu`` build and launch the CUDA kernels and skip where there is no
card; the rest run anywhere.
"""

import pytest
import torch

from flowtrain_stochastic_interpolation_torch.models.attention import LinearAttention
from flowtrain_stochastic_interpolation_torch.ops import flash_attention as fa
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la

HEADS, WIDTH = 4, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(batch, n, device, seed=0, dtype=torch.bfloat16):
    """q, k, v as column slices of one [B, N, 384] tensor, and memory KV [4, 128]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(batch, n, 3 * WIDTH, generator=gen, device=device).to(dtype)
    mem = torch.randn(2, 4, WIDTH, generator=gen, device=device).to(dtype)
    return (qkv[..., :WIDTH], qkv[..., WIDTH:2 * WIDTH], qkv[..., 2 * WIDTH:],
            mem[0].contiguous(), mem[1].contiguous())


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


# ---------------------------------------------------------------------------
# CUDA kernels (on the card)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("batch,n", [(2, 4096 + 37), (3, 8192), (1, 1)])
def test_kernels_match_plain_versions(cuda, batch, n):
    q, k, v, mk, mv = _qkv(batch, n, cuda, seed=n)
    la.reset_launch_counts()
    ctx = la.folded_context(k, v, mk, mv, HEADS)
    ctx_plain = la.folded_context_plain(k, v, mk, mv, HEADS)
    out = la.folded_project(q, ctx_plain, HEADS)
    out_plain = la.folded_project_plain(q, ctx_plain, HEADS)
    torch.cuda.synchronize()
    assert la.launch_counts == {"folded_context": 1, "folded_project": 1}
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
    with pytest.raises(ValueError, match="bfloat16"):
        la.folded_context(k.float(), v.float(), mk, mv, HEADS)
    with pytest.raises(ValueError, match="heads"):
        la.folded_context(k, v, mk, mv, 2)
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
    dtype; their wrappers raise on f32 rather than the block running einsum."""
    attn, x = _linear_attention_16cubed(cuda, torch.float32)
    la.reset_launch_counts()
    with torch.inference_mode(), pytest.raises(ValueError, match="bfloat16"):
        attn(x)
    assert la.launch_counts == {"folded_context": 0, "folded_project": 0}


@pytest.mark.gpu
def test_linear_attention_bf16_on_cuda_launches_the_kernels(cuda):
    attn, x = _linear_attention_16cubed(cuda, torch.bfloat16)
    la.reset_launch_counts()
    with torch.inference_mode():
        out = attn(x)
    assert la.launch_counts == {"folded_context": 1, "folded_project": 1}
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
    1e-4 + 1e-5·|plain|. Both sides compute in f32 and differ in the order of
    the sums, then round out to bf16."""
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
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_forward(q[..., :24], k[..., :24], v[..., :24])
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
    assert la.launch_counts == {"folded_context": 1, "folded_project": 1}
    ref = [t.detach().float().requires_grad_() for t in (q, k, v, mk, mv)]
    _einsum_reference(*ref).backward(dout.float())
    for a, b in zip(ours, ref):
        assert a.grad.dtype == torch.bfloat16
        assert _rel_l2(a.grad, b.grad) <= 2e-2
