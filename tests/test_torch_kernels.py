"""The folded linear-attention kernels K1 and K2 and their plain versions.

Imports nothing of JAX, so it runs where JAX is not installed, with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``. Tests
marked ``gpu`` build and launch the CUDA kernels and skip where there is no
card; the rest run anywhere.
"""

import pytest
import torch

from flowtrain_stochastic_interpolation_torch.models.attention import LinearAttention
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
