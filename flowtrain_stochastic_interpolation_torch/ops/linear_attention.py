"""Head-folded linear attention, forward: kernels K1 and K2 with their plain versions.

Port of the folded path of ``flowtrain_stochastic_interpolation_tpu/ops/
linear_attention.py`` (``linear_attention_folded``). On ``[B, N, h·d]``
tensors with ``h·d = 128``:

* K1, the context (``folded_context``): ``ctx = blockdiag(softmax over tokens
  of [mem_k; k])ᵀ · [mem_v; v]``, f32 ``[B, 128, 128]`` with zeros off the
  head-diagonal blocks. p and v are rounded to bf16 in the product and
  accumulated in f32; the memory tokens enter in f32.
* K2, the projection (``folded_project``): ``out = groupsoftmax(q) · d^-½ @
  ctx`` with a per-head max, p and ctx rounded to bf16, f32 accumulation,
  output in q's dtype.
* The backward: the JAX package's closed forms (``_folded_vjp_bwd_closed_form``
  and ``_folded_vjp_bwd_closed_form_bf16``), plain XLA there and torch
  operations here; :func:`linear_attention_folded` is a
  ``torch.autograd.Function`` over K1 + K2 and them.

Each wrapper takes its plain PyTorch version for tensors on the CPU, and only
then. For CUDA tensors it launches the hand-written kernel in
``csrc/linear_attention.cu`` (built by :mod:`.cuda_build`), or raises: there
is no fallback. :data:`launch_counts` counts the kernel launches, one per
wrapper call that launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from flowtrain_stochastic_interpolation_torch.ops import cuda_build

SOURCE = "linear_attention"
_FOLDED_WIDTH = 128   # h·d the kernels take
_KERNEL_HEADS = 4     # heads the kernels take (d = 32)
_K2_ROWS = 32         # rows per tile of the projection kernel (K2_ROWS in the source)

launch_counts: Dict[str, int] = {"folded_context": 0, "folded_project": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# Plain versions: the same functions with the same bf16 roundings
# ---------------------------------------------------------------------------
def _diag_blocks(ctx: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, h·d, h·d] -> the per-head diagonal blocks [B, h, d, d]."""
    d = ctx.shape[-1] // heads
    return torch.stack(
        [ctx[:, i * d:(i + 1) * d, i * d:(i + 1) * d] for i in range(heads)], dim=1
    )


def folded_context_plain(k: torch.Tensor, v: torch.Tensor, mem_k: torch.Tensor,
                         mem_v: torch.Tensor, heads: int) -> torch.Tensor:
    """K1 in plain PyTorch: f32 ctx ``[B, h·d, h·d]``, zero off the head diagonal."""
    b, m, hd = k.shape
    d = hd // heads
    kf, mk, mv = k.float(), mem_k.float(), mem_v.float()
    col_max = torch.maximum(kf.amax(dim=1), mk.amax(dim=0))     # [B, hd]
    p = torch.exp(kf - col_max[:, None])                        # [B, m, hd]
    p0 = torch.exp(mk[None] - col_max[:, None])                 # [B, n_mem, hd]
    col_sum = p.sum(dim=1) + p0.sum(dim=1)
    pb = p.to(torch.bfloat16).float().view(b, m, heads, d)
    vb = v.to(torch.bfloat16).float().view(b, m, heads, d)
    blocks = torch.einsum("bnhd,bnhe->bhde", pb, vb) + torch.einsum(
        "bjhd,jhe->bhde", p0.view(b, -1, heads, d), mv.view(-1, heads, d)
    )
    blocks = blocks / col_sum.view(b, heads, d, 1)
    ctx = torch.zeros(b, hd, hd, dtype=torch.float32, device=k.device)
    for i in range(heads):
        ctx[:, i * d:(i + 1) * d, i * d:(i + 1) * d] = blocks[:, i]
    return ctx


def folded_project_plain(q: torch.Tensor, ctx: torch.Tensor, heads: int) -> torch.Tensor:
    """K2 in plain PyTorch: ``[B, N, h·d]`` in q's dtype."""
    b, n, hd = q.shape
    d = hd // heads
    qf = q.float().view(b, n, heads, d)
    e = torch.exp(qf - qf.amax(dim=-1, keepdim=True))  # per-head shift
    p = ((e / e.sum(dim=-1, keepdim=True)) * d**-0.5).to(torch.bfloat16).float()
    blocks = _diag_blocks(ctx, heads).to(torch.bfloat16).float()
    out = torch.einsum("bnhd,bhde->bnhe", p, blocks)
    return out.reshape(b, n, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE).library
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.folded_context_forward.argtypes = [
        vp, vp, ll, ll, ll, ll, vp, vp, i32, i32, i32, i32, vp, vp, vp, vp, vp,
    ]
    lib.folded_context_forward.restype = i32
    lib.folded_project_forward.argtypes = [
        vp, ll, ll, vp, vp, i32, i32, i32, ctypes.c_float, vp,
    ]
    lib.folded_project_forward.restype = i32
    return lib


def _check_rows(name: str, t: torch.Tensor) -> None:
    """A bf16 CUDA ``[B, N, 128]`` tensor whose 128-wide rows are contiguous and
    16-byte aligned; tokens and batch items may sit at any stride."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if t.ndim != 3 or t.shape[-1] != _FOLDED_WIDTH:
        raise ValueError(f"{name} must be [B, N, {_FOLDED_WIDTH}], got {tuple(t.shape)}")
    if t.stride(-1) != 1 or t.stride(1) % 8 or t.stride(0) % 8 or t.data_ptr() % 16:
        raise ValueError(
            f"{name} rows must be contiguous and 16-byte aligned "
            f"(strides {t.stride()}, address {t.data_ptr()})"
        )


def _check_heads(heads: int) -> None:
    if heads != _KERNEL_HEADS:
        raise ValueError(f"the CUDA kernels take {_KERNEL_HEADS} heads of 32, got {heads}")


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def _context_chunk(batch: int, n: int, device: torch.device) -> int:
    """Tokens per partial block of K1: 1024, halved until the grid covers the SMs twice."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunk = 1024
    while chunk > 128 and batch * -(-n // chunk) < 2 * sms:
        chunk //= 2
    return chunk


def folded_context(k: torch.Tensor, v: torch.Tensor, mem_k: torch.Tensor,
                   mem_v: torch.Tensor, heads: int) -> torch.Tensor:
    """K1: the f32 context ``[B, h·d, h·d]`` of keys ``k`` and values ``v``."""
    if k.device.type == "cpu":
        return folded_context_plain(k, v, mem_k, mem_v, heads)
    _check_heads(heads)
    _check_rows("k", k)
    _check_rows("v", v)
    if v.shape != k.shape or v.device != k.device:
        raise ValueError(f"v {tuple(v.shape)} on {v.device} must match k {tuple(k.shape)} on {k.device}")
    for name, mem in (("mem_k", mem_k), ("mem_v", mem_v)):
        if (mem.device != k.device or mem.dtype != torch.bfloat16 or mem.ndim != 2
                or mem.shape[1] != _FOLDED_WIDTH or mem.shape[0] < 1
                or not mem.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous bf16 [n_mem >= 1, {_FOLDED_WIDTH}] tensor "
                f"on {k.device}, got {tuple(mem.shape)} {mem.dtype} on {mem.device}"
            )
    if mem_v.shape != mem_k.shape:
        raise ValueError("mem_k and mem_v must have the same shape")
    b, n, hd = k.shape
    if n < 1:
        raise ValueError("k must hold at least one token")
    lib = _library()
    with torch.cuda.device(k.device):
        chunk = _context_chunk(b, n, k.device)
        n_chunks = -(-n // chunk)
        f32 = dict(dtype=torch.float32, device=k.device)
        part_m = torch.empty(b, n_chunks, hd, **f32)
        part_s = torch.empty(b, n_chunks, hd, **f32)
        part_ctx = torch.empty(b, n_chunks, heads, hd // heads, hd // heads, **f32)
        ctx = torch.empty(b, hd, hd, **f32)
        stream = torch.cuda.current_stream(k.device).cuda_stream
        code = lib.folded_context_forward(
            k.data_ptr(), v.data_ptr(), k.stride(1), v.stride(1), k.stride(0), v.stride(0),
            mem_k.data_ptr(), mem_v.data_ptr(), mem_k.shape[0], b, n, chunk,
            part_m.data_ptr(), part_s.data_ptr(), part_ctx.data_ptr(), ctx.data_ptr(), stream,
        )
    _raise_on(code, "folded_context")
    launch_counts["folded_context"] += 1
    return ctx


def folded_project(q: torch.Tensor, ctx: torch.Tensor, heads: int) -> torch.Tensor:
    """K2: ``groupsoftmax(q) · d^-½ @ ctx`` as ``[B, N, h·d]`` in q's dtype."""
    if q.device.type == "cpu":
        return folded_project_plain(q, ctx, heads)
    _check_heads(heads)
    _check_rows("q", q)
    b, n, hd = q.shape
    if (ctx.device != q.device or ctx.dtype != torch.float32
            or tuple(ctx.shape) != (b, hd, hd) or not ctx.is_contiguous()):
        raise ValueError(
            f"ctx must be a contiguous f32 [{b}, {hd}, {hd}] tensor on {q.device}, "
            f"got {tuple(ctx.shape)} {ctx.dtype} on {ctx.device}"
        )
    lib = _library()
    with torch.cuda.device(q.device):
        out = torch.empty(b, n, hd, dtype=q.dtype, device=q.device)
        if n == 0:
            return out
        n_tiles = -(-n // _K2_ROWS)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        grid_x = min(n_tiles, max(1, 8 * sms // b))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.folded_project_forward(
            q.data_ptr(), q.stride(1), q.stride(0), ctx.data_ptr(), out.data_ptr(),
            b, n, grid_x, (hd // heads) ** -0.5, stream,
        )
    _raise_on(code, "folded_project")
    launch_counts["folded_project"] += 1
    return out


# ---------------------------------------------------------------------------
# Backward: the closed forms, as torch operations
# ---------------------------------------------------------------------------
# Above this many rows per item the JAX package hands the backward to its
# row-chunked form (``_CHUNKED_BWD_MIN_ROWS``), which is not ported yet
# (ROADMAP Queue 1, the 128³ memory forms).
CHUNKED_BWD_MIN_ROWS = 1 << 20
BACKWARDS = ("closed_form_bf16", "closed_form")
_UNPORTED_BACKWARDS = ("chunked", "autodiff")


def _group_ones(hd: int, heads: int, device) -> torch.Tensor:
    """``[h·d, h·d]`` block-diagonal ones: 1 where row and column share a head."""
    group = torch.arange(hd, device=device) // (hd // heads)
    return (group[:, None] == group[None, :]).float()


def folded_backward_closed_form(q, k, v, mem_k, mem_v, dout, heads: int):
    """``(dq, dk, dv, dmk, dmv)``: ``_folded_vjp_bwd_closed_form``, every stream in f32."""
    b, n, hd = q.shape
    d = hd // heads
    scale = d**-0.5
    qf, kf, vf, do = (t.float() for t in (q, k, v, dout))
    mkf, mvf = mem_k.float(), mem_v.float()
    g = _group_ones(hd, heads, q.device)

    # recompute the forward's pieces: q group softmax with a per-head shift,
    # k column softmax over [mem; tokens] without the concatenation
    m_q = qf.view(b, n, heads, d).amax(dim=-1, keepdim=True)
    e_q = torch.exp(qf - m_q.expand(b, n, heads, d).reshape(b, n, hd))
    s_q = e_q / torch.matmul(e_q, g)
    big_m = torch.maximum(kf.amax(dim=1), mkf.amax(dim=0)[None])      # [b, hd]
    ek = torch.exp(kf - big_m[:, None])
    em = torch.exp(mkf[None] - big_m[:, None])                         # [b, n_mem, hd]
    z = ek.sum(dim=1) + em.sum(dim=1)
    p_k = ek / z[:, None]
    p_m = em / z[:, None]
    ctx = (torch.matmul(p_k.transpose(1, 2), vf)
           + torch.matmul(p_m.transpose(1, 2), mvf)) * g

    d_s = scale * torch.matmul(do, ctx.transpose(1, 2))
    dq = s_q * (d_s - torch.matmul(d_s * s_q, g))
    d_ctx = scale * torch.matmul(s_q.transpose(1, 2), do) * g
    dv = torch.matmul(p_k, d_ctx)
    dmv = torch.matmul(p_m, d_ctx).sum(dim=0)
    d_pk = torch.matmul(vf, d_ctx.transpose(1, 2))
    d_pm = torch.matmul(mvf, d_ctx.transpose(1, 2))                   # [b, n_mem, hd]
    inner = (d_pk * p_k).sum(dim=1) + (d_pm * p_m).sum(dim=1)         # [b, hd]
    dk = p_k * (d_pk - inner[:, None])
    dmk = (p_m * (d_pm - inner[:, None])).sum(dim=0)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dmk.to(mem_k.dtype), dmv.to(mem_v.dtype))


def folded_backward_closed_form_bf16(q, k, v, mem_k, mem_v, dout, heads: int):
    """``(dq, dk, dv, dmk, dmv)``: ``_folded_vjp_bwd_closed_form_bf16``.

    The ``[N, h·d]`` streams stay in the input dtype (bf16 on the card); the
    softmax stabilisers, normalisers, the column inner product and every
    ``[b, h·d]`` / ``[b, h·d, h·d]`` reduction are f32 (a reduction of bf16
    streams upcasts them, so its products are exact and it sums in f32); the
    cancelling subtraction of dk runs in f32. With f32 inputs it is the f32
    closed form up to the order of the sums.
    """
    b, n, hd = q.shape
    d = hd // heads
    scale = d**-0.5
    cdt = q.dtype
    f32 = torch.float32
    g = _group_ones(hd, heads, q.device)

    q4 = q.reshape(b, n, heads, d)
    e4 = torch.exp((q4 - q4.amax(dim=-1, keepdim=True)).float())
    s_q = (e4 / e4.sum(dim=-1, keepdim=True)).to(cdt).reshape(b, n, hd)

    mkf = mem_k.float()
    big_m = torch.maximum(k.amax(dim=1).float(), mkf.amax(dim=0)[None])
    ekb = torch.exp(k.float() - big_m[:, None]).to(cdt)              # [b, n, hd]
    em = torch.exp(mkf[None] - big_m[:, None])                         # [b, n_mem, hd] f32
    z = ekb.sum(dim=1, dtype=f32) + em.sum(dim=1)
    p_m = em / z[:, None]

    # the context and its cotangent, with 1/Z folded into the small tensors
    ctx = (torch.matmul(ekb.transpose(1, 2).float(), v.float()) / z[:, :, None]
           + torch.matmul(p_m.transpose(1, 2), mem_v.float())) * g
    d_ctx = scale * torch.matmul(s_q.transpose(1, 2).float(), dout.float()) * g
    d_ctx_over_z = d_ctx / z[:, :, None]

    d_s = scale * torch.matmul(dout.to(cdt), ctx.transpose(1, 2).to(cdt))
    ss4 = (d_s * s_q).view(b, n, heads, d)
    corr = ss4.float().sum(dim=-1, keepdim=True).to(cdt)
    dq = s_q * (d_s - corr.expand(b, n, heads, d).reshape(b, n, hd))

    dv = torch.matmul(ekb, d_ctx_over_z.to(cdt))
    dmv = torch.matmul(p_m, d_ctx).sum(dim=0)
    d_pk = torch.matmul(v.to(cdt), d_ctx_over_z.transpose(1, 2).to(cdt))
    d_pm = torch.matmul(mem_v.float(), d_ctx.transpose(1, 2))         # [b, n_mem, hd]
    inner = (ekb * d_pk).float().sum(dim=1) + (d_pm * p_m).sum(dim=1)
    dk = ekb.float() * (d_pk.float() - (inner / z)[:, None])
    dmk = (p_m * (d_pm - inner[:, None])).sum(dim=0)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dmk.to(mem_k.dtype), dmv.to(mem_v.dtype))


_BACKWARD_FNS = {
    "closed_form_bf16": folded_backward_closed_form_bf16,
    "closed_form": folded_backward_closed_form,
}


class _LinearAttentionFolded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mem_k, mem_v, heads, backward):
        ctx.heads, ctx.backward = heads, backward
        ctx.save_for_backward(q, k, v, mem_k, mem_v)
        return folded_project(q, folded_context(k, v, mem_k, mem_v, heads), heads)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mem_k, mem_v = ctx.saved_tensors
        grads = _BACKWARD_FNS[ctx.backward](q, k, v, mem_k, mem_v, dout, ctx.heads)
        return (*grads, None, None)


def linear_attention_folded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mem_k: torch.Tensor, mem_v: torch.Tensor, *,
                            heads: int, backward: Optional[str] = None) -> torch.Tensor:
    """Linear attention on head-folded ``[B, N, h·d]`` tensors, differentiable.

    ``mem_k``/``mem_v`` are the ``[n_mem, h·d]`` memory-KV tokens, folded the
    same way and shared across the batch. ``h·d`` must be a multiple of 128.
    The forward is K1 + K2. ``backward`` picks the closed form of the
    gradient: ``"closed_form_bf16"`` (the default, ``None``) or
    ``"closed_form"``. The JAX package's ``"chunked"`` and ``"autodiff"``
    forms, and any backward at 2^20 or more rows per item, are not ported:
    asking for a gradient through them raises ``NotImplementedError``.
    """
    hd = q.shape[-1]
    if hd % 128 != 0:
        raise ValueError(f"folded head dim {hd} must be a multiple of 128")
    if backward is None:
        backward = "closed_form_bf16"
    if backward not in BACKWARDS + _UNPORTED_BACKWARDS:
        raise ValueError(f"unknown backward {backward!r}")
    tensors = (q, k, v, mem_k, mem_v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if backward in _UNPORTED_BACKWARDS or q.shape[1] >= CHUNKED_BWD_MIN_ROWS:
            raise NotImplementedError(
                f"the {backward!r} folded backward at {q.shape[1]} rows per item is not "
                "ported: the port has the one-shot closed forms below 2^20 rows "
                "(ROADMAP Queue 1, the 128³ memory forms: the chunked folded backward)"
            )
    return _LinearAttentionFolded.apply(q, k, v, mem_k, mem_v, heads, backward)
