"""Flash attention: kernel K3 forward, its plain version, and the blockwise backward.

Port of ``flowtrain_stochastic_interpolation_tpu/ops/flash_attention.py``.
Non-causal softmax attention with scale ``d^-½`` on ``[B, N, h, d]`` queries
and ``[B, M, h, d]`` keys and values (the caller concatenates the memory
tokens into k and v):

* K3, the forward (:func:`flash_attention_forward`): ``out`` in q's dtype and
  ``lse = logsumexp(s)`` in f32 ``[B, h, N]``. The kernel takes bf16 or f32
  operands and every head width d that is a multiple of 8. bf16 at d <= 128
  runs on the tensor cores: scores as exact bf16 products summed in f32, the
  softmax in f32, and p passed to p·v as two bf16 terms, p_hi + p_lo (about
  2^-16 of p, near the TPU kernel's f32 p). f32 operands, and any d > 128 (in
  128-wide tiles of the output columns), compute every score, probability and
  product in f32 on the FP32 cores, as ``_fa_kernel`` does. The plain version
  is all f32.
* The backward (:func:`flash_attention_backward`): recomputation from ``lse``
  over blocks of 256 queries, in f32, as ``_bwd_blockwise`` does (an XLA scan
  in the JAX package, torch operations here on the card and the CPU alike).
* :func:`flash_attention`: both as a ``torch.autograd.Function``.

The forward wrapper takes the plain PyTorch version for tensors on the CPU,
and only then. For CUDA tensors it launches the hand-written kernel in
``csrc/flash_attention.cu`` (built by :mod:`.cuda_build`), or raises: there is
no fallback. :data:`launch_counts` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from flowtrain_stochastic_interpolation_torch.ops import cuda_build

SOURCE = "flash_attention"
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
BLOCK_Q = 256                    # queries per block of the backward (JAX's default block_q)

launch_counts: Dict[str, int] = {"flash_attention": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """``[B, N, h, d]`` -> f32 ``[B, h, N, d]``."""
    return t.float().transpose(1, 2)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------
def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 in plain PyTorch: ``out [B, N, h, d]`` in q's dtype and f32 ``lse [B, h, N]``."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(_heads_first(q), _heads_first(k).transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.matmul(p, _heads_first(v)).transpose(1, 2).to(q.dtype)
    return out, lse


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------
@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE).library
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.flash_attention_forward.argtypes = [
        vp, vp, vp, ll, ll, ll, ll, ll, ll, ll, ll, ll, vp, vp,
        i32, i32, i32, i32, i32, i32, ctypes.c_float, vp,
    ]
    lib.flash_attention_forward.restype = i32
    return lib


def check_head_dim(d: int) -> None:
    """The head widths the CUDA kernels take: every multiple of 8."""
    if d % 8 or d < 8:
        raise ValueError(f"the CUDA kernels take head widths d that are multiples of 8, got d = {d}")


def _check_operand(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """A bf16 or f32 CUDA ``[B, *, h, d]`` tensor of q's dtype whose d-wide rows
    are contiguous and 16-byte aligned; batch, tokens and heads may sit at any
    stride that is a multiple of 8."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q on {like.device}")
    if t.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name} must be bfloat16 or float32, got {t.dtype}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} is {t.dtype}, q {like.dtype}")
    if t.ndim != 4:
        raise ValueError(f"{name} must be [B, tokens, heads, d], got {tuple(t.shape)}")
    if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
            or t.data_ptr() % 16):
        raise ValueError(
            f"{name} rows must be contiguous and 16-byte aligned "
            f"(strides {t.stride()}, address {t.data_ptr()})"
        )


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: ``(out [B, N, h, d] in q's dtype, lse [B, h, N] f32)``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA or CPU tensor, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)
    b, n, h, d = q.shape
    m = k.shape[1]
    check_head_dim(d)
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must be [{b}, M, {h}, {d}]"
        )
    if m < 1:
        raise ValueError("k must hold at least one token")
    lib = _library()
    with torch.cuda.device(q.device):
        out = torch.empty(b, n, h, d, dtype=q.dtype, device=q.device)
        lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device)
        if n == 0:
            return out, lse
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.data_ptr(), lse.data_ptr(), b, h, n, m, d, int(q.dtype == torch.float32),
            d**-0.5, stream,
        )
    if code != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {code}")
    launch_counts["flash_attention"] += 1
    return out, lse


# ---------------------------------------------------------------------------
# Backward: blockwise recomputation from lse
# ---------------------------------------------------------------------------
def flash_attention_backward(q, k, v, out, lse, dout, block_q: int = BLOCK_Q):
    """``(dq, dk, dv)`` in the inputs' dtypes, over blocks of ``block_q`` queries.

    f32 throughout, as ``_bwd_blockwise``: the scores are recomputed in f32,
    ``p = exp(s - lse)``, ``δ = rowsum(dO·O)``, and dk, dv accumulate in f32
    over the query blocks.
    """
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (_heads_first(t) for t in (q, k, v, out, dout))
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for i in range(0, qf.shape[2], block_q):
        rows = slice(i, i + block_q)
        q_i, o_i, do_i = qf[:, :, rows], of[:, :, rows], dof[:, :, rows]
        s = torch.matmul(q_i, kf.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[:, :, rows, None])                  # [B, h, bq, M]
        dv += torch.matmul(p.transpose(-1, -2), do_i)
        dp = torch.matmul(do_i, vf.transpose(-1, -2))
        delta = (do_i * o_i).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta) * scale
        dq[:, :, rows] = torch.matmul(ds, kf)
        dk += torch.matmul(ds.transpose(-1, -2), q_i)
    back = lambda g, like: g.transpose(1, 2).to(like.dtype)
    return back(dq, q), back(dk, k), back(dv, v)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_forward(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_backward(q, k, v, out, lse, dout)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable flash attention on ``[B, N, h, d]`` q and ``[B, M, h, d]`` k/v.

    Returns ``[B, N, h, d]`` in q's dtype; the softmax scale is ``d^-½``.
    """
    return _FlashAttention.apply(q, k, v)
