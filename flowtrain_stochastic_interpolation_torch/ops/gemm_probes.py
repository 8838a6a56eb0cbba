"""The GEMM probes P1 and P2: bf16 products with f32 accumulation at the tap-folded
conv's implicit-GEMM shapes, their plain versions.

Port of the two probe kernels of the JAX package's tools:

* P1 (:func:`gemm_probe`, :func:`gemm_probe_t`), ``tools/bench_pallas_gemm.py``
  ``pallas_mm`` and ``pallas_mm_t``: ``out [M, N] = bf16(A [M, K] @ B [K, N])``,
  and the same product laid out transposed, ``out [N, M] = bf16(Bt [N, K] @
  A [M, K]ᵀ)``.
* P2 (:func:`mma_probe`), ``tools/bench_mxu_shapes.py`` ``_make_probe_kernel``:
  for ``A [grid, m_block + 256, K]`` and ``B [K, N]``, ``out [m_block, N] =
  bf16(max(0, max over g < grid, i < R of A[g, 8·(i mod 32) + m, :] · B))``,
  R products per grid step, each over a row window that slides by 8. The
  kernel computes all of them: the probe measures the product rate at (K, N).

They take bf16 only, as the TPU kernels. Each wrapper takes its plain PyTorch
version (the same products in f32 on the bf16 inputs, rounded to bf16) for
tensors on the CPU, and only then. For CUDA tensors it launches the
hand-written kernel in ``csrc/gemm_probes.cu`` (built by :mod:`.cuda_build`),
or raises: there is no fallback. :data:`launch_counts` counts the launches of
each layout of P1 and of P2.
The tools :mod:`..tools.bench_gemm` and :mod:`..tools.bench_mma_shapes` drive
them; no model calls them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from flowtrain_stochastic_interpolation_torch.ops import cuda_build

SOURCE = "gemm_probes"
WINDOW_PAD = 32 * 8   # rows of slide below each grid step's m_block rows of A
WINDOWS = 32          # distinct row windows: the i-th product uses window i mod 32
MAX_PROBE_K = 1600    # P2 keeps a [K, 64] tile of B in shared memory

launch_counts: Dict[str, int] = {"gemm_probe": 0, "gemm_probe_t": 0, "mma_probe": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def gemm_probe_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P1 in plain PyTorch: ``bf16(A @ B)``, ``[M, N]``."""
    return torch.matmul(a.float(), b.float()).to(torch.bfloat16)


def gemm_probe_t_plain(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """P1's transposed layout in plain PyTorch: ``bf16(Bt @ Aᵀ)``, ``[N, M]``."""
    return torch.matmul(bt.float(), a.float().T).to(torch.bfloat16)


def mma_probe_plain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """P2 in plain PyTorch: all ``reps`` window products, max-accumulated from 0."""
    m_block = a.shape[1] - WINDOW_PAD
    bf = b.float()
    best = torch.zeros(m_block, b.shape[1], dtype=torch.float32, device=a.device)
    for i in range(reps):
        off = 8 * (i % WINDOWS)
        product = torch.matmul(a[:, off:off + m_block].float(), bf)  # [grid, m_block, N]
        best = torch.maximum(best, product.amax(dim=0))
    return best.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE).library
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gemm_probe_forward.argtypes = [vp, vp, ll, ll, vp, ll, ll, i32, i32, i32, vp]
    lib.gemm_probe_forward.restype = i32
    lib.mma_probe_forward.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
    lib.mma_probe_forward.restype = i32
    return lib


def _check(name: str, t: torch.Tensor, ndim: int, device: torch.device) -> None:
    """A contiguous, 16-byte aligned bf16 CUDA tensor of rank ``ndim`` on ``device``."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if t.ndim != ndim or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"{name} must be a contiguous, 16-byte aligned {ndim}-D tensor, got "
            f"{tuple(t.shape)} with strides {t.stride()}"
        )


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def _gemm(a: torch.Tensor, b: torch.Tensor, transposed: bool) -> torch.Tensor:
    """P1 on the card: ``b`` is B [K, N], or Bt [N, K] for the transposed layout."""
    _check("a", a, 2, a.device)
    _check("bt" if transposed else "b", b, 2, a.device)
    m, k = a.shape
    n = b.shape[0] if transposed else b.shape[1]
    if (b.shape[1] if transposed else b.shape[0]) != k:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not share K")
    b_ks, b_ns = (1, k) if transposed else (n, 1)
    lib = _library()
    with torch.cuda.device(a.device):
        out = torch.empty((n, m) if transposed else (m, n), dtype=torch.bfloat16, device=a.device)
        if out.numel() == 0:
            return out
        o_ms, o_ns = (1, m) if transposed else (n, 1)
        code = lib.gemm_probe_forward(
            a.data_ptr(), b.data_ptr(), b_ks, b_ns, out.data_ptr(), o_ms, o_ns, m, n, k,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    name = "gemm_probe_t" if transposed else "gemm_probe"
    _raise_on(code, name)
    launch_counts[name] += 1
    return out


def gemm_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P1: ``bf16(A [M, K] @ B [K, N])`` as ``[M, N]``."""
    if a.device.type == "cpu":
        return gemm_probe_plain(a, b)
    return _gemm(a, b, transposed=False)


def gemm_probe_t(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """P1, transposed layout: ``bf16(Bt [N, K] @ A [M, K]ᵀ)`` as ``[N, M]``."""
    if a.device.type == "cpu":
        return gemm_probe_t_plain(a, bt)
    return _gemm(a, bt, transposed=True)


def mma_probe(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """P2: ``[m_block, N]`` bf16 from ``A [grid, m_block + 256, K]`` and ``B [K, N]``."""
    if a.device.type == "cpu":
        return mma_probe_plain(a, b, reps)
    _check("a", a, 3, a.device)
    _check("b", b, 2, a.device)
    grid, rows, k = a.shape
    m_block, n = rows - WINDOW_PAD, b.shape[1]
    if m_block < 1 or b.shape[0] != k or not 1 <= k <= MAX_PROBE_K or reps < 1 or n < 1:
        raise ValueError(
            f"a [grid, m_block + {WINDOW_PAD}, K] with K <= {MAX_PROBE_K}, b [K, N] and reps "
            f">= 1, got {tuple(a.shape)}, {tuple(b.shape)} and {reps}"
        )
    lib = _library()
    with torch.cuda.device(a.device):
        part = torch.empty(grid, m_block, n, dtype=torch.float32, device=a.device)
        out = torch.empty(m_block, n, dtype=torch.bfloat16, device=a.device)
        code = lib.mma_probe_forward(
            a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(), grid, m_block, k, n,
            reps, torch.cuda.current_stream(a.device).cuda_stream,
        )
    _raise_on(code, "mma_probe")
    launch_counts["mma_probe"] += 1
    return out
