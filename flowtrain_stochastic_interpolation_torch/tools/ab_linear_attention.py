"""The design of the 4 x 32 bf16 linear-attention kernels on the card:
variants of the folded K1 (``folded_context_partial`` + the combine) and K2
(``folded_project``), and of the v1 K4a (``linear_context_partial`` + the
combine) and K4b (``linear_project_tiles``), in ``csrc/linear_attention.cu``,
timed in turns beside the kernels as they stand.

Each variant is the source with a few lines substituted, built by its own
``nvcc`` call into ``_build/`` and launched through the same C entry points,
as the wrappers launch them. K1 and K4a share their body, and so do K2 and
K4b, so a variant changes each pair; each kernel's time is its own.

* FP32 cores (before): K1 and K2 as they ran before the tensor cores and the
  TMA (``tools/fp32_cores_folded.cu``, appended to the source); K4a and K4b
  as they still run at other shapes, the general path (``context_forward``,
  ``project_forward``) at the same shape.
* Ring depth: 4 stages for K1 and K4a (one block per SM), 2 for K2 and 3 for
  K4b (one block per SM: its two copies of ctx leave no room for a second).
* No exponentials, no products, and loads only (K1 and K4a take their tiles
  and release them; K2 and K4b copy each q tile to the output): wrong on
  purpose, what the exponentials, the products and the stream itself cost.
* bf16 p alone (K4a and K4b): p rounded to bf16 in the products, as K1 and K2
  round it, so without p_lo·v (K4a) or p_lo·c_hi (K4b): what keeping p's f32
  accuracy costs; wrong on purpose.

K1 and K2 at b8 x {262,144, 32,768, 4,096} tokens (the 64³, 32³ and 16³
stages), q, k and v column slices of one [B, N, 384] projection; K4a and K4b
at b8 x {262,144, 32,768} queries, q a column slice of the [B, N, 3, 4, 32]
projection and k, v the [B, 4 + N, 4, 32] concatenations with the memory
tokens first, as ``LinearAttention``'s v1 path hands them over. The variants
that keep the numerics are held to ``chip_smoke.py``'s tolerances against
the plain versions: 3e-2·RMS + 1e-2·|plain| (K1) or 2e-2·|plain| (K2)
elementwise and 1e-2 in relative L2; 1e-3·RMS + 2^-7·|plain| and 4e-3 (K4a,
K4b). Order A B ... B A; each time is the least of 5, after 2 warm-ups, of 10
back-to-back launches.

    python -m flowtrain_stochastic_interpolation_torch.tools.ab_linear_attention
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_torch.tools import variants
from flowtrain_stochastic_interpolation_torch.tools.timing import best_ms, device_line
from flowtrain_stochastic_interpolation_torch.tools.variants import Substitutions

CALLS = 10
BATCH = 8
TOKENS = (262144, 32768, 4096)
V1_TOKENS = (262144, 32768)
HEADS, WIDTH, N_MEM = 4, 128, 4
D = WIDTH // HEADS
BEFORE = "FP32 cores (before)"
ALL, V1 = ("K1", "K2", "K4a", "K4b"), ("K4a", "K4b")

_END = '}  // extern "C"\n'
_BASELINE = Path(__file__).with_name("fp32_cores_folded.cu")
# name -> (substitutions, whether the outputs are held to the plain versions,
# the kernels it is timed for)
VARIANTS: Dict[str, Tuple[Substitutions, bool, Tuple[str, ...]]] = {
    BEFORE: ([(_END, _END + "\n" + _BASELINE.read_text())], True, ALL),
    "4 stages (K1, K4a), 2 (K2), 3 (K4b)": (
        [("CTX_TILE = 64, CTX_STAGES = 3;", "CTX_TILE = 64, CTX_STAGES = 4;"),
         ("PROJ_TILE = 16 * CONSUMERS, PROJ_STAGES = 3;",
          "PROJ_TILE = 16 * CONSUMERS, PROJ_STAGES = 2;"),
         ("V1_PROJ_STAGES = 2;", "V1_PROJ_STAGES = 3;")],
        True, ALL),
    "no exponentials (wrong)": (
        [("const float p0 = exp2_approx(fmaf(x[ks][i][0], LOG2E, -shift[i & 1]));",
          "const float p0 = fmaf(x[ks][i][0], LOG2E, -shift[i & 1]);"),
         ("const float p1 = exp2_approx(fmaf(x[ks][i][1], LOG2E, -shift[i & 1]));",
          "const float p1 = fmaf(x[ks][i][1], LOG2E, -shift[i & 1]);"),
         ("x[ks][i][e] = exp2_approx(fmaf(x[ks][i][e], LOG2E, -shift[i & 1]));",
          "x[ks][i][e] = fmaf(x[ks][i][e], LOG2E, -shift[i & 1]);")],
        False, ALL),
    "no products (wrong)": (
        [(line, "") for line in (
            "        mma(acc[2 * p], a[ks], bv[0], bv[1]);\n",
            "        mma(acc[2 * p + 1], a[ks], bv[2], bv[3]);\n",
            "          mma(acc[2 * p], lo[ks], bv[0], bv[1]);\n",
            "          mma(acc[2 * p + 1], lo[ks], bv[2], bv[3]);\n",
            "          mma(acc[2 * p], a[ks], bc[0], bc[1]);\n",
            "          mma(acc[2 * p + 1], a[ks], bc[2], bc[3]);\n",
            "            mma(acc[2 * p], lo[ks], bc[0], bc[1]);\n",
            "            mma(acc[2 * p + 1], lo[ks], bc[2], bc[3]);\n",
            "            mma(acc[2 * p], a[ks], cl[0], cl[1]);\n",
            "            mma(acc[2 * p + 1], a[ks], cl[2], cl[3]);\n")],
        False, ALL),
    "loads only (wrong)": (
        [("    mbar_wait(&full[j], (s / CTX_STAGES) & 1);  // tile s has landed\n",
          "    mbar_wait(&full[j], (s / CTX_STAGES) & 1);  // tile s has landed\n"
          "    { __syncwarp(); if (lane == 0) mbar_arrive(&empty[j]); continue; }\n"),
         ("    for (int h = 0; h < NH; ++h) {", "    for (int h = 0; h < 0; ++h) {")],
        False, ALL),
    "bf16 p alone (wrong)": (
        [(line, "") for line in (
            "          mma(acc[2 * p], lo[ks], bv[0], bv[1]);\n",
            "          mma(acc[2 * p + 1], lo[ks], bv[2], bv[3]);\n",
            "            mma(acc[2 * p], lo[ks], bc[0], bc[1]);\n",
            "            mma(acc[2 * p + 1], lo[ks], bc[2], bc[3]);\n")],
        False, V1),
}


def _bind(lib: ctypes.CDLL) -> None:
    ref = la._library()
    for name in ("folded_context_slots", "folded_context_forward", "folded_project_forward",
                 "linear_context_slots", "linear_context_forward", "linear_project_forward",
                 "context_forward", "project_forward"):
        fn, want = getattr(lib, name), getattr(ref, name)
        fn.argtypes, fn.restype = want.argtypes, want.restype
    if hasattr(lib, "fp32_folded_context_forward"):
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.fp32_folded_context_forward.argtypes = [
            vp, vp, ll, ll, ll, ll, vp, vp, i32, i32, i32, i32, vp, vp, vp, vp, vp]
        lib.fp32_folded_context_forward.restype = i32
        lib.fp32_folded_project_forward.argtypes = [
            vp, ll, ll, vp, vp, i32, i32, i32, ctypes.c_float, vp]
        lib.fp32_folded_project_forward.restype = i32


def _raise_on(code: int) -> None:
    if code != 0:
        raise RuntimeError(f"launch failed: CUDA error {code}")


def context_launch(lib: ctypes.CDLL, k, v, mk, mv, before: bool = False) -> torch.Tensor:
    """K1 through a library's C entry points, as the wrapper launches it (the
    FP32-core kernels with the chunks their wrapper chose)."""
    b, n, hd = k.shape
    stream = torch.cuda.current_stream(k.device).cuda_stream
    if before:
        slots = -(-n // la._context_chunk(b, n, k.device))
    else:
        err = ctypes.c_int(0)
        slots = lib.folded_context_slots(b, n, ctypes.byref(err))
        _raise_on(err.value)
    stats = b * slots * hd
    part = torch.empty(2 * stats + b * slots * hd * hd // HEADS, dtype=torch.float32,
                       device=k.device)
    ctx = torch.empty(b, hd, hd, dtype=torch.float32, device=k.device)
    base = part.data_ptr()
    args = (k.data_ptr(), v.data_ptr(), k.stride(1), v.stride(1), k.stride(0), v.stride(0),
            mk.data_ptr(), mv.data_ptr(), mk.shape[0], b, n)
    scratch = (base, base + 4 * stats, base + 8 * stats, ctx.data_ptr(), stream)
    if before:
        _raise_on(lib.fp32_folded_context_forward(*args, la._context_chunk(b, n, k.device),
                                                  *scratch))
    else:
        _raise_on(lib.folded_context_forward(*args, *scratch))
    return ctx


def project_launch(lib: ctypes.CDLL, q, ctx, before: bool = False) -> torch.Tensor:
    """K2 through a library's C entry point, as the wrapper launches it."""
    b, n, hd = q.shape
    out = torch.empty(b, n, hd, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = (hd // HEADS) ** -0.5
    if before:
        grid_x = la._project_grid(n, 32, b, q.device)
        _raise_on(lib.fp32_folded_project_forward(q.data_ptr(), q.stride(1), q.stride(0),
                                                  ctx.data_ptr(), out.data_ptr(), b, n, grid_x,
                                                  scale, stream))
    else:
        _raise_on(lib.folded_project_forward(q.data_ptr(), q.stride(1), q.stride(0),
                                             ctx.data_ptr(), out.data_ptr(), b, n, scale, stream))
    return out


def v1_context_launch(lib: ctypes.CDLL, k, v, general: bool = False) -> torch.Tensor:
    """K4a through a library's C entry points, as the wrapper launches it: the
    4 x 32 kernels, or the general path at the chunks its wrapper chooses."""
    b, m = k.shape[:2]
    stream = torch.cuda.current_stream(k.device).cuda_stream
    ctx = torch.empty(b, HEADS, D, D, dtype=torch.float32, device=k.device)
    if general:
        chunk = la._context_chunk(b * HEADS, m, k.device)
        per_item = -(-m // chunk)
    else:
        err = ctypes.c_int(0)
        per_item = lib.linear_context_slots(b, m, ctypes.byref(err))
        _raise_on(err.value)
    # m, s and the blocks of each (batch, slot, head): [b, slots, 4, 32] and
    # [b, slots, 4, 32, 32] for the 4 x 32 kernels, [b·4, chunks, 32] and [b·4,
    # chunks, 32, 32] for the general path, the same sizes
    slots = b * HEADS * per_item
    part = torch.empty(slots * (2 * D + D * D), dtype=torch.float32, device=k.device)
    base = part.data_ptr()
    scratch = (base, base + 4 * slots * D, base + 8 * slots * D, ctx.data_ptr(), stream)
    if general:
        _raise_on(lib.context_forward(k.data_ptr(), v.data_ptr(), 0, *k.stride()[:3],
                                      *v.stride()[:3], None, None, 0, b, HEADS, D, m, chunk, 0,
                                      D, *scratch))
    else:
        _raise_on(lib.linear_context_forward(k.data_ptr(), v.data_ptr(), k.stride(1),
                                             v.stride(1), k.stride(0), v.stride(0), b, m,
                                             *scratch))
    return ctx


def v1_project_launch(lib: ctypes.CDLL, q, ctx, general: bool = False) -> torch.Tensor:
    """K4b through a library's C entry points, as the wrapper launches it."""
    b, n = q.shape[:2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if general:
        grid_x = la._project_grid(n, 4096 // D, b * HEADS, q.device)
        _raise_on(lib.project_forward(q.data_ptr(), 0, *q.stride()[:3], ctx.data_ptr(),
                                      HEADS * D * D, D * D, D, out.data_ptr(), b, HEADS, D, n,
                                      grid_x, 0, D**-0.5, stream))
    else:
        _raise_on(lib.linear_project_forward(q.data_ptr(), q.stride(1), q.stride(0),
                                             ctx.data_ptr(), out.data_ptr(), b, n, D**-0.5,
                                             stream))
    return out


# chip_smoke.py's tolerances: (atol as a fraction of the plain values' RMS, rtol, relative L2)
TOLERANCES = {"K1": (3e-2, 1e-2, 1e-2), "K2": (3e-2, 2e-2, 1e-2),
              "K4a": (1e-3, 2.0**-7, 4e-3), "K4b": (1e-3, 2.0**-7, 4e-3)}


def _check(name: str, got: torch.Tensor, want: torch.Tensor, kernel: str) -> None:
    """chip_smoke.py's rule for the kernel (RMS over the plain version's nonzero
    entries: K1's ctx is zero off the head-diagonal blocks)."""
    atol_frac, rtol, rel_l2 = TOLERANCES[kernel]
    got, want = got.float(), want.float()
    rms = want[want != 0].square().mean().sqrt().item()
    bad = int(((got - want).abs() > atol_frac * rms + rtol * want.abs()).sum())
    rel = ((got - want).norm() / want.norm()).item()
    if bad or rel > rel_l2:
        raise RuntimeError(f"{name}: {bad} values outside the tolerance, relative L2 {rel:.3e}")


def operands(batch: int, n: int, device):
    """q, k, v as column slices of one [B, N, 384] bf16 projection, and memory KV."""
    gen = torch.Generator(device=device).manual_seed(n)
    qkv = torch.randn(batch, n, 3 * WIDTH, generator=gen, device=device).to(torch.bfloat16)
    mem = torch.randn(2, N_MEM, WIDTH, generator=gen, device=device).to(torch.bfloat16)
    return (qkv[..., :WIDTH], qkv[..., WIDTH:2 * WIDTH], qkv[..., 2 * WIDTH:],
            mem[0].contiguous(), mem[1].contiguous())


def v1_operands(batch: int, n: int, device):
    """q a column slice of a [B, N, 3, 4, 32] bf16 projection; k, v [B, 4 + N,
    4, 32] with the memory tokens first."""
    gen = torch.Generator(device=device).manual_seed(n + 1)
    qkv = torch.randn(batch, n, 3, HEADS, D, generator=gen, device=device).to(torch.bfloat16)
    mem = torch.randn(2, N_MEM, HEADS, D, generator=gen, device=device).to(torch.bfloat16)
    cat = lambda i: torch.cat([mem[i].expand(batch, -1, -1, -1), qkv[:, :, i + 1]], dim=1)
    return qkv[:, :, 0], cat(0), cat(1)


def _ab(libs: Dict[str, ctypes.CDLL], runs, label: str) -> None:
    """Each run (kernel -> launch, plain output) through every library that the
    kernel's variants name, in the order A B ... B A, checked and timed."""
    for kernel, (launch, want) in runs.items():
        names = [name for name in libs if kernel in VARIANTS.get(name, ((), True, ALL))[2]]
        times: Dict[str, List[float]] = {}
        for name in [*names, *reversed(names)]:
            if VARIANTS.get(name, ((), True, ALL))[1]:
                _check(f"{kernel} {name}", launch(libs[name], name), want, kernel)
            times.setdefault(name, []).append(
                best_ms(lambda: launch(libs[name], name), CALLS) / CALLS)
        print(f"{kernel} {label}:", flush=True)
        for name, ms in times.items():
            print(f"    {name:38s} {ms[0]:.4f} / {ms[1]:.4f} ms", flush=True)


def main() -> None:
    device = resolve_device()
    print(device_line(), flush=True)
    libs = {"kernel": la._library(), **variants.build_variants(
        la.SOURCE, {name: subs for name, (subs, _, _) in VARIANTS.items()}, _bind)}
    for n in TOKENS:
        q, k, v, mk, mv = operands(BATCH, n, device)
        ctx_plain = la.folded_context_plain(k, v, mk, mv, HEADS)
        _ab(libs, {
            "K1": (lambda lib, name: context_launch(lib, k, v, mk, mv, name == BEFORE), ctx_plain),
            "K2": (lambda lib, name: project_launch(lib, q, ctx_plain, name == BEFORE),
                   la.folded_project_plain(q, ctx_plain, HEADS)),
        }, f"b{BATCH} x {n} x {HEADS} x {D} bf16")
        del q, k, v, mk, mv, ctx_plain
    for n in V1_TOKENS:
        q, k, v = v1_operands(BATCH, n, device)
        ctx_plain = la.linear_context_plain(k, v)
        _ab(libs, {
            "K4a": (lambda lib, name: v1_context_launch(lib, k, v, name == BEFORE), ctx_plain),
            "K4b": (lambda lib, name: v1_project_launch(lib, q, ctx_plain, name == BEFORE),
                    la.linear_project_plain(q, ctx_plain)),
        }, f"b{BATCH} x {n} q x {n + N_MEM} kv x {HEADS} x {D} bf16")
        del q, k, v, ctx_plain


if __name__ == "__main__":
    main()
