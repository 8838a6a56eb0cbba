"""The seventh slice's design on the card: variants of the folded linear
attention's 4 x 32 bf16 kernels, K1 (``folded_context_partial`` + the combine)
and K2 (``folded_project``) in ``csrc/linear_attention.cu``, timed in turns
beside the kernels as they stand.

Each variant is the source with a few lines substituted, built by its own
``nvcc`` call into ``_build/`` and launched through the same C entry points,
as the wrappers launch them. A variant changes K1 and K2 both; each kernel's
time is its own.

* FP32 cores (before): the kernels as they ran before the tensor cores and
  the TMA (``tools/fp32_cores_folded.cu``, appended to the source).
* Ring depth: 4 stages for K1 (one block per SM) and 2 for K2.
* No exponentials, no products, and loads only (K1 takes its tiles and
  releases them; K2 copies each q tile to the output): wrong on purpose,
  what the exponentials, the products and the stream itself cost.

At b8 x {262,144, 32,768, 4,096} tokens (the 64³, 32³ and 16³ stages), q, k
and v column slices of one [B, N, 384] projection. The variants that keep
the numerics are held to ``chip_smoke.py``'s tolerances against the plain
versions: 3e-2·RMS + 1e-2·|plain| (K1) or 2e-2·|plain| (K2) elementwise and
1e-2 in relative L2. Order A B ... B A; each time is the least of 5, after 2
warm-ups, of 10 back-to-back launches.

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
HEADS, WIDTH, N_MEM = 4, 128, 4
BEFORE = "FP32 cores (before)"

_END = '}  // extern "C"\n'
_BASELINE = Path(__file__).with_name("fp32_cores_folded.cu")
# name -> (substitutions, whether the outputs are held to the plain versions)
VARIANTS: Dict[str, Tuple[Substitutions, bool]] = {
    BEFORE: ([(_END, _END + "\n" + _BASELINE.read_text())], True),
    "4 stages (K1), 2 stages (K2)": (
        [("CTX_TILE = 64, CTX_STAGES = 3;", "CTX_TILE = 64, CTX_STAGES = 4;"),
         ("PROJ_TILE = 16 * CONSUMERS, PROJ_STAGES = 3;",
          "PROJ_TILE = 16 * CONSUMERS, PROJ_STAGES = 2;")],
        True),
    "no exponentials (wrong)": (
        [("const float p0 = exp2_approx(fmaf(x[ks][i][0], LOG2E, -shift[i & 1]));",
          "const float p0 = fmaf(x[ks][i][0], LOG2E, -shift[i & 1]);"),
         ("const float p1 = exp2_approx(fmaf(x[ks][i][1], LOG2E, -shift[i & 1]));",
          "const float p1 = fmaf(x[ks][i][1], LOG2E, -shift[i & 1]);"),
         ("x[ks][i][e] = exp2_approx(fmaf(x[ks][i][e], LOG2E, -shift[i & 1]));",
          "x[ks][i][e] = fmaf(x[ks][i][e], LOG2E, -shift[i & 1]);")],
        False),
    "no products (wrong)": (
        [(line, "") for line in (
            "        mma(acc[2 * p], a[ks], bv[0], bv[1]);\n",
            "        mma(acc[2 * p + 1], a[ks], bv[2], bv[3]);\n",
            "          mma(acc[2 * p], a[ks], bc[0], bc[1]);\n",
            "          mma(acc[2 * p + 1], a[ks], bc[2], bc[3]);\n")],
        False),
    "loads only (wrong)": (
        [("    mbar_wait(&full[j], (s / CTX_STAGES) & 1);  // tile s has landed\n",
          "    mbar_wait(&full[j], (s / CTX_STAGES) & 1);  // tile s has landed\n"
          "    { __syncwarp(); if (lane == 0) mbar_arrive(&empty[j]); continue; }\n"),
         ("    for (int h = 0; h < NH; ++h) {", "    for (int h = 0; h < 0; ++h) {")],
        False),
}


def _bind(lib: ctypes.CDLL) -> None:
    ref = la._library()
    for name in ("folded_context_slots", "folded_context_forward", "folded_project_forward"):
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


def _check(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float) -> None:
    """chip_smoke.py's rule for K1 and K2 (RMS over the plain version's nonzero
    entries: K1's ctx is zero off the head-diagonal blocks)."""
    got, want = got.float(), want.float()
    rms = want[want != 0].square().mean().sqrt().item()
    bad = int(((got - want).abs() > 3e-2 * rms + rtol * want.abs()).sum())
    rel = ((got - want).norm() / want.norm()).item()
    if bad or rel > 1e-2:
        raise RuntimeError(f"{name}: {bad} values outside the tolerance, relative L2 {rel:.3e}")


def operands(batch: int, n: int, device):
    """q, k, v as column slices of one [B, N, 384] bf16 projection, and memory KV."""
    gen = torch.Generator(device=device).manual_seed(n)
    qkv = torch.randn(batch, n, 3 * WIDTH, generator=gen, device=device).to(torch.bfloat16)
    mem = torch.randn(2, N_MEM, WIDTH, generator=gen, device=device).to(torch.bfloat16)
    return (qkv[..., :WIDTH], qkv[..., WIDTH:2 * WIDTH], qkv[..., 2 * WIDTH:],
            mem[0].contiguous(), mem[1].contiguous())


def main() -> None:
    device = resolve_device()
    print(device_line(), flush=True)
    libs = {"kernel": la._library(), **variants.build_variants(
        la.SOURCE, {name: subs for name, (subs, _) in VARIANTS.items()}, _bind)}
    order: List[str] = [*libs, *reversed(libs)]
    for n in TOKENS:
        q, k, v, mk, mv = operands(BATCH, n, device)
        ctx_plain = la.folded_context_plain(k, v, mk, mv, HEADS)
        out_plain = la.folded_project_plain(q, ctx_plain, HEADS)
        runs = {
            "K1": (lambda lib, name: context_launch(lib, k, v, mk, mv, name == BEFORE),
                   ctx_plain, 1e-2),
            "K2": (lambda lib, name: project_launch(lib, q, ctx_plain, name == BEFORE),
                   out_plain, 2e-2),
        }
        for kernel, (launch, want, rtol) in runs.items():
            times: Dict[str, List[float]] = {}
            for name in order:
                if VARIANTS.get(name, ((), True))[1]:
                    _check(f"{kernel} {name}", launch(libs[name], name), want, rtol)
                times.setdefault(name, []).append(
                    best_ms(lambda: launch(libs[name], name), CALLS) / CALLS)
            print(f"{kernel} b{BATCH} x {n} x {HEADS} x {WIDTH // HEADS} bf16:", flush=True)
            for name, ms in times.items():
                print(f"    {name:34s} {ms[0]:.4f} / {ms[1]:.4f} ms", flush=True)
        del q, k, v, mk, mv, ctx_plain, out_plain


if __name__ == "__main__":
    main()
