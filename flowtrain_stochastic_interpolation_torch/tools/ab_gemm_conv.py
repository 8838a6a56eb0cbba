"""Design choices on the card: variants of P1's streaming kernel and P2's
window path (``csrc/gemm_probes.cu``) and of K5a's box kernel
(``csrc/tap_conv.cu``) timed in turns beside the kernels as they stand and,
where there is one, beside one PyTorch call.

Each variant is the source with a few lines substituted, built by its own
``nvcc`` call into ``_build/`` and launched through the same C entry point.

* P1 at 524,288 x 1296 x {48, 128}, both layouts, beside ``torch.matmul`` in
  the same layout: 128-row tiles with 4 consumer warps (the tiles before
  160); a ring of 4 stages (one block per SM at N = 48, where 3 leave room
  for two); no products (wrong on purpose: the floor that A's loads set).
* P2 at (2048, 1296, 48, 16) and (2048, 144, 48, 64) with R = 256: the old
  block-tile kernel ``probe_partial`` at the same shape; passes of W = 4 and
  16 windows (8 in the kernel; at 16 each warpgroup holds 8 accumulators);
  rings of 3 and 5 stages (4 in the kernel); 1 consumer warpgroup of 8
  windows and 4 of 2 windows each (2 of 4 in the kernel); no products; products only (no slab
  loads: the floor that the products set); loads only (no products, no B, no
  epilogue: the floor that L2 sets for the slabs); the last three wrong on
  purpose. Then the kernel alone, back to back for a few seconds at the first
  shape, with the SM clock and the power draw that nvidia-smi reads meanwhile:
  whether the card holds its clock at its power limit under these products.
* K5a at [8, 64³, 48 -> 48], [8, 32³, 96 -> 48] and [8, 16³, 96 -> 96], beside
  ``F.conv3d`` (cuDNN, channels_last_3d): w streamed tap by tap at every width
  (where w lives); the x walk never split, and always split in two; 1 and 4
  m16 tiles a warp (16 and 4 warps); no products, and no fragment loads or
  products (wrong on purpose: what the products and the loads cost).

The variants that keep the numerics are held to the kernel's tolerance
against its plain version (one bf16 ulp plus 1e-3·RMS). Order A B ... B A;
each time is the least of 5, after 2 warm-ups, of 10 back-to-back launches.

    python -m flowtrain_stochastic_interpolation_torch.tools.ab_gemm_conv
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.ops import gemm_probes as gp
from flowtrain_stochastic_interpolation_torch.ops import tap_conv as tc
from flowtrain_stochastic_interpolation_torch.tools import bench_gemm as bg
from flowtrain_stochastic_interpolation_torch.tools import bench_mma_shapes as bms
from flowtrain_stochastic_interpolation_torch.tools import bench_tap_conv as btc
from flowtrain_stochastic_interpolation_torch.tools import variants
from flowtrain_stochastic_interpolation_torch.tools.timing import best_ms, device_line
from flowtrain_stochastic_interpolation_torch.tools.variants import Substitutions

CALLS = 10
PROBE_SHAPES = ((1296, 48), (1296, 128))
P2_SHAPES = ((2048, 1296, 48, 16), (2048, 144, 48, 64))  # (m_block, K, N, grid)
P2_REPS = 256
SUSTAIN_S = 3.0  # seconds of back-to-back P2 launches for the clock and power samples
CONV_CASES = ((8, 64, 48, 48), (8, 32, 96, 48), (8, 16, 96, 96))

_P1_PRODUCTS = [("      ldmatrix_x4(af[0], as + a_row + a_unit);\n", ""),
                ("      ldmatrix_x4(af[1], as + a_row + 16 * TK + a_unit);\n", ""),
                ("        if (b_kn) ldmatrix_x4_trans(bf[p], bp);\n", ""),
                ("        else ldmatrix_x4(bf[p], bp);\n", ""),
                ("          mma(acc[i][2 * p], af[i], bf[p][0], bf[p][1]);\n", ""),
                ("          mma(acc[i][2 * p + 1], af[i], bf[p][2], bf[p][3]);\n", "")]
# name -> (substitutions, whether the outputs are held to the plain version)
P1_VARIANTS: Dict[str, Tuple[Substitutions, bool]] = {
    "128-row tiles x 4 warps": (
        [("constexpr int TM = 160, TK = 64, WARPS = 5, STAGES = 3;",
          "constexpr int TM = 128, TK = 64, WARPS = 4, STAGES = 3;")], True),
    "4 stages": ([("constexpr int TM = 160, TK = 64, WARPS = 5, STAGES = 3;",
                   "constexpr int TM = 160, TK = 64, WARPS = 5, STAGES = 4;")], True),
    "no products (wrong)": (_P1_PRODUCTS, False),
}

_P2_CONSTANTS = "constexpr int W = 8, GROUPS = 2, MAX_STAGES = 4;"
_P2_PRODUCTS = [("      mma_async::wgmma_bf16<NT>(acc[a], mma_async::sw128_desc(window + 32 * ks), db,\n"
                 "                                ks > 0 || accumulate);\n", "")]
P2_VARIANTS: Dict[str, Tuple[Substitutions, bool]] = {
    "old probe_partial": ([("  if (window_path(K)) {", "  if (false) {")], True),
    "W = 4": ([(_P2_CONSTANTS, _P2_CONSTANTS.replace("W = 8", "W = 4"))], True),
    "W = 16": ([(_P2_CONSTANTS, _P2_CONSTANTS.replace("W = 8", "W = 16"))], True),
    "3 stages": ([(_P2_CONSTANTS, _P2_CONSTANTS.replace("MAX_STAGES = 4", "MAX_STAGES = 3"))],
                 True),
    "5 stages": ([(_P2_CONSTANTS, _P2_CONSTANTS.replace("MAX_STAGES = 4", "MAX_STAGES = 5"))],
                 True),
    "1 warpgroup x 8 windows": (
        [(_P2_CONSTANTS, _P2_CONSTANTS.replace("GROUPS = 2", "GROUPS = 1"))], True),
    "4 warpgroups x 2 windows": (
        [(_P2_CONSTANTS, _P2_CONSTANTS.replace("GROUPS = 2", "GROUPS = 4"))], True),
    "no products (wrong)": (_P2_PRODUCTS, False),
    "products only (wrong)": ([
        ("            mbar_expect_tx(&full[j], SLAB_BYTES);\n"
         "            tma_load_3d(ring.stages + j * SLAB_BYTES, a_tmap, &full[j], sl * TK,\n"
         "                        rt * TM + 8 * w0, step);\n",
         "            mbar_arrive(&full[j]);\n")], False),
    "loads only (wrong)": (_P2_PRODUCTS + [
        ("      stage_b<NT>(b_s, b, K, N, ct * NT, slices, t);\n", ""),
        ("        atomicMax(reinterpret_cast<int*>(best_out) + static_cast<long long>(row) * N + col,\n"
         "                  __float_as_int(best[e]));\n", "        ;\n")], False),
}

_K5A_PRODUCTS = [(line, "") for line in (
    "          if (2 * p < ntc) mma(acc[i][2 * p], af[i], bf[p][0], bf[p][1]);\n",
    "          if (2 * p + 1 < ntc) mma(acc[i][2 * p + 1], af[i], bf[p][2], bf[p][3]);\n")]
_K5A_SEGMENTS = ("forward_segments(columns, X, static_cast<long long>(sms) * "
                 "(per_sm > 0 ? per_sm : 1));")
_K5A_A_LOAD = "        ldmatrix_x4(af[i], xs + a_off[i] + 16 * cs - (half ? a_half : 0));"
K5A_VARIANTS: Dict[str, Tuple[Substitutions, bool]] = {
    "w streamed at every width": (
        [("  p.resident = (w_all + planes) * 2 <= box::SMEM_LIMIT;", "  p.resident = 0;")], True),
    "x walk not split": ([(_K5A_SEGMENTS, "1;")], True),
    "x walk split in 2": ([(_K5A_SEGMENTS, "2;")], True),
    "1 m16 tile x 16 warps": ([("constexpr int MT = 2;", "constexpr int MT = 1;")], True),
    "4 m16 tiles x 4 warps": ([("constexpr int MT = 2;", "constexpr int MT = 4;")], True),
    "no products (wrong)": (_K5A_PRODUCTS, False),
    "no fragments or products (wrong)": (
        _K5A_PRODUCTS + [(_K5A_A_LOAD, "        ;"),
                         ("          ldmatrix_x4_trans(bf[p], wk + 16 * p);", ""),
                         ("          ldmatrix_x2_trans(b2, wk + 16 * p);", "b2[0] = b2[1] = 0;")],
        False),
}


def _bind_probe(lib: ctypes.CDLL) -> None:
    for name in ("gemm_probe_forward", "mma_probe_forward"):
        getattr(lib, name).argtypes = getattr(gp._library(), name).argtypes
        getattr(lib, name).restype = ctypes.c_int


def _bind_conv(lib: ctypes.CDLL) -> None:
    lib.tap_conv_forward.argtypes = tc._library().tap_conv_forward.argtypes
    lib.tap_conv_forward.restype = ctypes.c_int


def _check(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """One bf16 ulp plus 1e-3·RMS, as chip_smoke.py holds the kernels."""
    got, want = got.float(), want.float()
    rms = want.square().mean().sqrt().item()
    bad = int(((got - want).abs() > 1e-3 * rms + 2.0**-7 * want.abs()).sum())
    if bad:
        raise RuntimeError(f"{name}: {bad} values outside the kernel's tolerance")


def _in_turns(libs: Dict[str, ctypes.CDLL], checked: Dict[str, bool],
              launch: Callable[[ctypes.CDLL], torch.Tensor], want: torch.Tensor,
              library: Optional[Callable[[], object]], label: str,
              repeat: bool = False) -> None:
    """Check and time every library in the order A B ... B A, beside ``library``
    (if there is one); with ``repeat``, each checked one must also give the same
    output on a second launch."""
    times: Dict[str, List[float]] = {}
    for name in [*libs, *reversed(libs)]:
        if checked.get(name, True):
            got = launch(libs[name])
            _check(name, got, want)
            if repeat and not torch.equal(got, launch(libs[name])):
                raise RuntimeError(f"{name}: a second launch differs")
        times.setdefault(name, []).append(best_ms(lambda: launch(libs[name]), CALLS) / CALLS)
    extra = "" if library is None else f": library call {best_ms(library, CALLS) / CALLS:.4f} ms"
    print(f"{label}{extra}", flush=True)
    for name, ms in times.items():
        print(f"    {name:34s} {ms[0]:.4f} / {ms[1]:.4f} ms", flush=True)


def sustained(fn: Callable[[], object], label: str) -> None:
    """``fn`` back to back for ``SUSTAIN_S`` seconds, with the SM clock and power
    draw sampled by nvidia-smi every 0.4 s meanwhile; prints ms per call."""
    samples: List[str] = []
    stop = threading.Event()

    def sample() -> None:
        query = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                 "--format=csv,noheader"]
        while not stop.wait(0.4):
            samples.append(subprocess.run(query, capture_output=True, text=True,
                                          timeout=30).stdout.strip())

    fn()
    torch.cuda.synchronize()
    sampler = threading.Thread(target=sample)
    sampler.start()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    calls, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < SUSTAIN_S:
        for _ in range(CALLS):
            fn()
        calls += CALLS
        torch.cuda.synchronize()
    end.record()
    end.synchronize()
    stop.set()
    sampler.join()
    print(f"{label}: {calls} calls back to back, {start.elapsed_time(end) / calls:.4f} ms a call;"
          f" SM clock, power draw, limit: {' | '.join(samples)}", flush=True)


def probe_launch(lib: ctypes.CDLL, a: torch.Tensor, b: torch.Tensor, transposed: bool):
    """P1 through a variant's C entry point, as the wrapper launches it (``b`` is Bt
    for the transposed layout)."""
    m, k = a.shape
    n = b.shape[0] if transposed else b.shape[1]
    out = torch.empty((n, m) if transposed else (m, n), dtype=torch.bfloat16, device=a.device)
    b_ks, b_ns = (1, k) if transposed else (n, 1)
    o_ms, o_ns = (1, m) if transposed else (n, 1)
    code = lib.gemm_probe_forward(a.data_ptr(), b.data_ptr(), b_ks, b_ns, out.data_ptr(), o_ms,
                                  o_ns, m, n, k, torch.cuda.current_stream(a.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"launch failed: CUDA error {code}")
    return out


def mma_probe_launch(lib: ctypes.CDLL, a: torch.Tensor, b: torch.Tensor, reps: int):
    """P2 through a variant's C entry point, as the wrapper launches it."""
    grid, rows, k = a.shape
    m_block, n = rows - gp.WINDOW_PAD, b.shape[1]
    part = torch.empty(grid, m_block, n, dtype=torch.float32, device=a.device)
    out = torch.empty(m_block, n, dtype=torch.bfloat16, device=a.device)
    code = lib.mma_probe_forward(a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(), grid,
                                 m_block, k, n, reps, torch.cuda.current_stream(a.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"launch failed: CUDA error {code}")
    return out


def conv_launch(lib: ctypes.CDLL, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """K5a through a variant's C entry point, as the wrapper launches it."""
    cin, cout = x.shape[-1], w.shape[-1]
    out = torch.empty(*x.shape[:4], cout, dtype=x.dtype, device=x.device)
    code = lib.tap_conv_forward(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), 0,
                                x.numel() // cin, *x.shape[1:4], cin, cout,
                                torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"launch failed: CUDA error {code}")
    return out


def main() -> None:
    device = resolve_device()
    torch.backends.cudnn.allow_tf32 = False
    print(device_line(), flush=True)
    # P1's and P2's variants of the one source, all built together
    built = variants.build_variants(
        gp.SOURCE, {f"{kernel} {n}": subs for kernel, table in (("P1", P1_VARIANTS),
                                                                 ("P2", P2_VARIANTS))
                    for n, (subs, _) in table.items()}, _bind_probe)
    probe_libs = {"kernel": gp._library(), **{n: built[f"P1 {n}"] for n in P1_VARIANTS}}
    p2_libs = {"kernel": gp._library(), **{n: built[f"P2 {n}"] for n in P2_VARIANTS}}
    conv_libs = {"kernel": tc._library(), **variants.build_variants(
        tc.SOURCE, {n: subs for n, (subs, _) in K5A_VARIANTS.items()}, _bind_conv)}
    for k, n in PROBE_SHAPES:
        a, b, bt = bg.operands(bg.M, k, n, device)
        checked = {name: keep for name, (_, keep) in P1_VARIANTS.items()}
        _in_turns(probe_libs, checked, lambda lib: probe_launch(lib, a, b, False),
                  gp.gemm_probe_plain(a, b), lambda: torch.matmul(a, b),
                  f"P1 [{bg.M} x {k}] @ [{k} x {n}], [M, N]")
        _in_turns(probe_libs, checked, lambda lib: probe_launch(lib, a, bt, True),
                  gp.gemm_probe_t_plain(a, bt), lambda: torch.matmul(bt, a.T),
                  f"P1 [{bg.M} x {k}] @ [{k} x {n}], [N, M]")
        del a, b, bt
    for m_block, k, n, grid in P2_SHAPES:
        a, b = bms.operands(m_block, k, n, grid, device)
        checked = {name: keep for name, (_, keep) in P2_VARIANTS.items()}
        _in_turns(p2_libs, checked, lambda lib: mma_probe_launch(lib, a, b, P2_REPS),
                  gp.mma_probe_plain(a, b, P2_REPS), None,
                  f"P2 ({m_block}, {k}, {n}, {grid}) R = {P2_REPS}", repeat=True)
        if (m_block, k, n, grid) == P2_SHAPES[0]:
            sustained(lambda: gp.mma_probe(a, b, P2_REPS),
                      f"P2 ({m_block}, {k}, {n}, {grid}) R = {P2_REPS}, sustained")
        del a, b
    torch.cuda.empty_cache()
    for batch, side, cin, cout in CONV_CASES:
        x, w, b = btc.operands(batch, side, cin, cout, device)
        checked = {name: keep for name, (_, keep) in K5A_VARIANTS.items()}
        _in_turns(conv_libs, checked, lambda lib: conv_launch(lib, x, w, b),
                  tc.tap_conv_forward_plain(x, w, b), lambda: btc.cudnn_conv(x, w, b),
                  f"K5a b{batch} {side}³ {cin} -> {cout} bf16")
        del x, w, b


if __name__ == "__main__":
    main()
