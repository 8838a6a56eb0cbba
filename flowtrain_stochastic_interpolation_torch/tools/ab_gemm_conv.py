"""The sixth slice's design choices on the card: variants of P1's streaming
kernel (``csrc/gemm_probes.cu``) and of K5a's box kernel (``csrc/tap_conv.cu``)
timed in turns beside the kernels as they stand and beside one PyTorch call.

Each variant is the source with a few lines substituted, built by its own
``nvcc`` call into ``_build/`` and launched through the same C entry point.

* P1 at 524,288 x 1296 x {48, 128}, both layouts, beside ``torch.matmul`` in
  the same layout: 128-row tiles with 4 consumer warps (the tiles before
  160); a ring of 4 stages (one block per SM at N = 48, where 3 leave room
  for two); no products (wrong on purpose: the floor that A's loads set).
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
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.ops import gemm_probes as gp
from flowtrain_stochastic_interpolation_torch.ops import tap_conv as tc
from flowtrain_stochastic_interpolation_torch.tools import bench_gemm as bg
from flowtrain_stochastic_interpolation_torch.tools import bench_tap_conv as btc
from flowtrain_stochastic_interpolation_torch.tools import variants
from flowtrain_stochastic_interpolation_torch.tools.timing import best_ms, device_line
from flowtrain_stochastic_interpolation_torch.tools.variants import Substitutions

CALLS = 10
PROBE_SHAPES = ((1296, 48), (1296, 128))
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
    lib.gemm_probe_forward.argtypes = gp._library().gemm_probe_forward.argtypes
    lib.gemm_probe_forward.restype = ctypes.c_int


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
              library: Callable[[], object], label: str) -> None:
    """Check and time every library in the order A B ... B A, beside ``library``."""
    times: Dict[str, List[float]] = {}
    for name in [*libs, *reversed(libs)]:
        if checked.get(name, True):
            _check(name, launch(libs[name]), want)
        times.setdefault(name, []).append(best_ms(lambda: launch(libs[name]), CALLS) / CALLS)
    print(f"{label}: library call {best_ms(library, CALLS) / CALLS:.4f} ms", flush=True)
    for name, ms in times.items():
        print(f"    {name:34s} {ms[0]:.4f} / {ms[1]:.4f} ms", flush=True)


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
    probe_libs = {"kernel": gp._library(), **variants.build_variants(
        gp.SOURCE, {n: subs for n, (subs, _) in P1_VARIANTS.items()}, _bind_probe)}
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
    for batch, side, cin, cout in CONV_CASES:
        x, w, b = btc.operands(batch, side, cin, cout, device)
        checked = {name: keep for name, (_, keep) in K5A_VARIANTS.items()}
        _in_turns(conv_libs, checked, lambda lib: conv_launch(lib, x, w, b),
                  tc.tap_conv_forward_plain(x, w, b), lambda: btc.cudnn_conv(x, w, b),
                  f"K5a b{batch} {side}³ {cin} -> {cout} bf16")
        del x, w, b


if __name__ == "__main__":
    main()
