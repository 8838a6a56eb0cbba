"""Probe P2: the tensor cores' product rate at the conv's candidate GEMM shapes.

Counterpart of the JAX package's ``tools/bench_mxu_shapes.py``. P2
(:func:`~..ops.gemm_probes.mma_probe`) runs R products per grid step, each of
a different 8-row-shifted window of A ``[m_block, K]`` with B ``[K, N]``,
max-accumulated so that none can be folded into another, with B kept in
shared memory (the A windows do not fit there and stream from L2; see the
kernel's note). The rate comes from the slope between R = 256 and R = 32
products, which cancels the fixed costs: launch, B's staging, the combine.

The ten cases of the JAX tool, ``(m_block, K, N, grid)``: the per-tap dot
(K = N = 48), 3 and 9 taps folded (K = 144, 432), all 27 (K = 1296), the
lane-fill control N = 128, the tap-on-N variant (K = 48, N = 1296), K = 1280
and K = 512 controls, N = 64, and a smaller M block.

Each time is the least of 5 single calls after 2 warm-ups, timed with CUDA
events.

    python -m flowtrain_stochastic_interpolation_torch.tools.bench_mma_shapes
"""

from __future__ import annotations

from typing import Tuple

import torch

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.ops.gemm_probes import WINDOW_PAD, mma_probe
from flowtrain_stochastic_interpolation_torch.tools.timing import best_ms, device_line

R = 256
CASES = (
    (2048, 48, 48, 64),
    (2048, 144, 48, 64),
    (2048, 432, 48, 32),
    (2048, 1296, 48, 16),
    (2048, 1296, 128, 8),
    (512, 48, 1296, 64),
    (2048, 1280, 48, 16),   # K multiple of 128 control
    (2048, 512, 48, 32),    # K power-of-2 control
    (2048, 1296, 64, 16),   # N = 64 control
    (1024, 1296, 48, 32),   # smaller M block
)


def operands(m_block: int, k: int, n: int, grid: int, device):
    """A ~ N(0, 1) [grid, m_block + 256, K] and B ~ 0.02·N(0, 1) [K, N], bf16, seeded."""
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(grid, m_block + WINDOW_PAD, k, generator=gen, device=device)
    b = torch.randn(k, n, generator=gen, device=device) * 0.02
    return a.to(torch.bfloat16), b.to(torch.bfloat16)


def probe(m_block: int, k: int, n: int, grid: int, device=None) -> Tuple[float, float]:
    """(TF/s from the slope between R and R/8 products, ms of one call at R)."""
    device = resolve_device(device)
    a, b = operands(m_block, k, n, grid, device)
    r_lo = R // 8
    t_hi = best_ms(lambda: mma_probe(a, b, R))
    t_lo = best_ms(lambda: mma_probe(a, b, r_lo))
    flops = 2 * m_block * grid * k * n * (R - r_lo)
    return flops / max(t_hi - t_lo, 1e-9) / 1e9, t_hi


def main() -> None:
    device = resolve_device()
    print(device_line(), flush=True)
    print(f"{'shape':>30} | {'TF/s':>7} | {'ms':>8}", flush=True)
    for m, k, n, g in CASES:
        tflops, ms = probe(m, k, n, g, device=device)
        print(f"[{m}x{k}]@[{k}x{n}] x{g}blk | {tflops:7.1f} | {ms:8.3f}", flush=True)


if __name__ == "__main__":
    main()
