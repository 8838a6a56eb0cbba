"""Probe P1: a hand-written GEMM at the 3³/48-channel conv's implicit-GEMM shape,
beside ``torch.matmul``.

Counterpart of the JAX package's ``tools/bench_pallas_gemm.py``: the 64³ convs
lower to implicit GEMMs ``[M = voxels, K = 27·48 = 1296, N = 48]``. This times
P1 (:func:`~..ops.gemm_probes.gemm_probe`), its transposed layout
(:func:`~..ops.gemm_probes.gemm_probe_t`, out ``[N, M]``) and ``torch.matmul``
on the same bf16 operands at M = 524,288 (one z-slab of batch 8) and (K, N) in
{(1296, 48), (1280, 48), (1296, 128), (144, 48)}: the conv's shape, a K that
is a multiple of 128, a full-width N and 3 folded taps.

Each time is the least of 5, after 2 warm-ups, of R = 8 back-to-back calls
timed with CUDA events, divided by R (the JAX tool runs R calls in one
program).

    python -m flowtrain_stochastic_interpolation_torch.tools.bench_gemm
"""

from __future__ import annotations

from typing import Dict

import torch

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.ops.gemm_probes import gemm_probe, gemm_probe_t
from flowtrain_stochastic_interpolation_torch.tools.timing import best_ms, device_line

M = 8 * 64 * 64 * 16
SHAPES = ((1296, 48), (1280, 48), (1296, 128), (144, 48))
R = 8


def operands(m: int, k: int, n: int, device):
    """A ~ N(0, 1) [M, K], B ~ 0.02·N(0, 1) [K, N] and Bt = Bᵀ, bf16, seeded."""
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    b = (torch.randn(k, n, generator=gen, device=device) * 0.02).to(torch.bfloat16)
    return a, b, b.T.contiguous()


def bench_shape(k: int, n: int, m: int = M, device=None) -> Dict[str, float]:
    """ms per call and TF/s of torch.matmul, P1 and P1 transposed at [m, k] @ [k, n]."""
    device = resolve_device(device)
    a, b, bt = operands(m, k, n, device)
    flops = 2 * m * k * n
    ref = torch.matmul(a, b).float()
    row = {"rel_err": ((gemm_probe(a, b).float() - ref).abs().max() / ref.abs().max()).item(),
           "rel_err_t": ((gemm_probe_t(a, bt).float().T - ref).abs().max() / ref.abs().max()).item()}
    line = f"[{m}x{k}]@[{k}x{n}] xR{R}:"
    for tag, fn in (("matmul", lambda: torch.matmul(a, b)), ("p1", lambda: gemm_probe(a, b)),
                    ("p1T", lambda: gemm_probe_t(a, bt))):
        ms = best_ms(fn, calls=R) / R
        row[f"{tag}_ms"] = ms
        line += f"  {tag} {ms:7.3f}ms({flops / ms / 1e9:5.1f}TF/s)"
    print(f"{line}  rel.err {row['rel_err']:.1e} / {row['rel_err_t']:.1e}", flush=True)
    return row


def main() -> None:
    device = resolve_device()
    print(device_line(), flush=True)
    for k, n in SHAPES:
        bench_shape(k, n, device=device)


if __name__ == "__main__":
    main()
