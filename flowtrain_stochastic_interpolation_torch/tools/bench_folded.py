"""The folded linear attention of the flagship on the card: K1 and K2 through
their wrappers at the three stages, and the b8 × 64³ UNet forward that runs them.

* K1 (``folded_context``) and K2 (``folded_project``) at b8 × {262,144,
  32,768, 4,096} tokens × 4 heads × 32, bf16, q, k and v column slices of one
  [B, N, 384] projection: ms as ``chip_smoke.py``'s phase 3 takes it (CUDA
  events around 20 back-to-back calls, median of 5 rounds), the wrapper's host
  time per call (300 calls enqueued back to back, least of 3) and each
  kernel's device time per launch (``torch.profiler`` over 10 calls). Where
  the host time is the longer, back-to-back calls time the host.
* ``config.unconditional_64`` at full width with seeded random weights, bf16
  compute, eval mode: 1 warm-up and 10 timed b8 × 64³ forwards, each closed
  by ``torch.cuda.synchronize()``, median ms; then one forward under
  ``torch.profiler``: its kernel time and that of the kernels named
  ``folded_*`` (K1's partial pass and combine, K2).

    python -m flowtrain_stochastic_interpolation_torch.tools.bench_folded

Run by path with another checkout's package first on ``PYTHONPATH`` (for
example an unpacked parent commit), it measures that package, so two
versions compare on one card in turns.
"""

from __future__ import annotations

import statistics
import time

import torch

import flowtrain_stochastic_interpolation_torch as package
from flowtrain_stochastic_interpolation_torch.config import unconditional_64
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la

BATCH, TOKENS, HEADS, WIDTH = 8, (262144, 32768, 4096), 4, 128
SIDE, CHANNELS, TIMED = 64, 18, 10


def events_ms(fn, reps: int = 20, rounds: int = 5, warmup: int = 3) -> float:
    """Median over ``rounds`` of the mean device time of ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    means = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def host_us(fn, reps: int = 300) -> float:
    """Least of 3 over the host µs per call of ``reps`` calls enqueued back to back."""
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - start) / reps * 1e6)
        torch.cuda.synchronize()
    return best


def device_us(fn, calls: int = 10) -> str:
    """Device µs per launch of each kernel ``fn`` launches, by kernel name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return ", ".join(f"{e.key.split('::')[-1].split('(')[0]} {e.device_time_total / e.count:.2f}"
                     for e in prof.key_averages() if e.device_time_total > 0)


def kernels(device) -> None:
    """K1 and K2 through their wrappers at the three stages."""
    for n in TOKENS:
        gen = torch.Generator(device=device).manual_seed(100)
        qkv = torch.randn(BATCH, n, 3 * WIDTH, generator=gen, device=device).to(torch.bfloat16)
        mem = torch.randn(2, 4, WIDTH, generator=gen, device=device).to(torch.bfloat16)
        q, k, v = qkv[..., :WIDTH], qkv[..., WIDTH:2 * WIDTH], qkv[..., 2 * WIDTH:]
        mk, mv = mem[0].contiguous(), mem[1].contiguous()
        ctx = la.folded_context_plain(k, v, mk, mv, HEADS)
        for name, fn in (("K1", lambda: la.folded_context(k, v, mk, mv, HEADS)),
                         ("K2", lambda: la.folded_project(q, ctx, HEADS))):
            print(f"{name} b{BATCH} x {n}: {events_ms(fn):.4f} ms (20 back-to-back calls), host "
                  f"{host_us(fn):.1f} µs per call, device µs per launch: {device_us(fn)}",
                  flush=True)
        del qkv, q, k, v, ctx


def forward(device) -> None:
    """The flagship's b8 × 64³ forward and K1 + K2's device time in it."""
    model = UNet.from_config(unconditional_64().model, device=device).eval()
    model.reset_parameters(torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.randn(BATCH, SIDE, SIDE, SIDE, CHANNELS, generator=gen, device=device)
    x = x.to(torch.bfloat16)
    t = torch.full((BATCH,), 0.5, device=device)
    times = []
    with torch.inference_mode():
        for i in range(TIMED + 1):
            torch.cuda.synchronize()
            start = time.perf_counter()
            y = model(x, t)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - start) * 1e3)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            model(x, t)
            torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        raise RuntimeError("non-finite forward")
    events = prof.key_averages()
    total = sum(e.self_device_time_total for e in events) / 1e3
    folded = sum(e.self_device_time_total for e in events if "folded_" in e.key) / 1e3
    each = ", ".join(f"{v:.1f}" for v in times)
    print(f"b{BATCH} x {SIDE}³ forward: median {statistics.median(times):.2f} ms ({each}); "
          f"kernel time {total:.2f} ms, K1 + K2 {folded:.3f} ms", flush=True)


def main() -> None:
    device = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}, package {package.__path__[0]}", flush=True)
    kernels(device)
    forward(device)


if __name__ == "__main__":
    main()
