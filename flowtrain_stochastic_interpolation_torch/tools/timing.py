"""Device timing shared by the tools: CUDA events around back-to-back calls."""

from __future__ import annotations

import time
from typing import Callable

import torch


def best_ms(fn: Callable[[], object], calls: int = 1, warmup: int = 2, tries: int = 5) -> float:
    """The least device time, over ``tries``, of ``calls`` back-to-back calls of
    ``fn``, in ms (the JAX tools' ``timeit``: min of 5 after 2 warm-ups)."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(tries):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def best_ms_on(device: torch.device, fn: Callable[[], object], warmup: int = 2,
               tries: int = 5) -> float:
    """:func:`best_ms` of one call on the card; on the CPU the least, over
    ``tries``, of the host clock around one call."""
    if device.type == "cuda":
        return best_ms(fn, warmup=warmup, tries=tries)
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(tries):
        start = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - start) * 1e3)
    return best


def slope_ms(fn: Callable[[], object], hi: int, lo: int) -> float:
    """ms per call from the slope between ``hi`` and ``lo`` back-to-back calls:
    the fixed cost of a timed run cancels."""
    return max(best_ms(fn, hi) - best_ms(fn, lo), 1e-9) / (hi - lo)


def device_line() -> str:
    return f"device: cuda {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
