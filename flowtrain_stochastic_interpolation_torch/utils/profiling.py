"""Tracing and step timing on the card.

Port of ``flowtrain_stochastic_interpolation_tpu/utils/profiling.py``:

* :func:`trace`: ``torch.profiler`` over the block (CPU, and CUDA where there
  is a card), written as a Chrome trace to ``log_dir/trace.json``, where the
  JAX package writes an xplane trace;
* :class:`StepTimer`: wall-clock seconds per call, fenced by
  ``torch.cuda.synchronize`` on every card that the call's tensors (or the
  timer's ``device``) live on, with warm-up calls left out and JAX's
  ``summary()`` keys;
* :func:`compile_time`: the first call's fenced seconds, what JAX's trace and
  compile are here: kernel builds, cuDNN's algorithm choice, the first launch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


def _tensors(out: Any) -> Iterator[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for value in out.values():
            yield from _tensors(value)
    elif isinstance(out, (list, tuple)):
        for value in out:
            yield from _tensors(value)


def _fence(out: Any, device=None) -> None:
    """Wait for every card that ``out``'s tensors, or ``device``, live on."""
    cards = {t.device for t in _tensors(out) if t.is_cuda}
    if device is not None and torch.device(device).type == "cuda":
        cards.add(torch.device(device))
    for card in cards:
        torch.cuda.synchronize(card)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block: ``with trace(dir) as prof: step(...)``; the Chrome
    trace is ``dir/trace.json`` once the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Seconds per call of ``timer(fn, *args)``, fenced; the first ``warmup``
    calls are left out of :meth:`summary`."""

    def __init__(self, warmup: int = 1, device=None):
        self.warmup = warmup
        self.device = device
        self.times: List[float] = []
        self._seen = 0

    def __call__(self, fn: Callable, *args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        _fence(out, self.device)
        dt = time.perf_counter() - start
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)
        return out

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {
            "mean_s": float(a.mean()),
            "p50_s": float(np.percentile(a, 50)),
            "p90_s": float(np.percentile(a, 90)),
            "steps_per_sec": float(1.0 / a.mean()),
            "n": len(self.times),
        }


def compile_time(fn: Callable, *args, device: Optional[Any] = None, **kwargs) -> float:
    """Seconds of the first call of ``fn``, fenced as :class:`StepTimer` fences."""
    start = time.perf_counter()
    out = fn(*args, **kwargs)
    _fence(out, device)
    return time.perf_counter() - start
