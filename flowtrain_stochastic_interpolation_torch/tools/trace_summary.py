"""Summarise a Chrome trace of the port: device time by bucket, top kernels, idle.

Port of the root ``tools/xplane_summary.py``, for the ``trace.json`` that
``tools/trace_forward.py`` or ``tools/trace_train.py`` writes
(``torch.profiler``'s Chrome trace). It reads the device's events (kernels,
copies and memsets) and prints

* the device time per iteration (the trace's ``iteration`` ranges, or the
  ``iters`` argument);
* a bucket table (:func:`classify`): cuDNN convolutions, cuBLAS / CUTLASS
  GEMMs, the port's hand-written kernels (by their launch names, read from
  ``csrc/*.cu``), resizes, normalisation and elementwise work, reductions,
  copies and memsets, other;
* the largest kernels, and the device's idle share over the traced span
  with its largest gaps.

A trace without device events (a CPU run) is summarised by its top-level
operators on the host instead, by the same rules.

    python -m flowtrain_stochastic_interpolation_torch.tools.trace_summary \\
        <dir>/trace.json [iters]
"""

from __future__ import annotations

import collections
import json
import re
import sys
from functools import lru_cache
from pathlib import Path
from typing import FrozenSet, List, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
ITERATION = "iteration"  # the record_function range around each traced call
BUCKETS = ("convolution (cuDNN)", "GEMM (cuBLAS/CUTLASS)", "hand-written kernels", "resize",
           "normalisation and elementwise", "reductions", "copies and memsets", "other")

_RULES = (  # (bucket, pattern), tried in order after the hand-written kernels
    ("copies and memsets", r"memcpy|memset|copy_kernel|CatArrayBatchedCopy|aten::(copy_|to|"
                           r"_to_copy|clone|contiguous|cat|empty_like|zeros_like)$"),
    ("convolution (cuDNN)", r"fprop|dgrad|wgrad|implicit_gemm|cudnn|winograd|convol|"
                            r"aten::conv\dd"),
    ("GEMM (cuBLAS/CUTLASS)", r"gemm|gemv|nvjet|cutlass|cublas|(addmm|bmm|mm)Backward|"
                              r"aten::(mm|bmm|addmm|baddbmm|matmul|linear|einsum)$"),
    ("resize", r"upsample|aten::(upsample|grid_sampler)"),
    ("reductions", r"reduce|softmax|aten::(sum|mean|norm|linalg_vector_norm|amax|amin|max|min|"
                   r"argmax|logsumexp|_softmax)"),
    ("normalisation and elementwise", r"elementwise|aten::|Backward\d*$"),
)


@lru_cache(maxsize=None)
def hand_written_kernels(csrc: Path = CSRC) -> FrozenSet[str]:
    """The names of the port's ``__global__`` kernels, read from ``csrc/*.cu``."""
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*[<(]")
    return frozenset(name for path in sorted(csrc.glob("*.cu"))
                     for name in pattern.findall(path.read_text()))


def hand_written_name(name: str) -> Optional[str]:
    """The hand-written kernel that ``name`` (a launch name as the profiler gives
    it, e.g. ``(anonymous namespace)::folded_project(CUtensorMap_st, ...)``)
    launches, or None."""
    for match in re.finditer(r"(?:^|::|\s)(\w+)\s*[<(]", name):
        if match.group(1) in hand_written_kernels():
            return match.group(1)
    return None


def classify(name: str) -> str:
    """The bucket of one kernel or operator name."""
    if hand_written_name(name) is not None:
        return "hand-written kernels"
    for bucket, pattern in _RULES:
        if re.search(pattern, name, flags=re.IGNORECASE):
            return bucket
    return "other"


def _top_level(events: List[dict]) -> List[dict]:
    """The host operators not nested in another operator of the same thread."""
    out, end = [], {}
    for ev in sorted(events, key=lambda e: (e.get("tid"), e["ts"], -e["dur"])):
        tid = ev.get("tid")
        if ev["ts"] >= end.get(tid, float("-inf")):
            out.append(ev)
            end[tid] = ev["ts"] + ev["dur"]
    return out


def _busy_and_gaps(events: List[dict]) -> Tuple[float, float, List[float]]:
    """(span, busy time, gaps between busy intervals), in µs, of the union of the
    events' intervals."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, gaps = 0.0, []
    cur_start, cur_end = spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            gaps.append(start - cur_end)
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return spans[-1][1] - spans[0][0], busy, gaps


def summarize(path: str, iters: Optional[float] = None, top: int = 15,
              verbose: bool = True) -> dict:
    """The summary of the Chrome trace at ``path``, times in ms per iteration."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    source = "device" if device else "host"
    timed = device or _top_level([e for e in events if e.get("cat") == "cpu_op"])
    if iters is None:
        iters = sum(1 for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") == ITERATION) or 1
    per_name: collections.Counter = collections.Counter()
    for ev in timed:
        per_name[ev["name"]] += ev["dur"] / 1e3 / iters
    buckets = {b: 0.0 for b in BUCKETS}
    hand: collections.Counter = collections.Counter()
    for name, ms in per_name.items():
        buckets[classify(name)] += ms
        kernel = hand_written_name(name)
        if kernel is not None:
            hand[kernel] += ms
    span, busy, gaps = _busy_and_gaps(timed) if timed else (0.0, 0.0, [])
    summary = {
        "source": source,
        "iterations": iters,
        "events": len(timed),
        "total_ms": sum(per_name.values()),
        "buckets": buckets,
        "hand_written": dict(hand),
        "top": [(ms, name) for name, ms in per_name.most_common(top)],
        "span_ms": span / 1e3,
        "idle_share": 1.0 - busy / span if span > 0 else 0.0,
        "largest_gaps_ms": sorted((g / 1e3 for g in gaps), reverse=True)[:5],
    }
    if verbose:
        print_summary(summary)
    return summary


def print_summary(s: dict) -> None:
    what = "device time" if s["source"] == "device" else "host time of top-level operators"
    print(f"total {what} {s['total_ms']:.3f} ms/iter over {s['iterations']:g} iterations "
          f"({s['events']} events)")
    for bucket, ms in sorted(s["buckets"].items(), key=lambda kv: -kv[1]):
        share = 100 * ms / s["total_ms"] if s["total_ms"] else 0.0
        print(f"  {ms:9.3f} ms {share:5.1f}%  {bucket}")
    for kernel, ms in sorted(s["hand_written"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms         hand-written: {kernel}")
    print("\nlargest:")
    for ms, name in s["top"]:
        print(f"  {ms:9.3f} ms  {name[:120]}")
    print(f"\nidle share {s['idle_share']:.4f} of a {s['span_ms']:.3f} ms span; largest gaps "
          f"{[round(g, 3) for g in s['largest_gaps_ms']]} ms")


if __name__ == "__main__":
    summarize(sys.argv[1], float(sys.argv[2]) if len(sys.argv) > 2 else None)
