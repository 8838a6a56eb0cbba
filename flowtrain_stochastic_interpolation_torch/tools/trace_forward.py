"""A Chrome trace of the flagship unconditional forward.

Port of the root ``tools/trace_forward.py``. It warms up the b8 bf16 forward
of ``unconditional_64`` (seeded weights, t = 0.5), times one with CUDA events
(the host clock on the CPU), then records ``--iters`` forwards under
``torch.profiler`` (``utils.profiling.trace``), each in a ``record_function``
range named ``iteration``, and writes the Chrome trace ``<out>/trace.json``
where the JAX tool writes an xplane file. ``tools/trace_summary.py`` reads it.

    python -m flowtrain_stochastic_interpolation_torch.tools.trace_forward \\
        [--batch 8] [--iters 3] [--out DIR] [--preset tiny --device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

from flowtrain_stochastic_interpolation_torch.config import tiny_test, unconditional_64
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.tools.timing import best_ms_on
from flowtrain_stochastic_interpolation_torch.tools.trace_summary import ITERATION
from flowtrain_stochastic_interpolation_torch.train.loop import init_model_variables
from flowtrain_stochastic_interpolation_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
TRACES = ROOT / "artifacts" / "traces"


def preset(name: str):
    return tiny_test() if name == "tiny" else unconditional_64()


def record(fn: Callable[[], object], iters: int, out: str, device: torch.device) -> dict:
    """``iters`` calls of ``fn`` under ``utils.profiling.trace``, each an
    ``iteration`` range: ``{"trace": path, "profiler_device_ms": ...}``, the
    second the kernel time per iteration that the profiler's own table
    (``key_averages``) counts (0 without a card)."""
    from torch.autograd import DeviceType

    with profiling.trace(out) as prof:
        for _ in range(iters):
            with torch.profiler.record_function(ITERATION):
                fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    # the iteration ranges have device spans of their own in the table: not kernels
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.key != ITERATION)
    return {"trace": str(Path(out) / profiling.TRACE_FILE),
            "profiler_device_ms": device_us / 1e3 / iters}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=str(TRACES / "torch_forward"))
    ap.add_argument("--preset", default="flagship", choices=["flagship", "tiny"])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    config = preset(args.preset)
    model = init_model_variables(config, device=dev).eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(args.batch, *config.data.shape, config.data.embedding_dim, generator=gen,
                    device=dev).to(torch.bfloat16)
    t = torch.full((args.batch,), 0.5, device=dev)

    @torch.inference_mode()
    def forward():
        return model(x, t)

    for _ in range(2):
        forward()
    ms = best_ms_on(dev, forward, warmup=0, tries=1)
    print(f"forward: {ms:.1f} ms", flush=True)
    result = record(forward, args.iters, args.out, dev)
    print(f"trace written to {result['trace']} ({args.iters} iterations; the profiler counts "
          f"{result['profiler_device_ms']:.3f} ms of kernel time an iteration)", flush=True)
    return {"forward_ms": ms, **result}


if __name__ == "__main__":
    main()
