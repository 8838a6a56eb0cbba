"""A Chrome trace of the flagship train micro-step: forward, backward, Adam, EMA.

Port of the root ``tools/trace_train.py``: ``make_train_step`` at
``--batch`` (4) with accumulation 1 on one synthetic batch, two warm-up
micro-steps, one timed (CUDA events; the host clock on the CPU), then
``--iters`` under ``torch.profiler``, each an ``iteration`` range, written
as ``<out>/trace.json``. ``--conditional`` takes ``conditional_64``;
``--attn-vjp`` the folded attention's backward.

    python -m flowtrain_stochastic_interpolation_torch.tools.trace_train \\
        [--batch 4] [--iters 3] [--conditional] [--out DIR] [--preset tiny --device cpu]
Then: python -m flowtrain_stochastic_interpolation_torch.tools.trace_summary \\
        DIR/trace.json 3
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from flowtrain_stochastic_interpolation_torch.config import (
    conditional_64,
    tiny_test,
    unconditional_64,
)
from flowtrain_stochastic_interpolation_torch.data.synthetic import synthetic_geology_batch
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.tools.timing import best_ms_on
from flowtrain_stochastic_interpolation_torch.tools.trace_forward import TRACES, record
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state
from flowtrain_stochastic_interpolation_torch.train.steps import make_train_step
from flowtrain_stochastic_interpolation_torch.utils.rng import generator


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--conditional", action="store_true")
    ap.add_argument("--attn-vjp", default=None,
                    help="folded-attention backward (closed_form | closed_form_bf16 | chunked "
                         "| autodiff)")
    ap.add_argument("--out", default=str(TRACES / "torch_train"))
    ap.add_argument("--preset", default="flagship", choices=["flagship", "tiny"])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.preset == "tiny":
        config = tiny_test(conditional=args.conditional)
    else:
        config = conditional_64() if args.conditional else unconditional_64()
    config = dataclasses.replace(
        config,
        data=dataclasses.replace(config.data, batch_size=args.batch),
        model=dataclasses.replace(config.model, attn_folded_vjp=args.attn_vjp),
        training=dataclasses.replace(config.training, accumulate_grad_batches=1),
    )
    model, tx, state = init_train_state(config, device=dev)
    train_step = make_train_step(model, tx, config)
    batch = synthetic_geology_batch(generator(dev, 0), args.batch, config.data.shape)

    def micro_step():
        nonlocal state
        state, metrics = train_step(state, batch, generator(dev, 1, state.step))
        return metrics

    for _ in range(2):
        micro_step()
    ms = best_ms_on(dev, micro_step, warmup=0, tries=1)
    print(f"micro-step: {ms:.1f} ms", flush=True)
    result = record(micro_step, args.iters, args.out, dev)
    print(f"trace written to {result['trace']} ({args.iters} iterations; the profiler counts "
          f"{result['profiler_device_ms']:.3f} ms of kernel time an iteration)", flush=True)
    return {"micro_step_ms": ms, **result}


if __name__ == "__main__":
    main()
