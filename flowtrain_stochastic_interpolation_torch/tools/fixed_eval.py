"""Trained weights on a fixed evaluation set, and loss curves over a window.

A measurement tool, as ``tools/sde_repro.py`` is, not a feature of any app.
Two statistics that one training batch cannot carry, for comparing training
runs (the port's demo against the JAX package's, or two exports of one run):

* **the fixed-evaluation loss** of each ``--weights`` directory (a release
  directory or a checkpoint directory of the port): ``train.steps.make_eval_loss``
  (no dropout, no update) on ``--batches`` batches of ``--batch-size``
  synthetic ``--shape``³ volumes. Batch ``i`` is drawn from a generator seeded
  ``(seed, i)`` (``utils.rng``) on the device: first its volumes, then, one
  volume at a time, each volume's noise and t as ``make_eval_loss`` draws them
  on a batch of one. So every input sees the same volumes and draws, and the
  mean comes with its standard error over the per-volume losses. The weights
  are those ``tools/sample_from_ckpt.py`` samples with under ``--ema``: the
  EMA shadow where there is one, else the params, for every input alike;
* **the window mean** of each ``--csv`` (a ``metrics.csv`` of a training run):
  the mean and standard error of ``train_loss`` over the rows whose step lies
  in ``--window`` (inclusive). Where a step repeats (a resumed run logs it
  again), its last row counts.

``--round-bf16 REGEX`` rounds, before the evaluation, every parameter whose
name matches ``REGEX`` to bf16, as the release format stores it (``.`` rounds
them all): which leaves' rounding costs a trained model what.

The standard error is the population standard deviation over √n. With
``--band F`` the first ``--weights`` and the first ``--csv`` are the
references: each other fixed-evaluation mean is within the band when its ratio
to the reference's lies in [1/F, F], and each other window mean agrees when it
is within three combined standard errors of the reference's.

    python -m flowtrain_stochastic_interpolation_torch.tools.fixed_eval \\
        --weights artifacts/weights/uncond_demo_64 [DIR ...] \\
        [--csv artifacts/train_demo/metrics.csv artifacts/torch/train_demo/metrics.csv] \\
        [--window 2500 2999] [--batches 32] [--batch-size 8] [--shape 64] [--seed 0] \\
        [--round-bf16 REGEX] [--band 1.5] [--json-out fixed_eval.json] [--device cpu]

It prints each mean with its standard error, the device and the card's name
and power limit (``nvidia-smi``), and writes them as JSON with ``--json-out``.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import re
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.data.synthetic import synthetic_geology_batch
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.models.persistence import is_release_weights_dir
from flowtrain_stochastic_interpolation_torch.tools.sample_from_ckpt import load
from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager
from flowtrain_stochastic_interpolation_torch.train.state import TrainState
from flowtrain_stochastic_interpolation_torch.train.steps import make_eval_loss
from flowtrain_stochastic_interpolation_torch.utils.rng import generator

BATCHES, BATCH_SIZE, SIDE = 32, 8, 64
WINDOW = (2500, 2999)


def mean_and_se(values: Sequence[float]) -> Tuple[float, float]:
    """The mean and its standard error (the population standard deviation over √n)."""
    v = np.asarray(values, dtype=np.float64)
    return float(v.mean()), float(v.std() / math.sqrt(v.size))


def window_stats(path: str, window: Tuple[int, int] = WINDOW,
                 column: str = "train_loss") -> dict:
    """``column``'s mean and standard error over the rows of the ``metrics.csv``
    at ``path`` whose step lies in ``window`` (inclusive); a repeated step's
    last row counts."""
    by_step: Dict[int, float] = {}
    rows = 0
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            by_step[int(row["step"])] = float(row[column])
            rows += 1
    lo, hi = window
    values = [v for step, v in sorted(by_step.items()) if lo <= step <= hi]
    if not values:
        raise ValueError(f"{path} has no row with a step in {lo}-{hi}")
    mean, se = mean_and_se(values)
    return {"path": path, "window": [lo, hi], "rows": len(values), "mean": mean, "se": se,
            "rows_in_file": rows, "steps_in_file": len(by_step)}


def fixed_eval_losses(model: torch.nn.Module, table: torch.Tensor, config, *,
                      batches: int = BATCHES, batch_size: int = BATCH_SIZE,
                      shape: Tuple[int, int, int] = (SIDE,) * 3, seed: int = 0,
                      device=None) -> np.ndarray:
    """The per-volume losses ``[batches · batch_size]`` of ``model`` on the fixed
    set (module docstring), through ``make_eval_loss`` on batches of one."""
    device = table.device if device is None else torch.device(device)
    eval_loss = make_eval_loss(model, config)
    state = TrainState(step=0, params=dict(model.named_parameters()),
                       constants={"embedding": table}, opt_state=None, ema_params=None)
    losses = []
    for i in range(batches):
        gen = generator(device, seed, i)
        volumes = synthetic_geology_batch(gen, batch_size, shape, config.data.num_categories)
        for j in range(batch_size):
            losses.append(eval_loss(state, volumes[j:j + 1], gen)["train_loss"])
    return torch.stack(losses).double().cpu().numpy()


def weights_step(path: str) -> Tuple[Optional[int], str]:
    """``(step, storage)`` of a release directory (its ``meta.json``: the
    storage dtype) or a checkpoint directory (its latest step)."""
    if is_release_weights_dir(path):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return meta.get("step"), f"release {meta.get('dtype')}"
    return CheckpointManager(path, None).latest_step(), "checkpoint"


@torch.no_grad()
def round_to_bf16(model: torch.nn.Module, pattern: str) -> List[str]:
    """Round the parameters whose names match ``pattern`` to bf16 in place;
    returns their names."""
    names = [name for name, _ in model.named_parameters() if re.search(pattern, name)]
    params = dict(model.named_parameters())
    for name in names:
        params[name].copy_(params[name].bfloat16())
    return names


def evaluate(path: str, *, batches: int = BATCHES, batch_size: int = BATCH_SIZE,
             side: int = SIDE, seed: int = 0, device=None,
             round_bf16: Optional[str] = None) -> dict:
    """The fixed-evaluation mean of the weights at ``path`` with its standard error."""
    dev = resolve_device(device)
    model, table, config = load(path, ema=True, no_folded=False, dev=dev)
    rounded = [] if round_bf16 is None else round_to_bf16(model, round_bf16)
    start = time.perf_counter()
    losses = fixed_eval_losses(model, table, config, batches=batches, batch_size=batch_size,
                               shape=(side,) * 3, seed=seed, device=dev)
    seconds = time.perf_counter() - start
    mean, se = mean_and_se(losses)
    step, storage = weights_step(path)
    del model
    return {"path": path, "step": step, "storage": storage, "compute_dtype": config.model.dtype,
            "rounded_to_bf16": round_bf16, "rounded_leaves": len(rounded),
            "mean": mean, "se": se, "n": int(losses.size),
            "batch_means": [float(m) for m in losses.reshape(batches, batch_size).mean(axis=1)],
            "seconds": round(seconds, 3)}


def card(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def compare(results: List[dict], windows: List[dict], band: float) -> dict:
    """The band check against the first entry of each list (module docstring)."""
    verdict = {"band": band, "weights": [], "windows": []}
    for r in results[1:]:
        ratio = r["mean"] / results[0]["mean"]
        verdict["weights"].append({"path": r["path"], "ratio": ratio,
                                   "within_band": 1 / band <= ratio <= band})
    for w in windows[1:]:
        se = math.hypot(w["se"], windows[0]["se"])
        diff = w["mean"] - windows[0]["mean"]
        verdict["windows"].append({"path": w["path"], "difference": diff, "combined_se": se,
                                   "within_3se": abs(diff) <= 3 * se})
    verdict["met"] = all(v["within_band"] for v in verdict["weights"]) and all(
        v["within_3se"] for v in verdict["windows"])
    return verdict


def parse_arguments(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--weights", nargs="*", default=[],
                   help="release directories or checkpoint directories of the port")
    p.add_argument("--csv", nargs="*", default=[], help="metrics.csv files of training runs")
    p.add_argument("--window", type=int, nargs=2, default=list(WINDOW),
                   help="the steps of the window mean, inclusive")
    p.add_argument("--batches", type=int, default=BATCHES)
    p.add_argument("--batch-size", type=int, default=BATCH_SIZE)
    p.add_argument("--shape", type=int, default=SIDE, help="the volumes' edge length")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--round-bf16", default=None, metavar="REGEX",
                   help="round the parameters whose names match to bf16 first")
    p.add_argument("--band", type=float, default=None,
                   help="hold every other entry to the first (module docstring)")
    p.add_argument("--json-out", default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_arguments(argv)
    dev = resolve_device(args.device)
    smi = card(dev)
    print(f"device {dev}; {smi}; torch {torch.__version__}", flush=True)
    report = {"device": str(dev), "card": smi, "torch": torch.__version__,
              "set": {"batches": args.batches, "batch_size": args.batch_size,
                      "shape": [args.shape] * 3, "seed": args.seed}}
    results = []
    for path in args.weights:
        r = evaluate(path, batches=args.batches, batch_size=args.batch_size, side=args.shape,
                     seed=args.seed, device=dev, round_bf16=args.round_bf16)
        results.append(r)
        rounded = (f", {r['rounded_leaves']} leaves matching {args.round_bf16!r} rounded to bf16"
                   if args.round_bf16 is not None else "")
        print(f"{path} (step {r['step']}, {r['storage']}{rounded}, {r['compute_dtype']} compute): "
              f"fixed-evaluation loss {r['mean']:.6f} ± {r['se']:.6f} over {r['n']} volumes "
              f"({r['seconds']:.1f} s)", flush=True)
    windows = [window_stats(path, tuple(args.window)) for path in args.csv]
    for w in windows:
        print(f"{w['path']}: train_loss over steps {w['window'][0]}-{w['window'][1]} "
              f"{w['mean']:.6f} ± {w['se']:.6f} ({w['rows']} rows)", flush=True)
    report["weights"], report["windows"] = results, windows
    if args.band is not None:
        report["comparison"] = compare(results, windows, args.band)
        print(f"band {args.band:g}: " + json.dumps(report["comparison"]), flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
