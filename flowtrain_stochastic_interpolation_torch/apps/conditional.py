"""Conditional 64³ reconstruction: the training CLI.

    python -m flowtrain_stochastic_interpolation_torch.apps.conditional --steps 8

Port of ``apps/conditional.py``: trains ``UNet3DCond`` v3 on borehole and
surface observations with the recipe of ``config.conditional_64`` (AdamW 1e-3,
decay 0.999, clip 0.3, accumulation 4, EMA 0.9995 every micro-step), or the 8³
``tiny_test(conditional=True)`` with ``--preset tiny``, through
``train.loop.train`` with a ``MetricsWriter`` and the ``InferenceCallback``.
Metrics, images and checkpoints go under ``--root-dir``; a second run on the
same directory resumes.

``--device`` is ``cuda`` (the default, one card), ``cpu``, or ``auto``, the
JAX app's default: every visible card, data-parallel with one NCCL rank per
card when there are several (:func:`parallel.launch.run_on_devices`; under
torchrun or SLURM the ranks join that job). Without a card, ``cuda`` and
``auto`` raise. There is no ``--use-wandb``: ``MetricsWriter`` writes the CSV only,
and no machine that runs the port has wandb. Importing this module runs
nothing.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import dataclasses

import torch

from flowtrain_stochastic_interpolation_torch.config import conditional_64, tiny_test
from flowtrain_stochastic_interpolation_torch.parallel.distributed import is_primary
from flowtrain_stochastic_interpolation_torch.parallel.launch import (
    resolve_devices,
    run_on_devices,
)
from flowtrain_stochastic_interpolation_torch.train.callbacks import InferenceCallback
from flowtrain_stochastic_interpolation_torch.train.loop import TrainResult, build_model, train
from flowtrain_stochastic_interpolation_torch.utils.logging import MetricsWriter


def setup_directories(root_dir: str, name: str) -> dict:
    dirs = {
        "checkpoint_dir": os.path.join(root_dir, "saved_models", name),
        "metrics_dir": os.path.join(root_dir, "metrics", name),
        "photo_dir": os.path.join(root_dir, "images", name),
    }
    for p in dirs.values():
        os.makedirs(p, exist_ok=True)
    return dirs


def parse_arguments(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Train the conditional 3D geology model")
    p.add_argument("--steps", type=int, default=None, help="cap training steps")
    p.add_argument("--root-dir", type=str, default=os.path.dirname(os.path.abspath(__file__)))
    p.add_argument("--preset", choices=["flagship", "tiny"], default="flagship",
                   help="tiny = 8^3 smoke config for CPU runs")
    p.add_argument("--device", choices=["cuda", "cpu", "auto"], default="cuda")
    return p.parse_args(argv)


def _train_job(dev: torch.device, args, config, dirs) -> TrainResult:
    """Training on ``dev``, as one rank of a job or alone; the primary rank owns
    the metrics, the callback and the checkpoints."""
    primary = is_primary()
    writer = MetricsWriter(dirs["metrics_dir"]) if primary else None
    callback = InferenceCallback(
        config, build_model(config, device=dev), dirs["photo_dir"],
        every_n_epochs=config.training.inference_every_epochs, writer=writer,
    ) if primary else None
    result = train(config, num_steps=args.steps, checkpoint_dir=dirs["checkpoint_dir"],
                   writer=writer, callback=callback, device=dev)
    if writer:
        writer.close()
    if torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
        result = dataclasses.replace(result, state=None)
    return result


def main(argv: Optional[Sequence[str]] = None) -> TrainResult:
    args = parse_arguments(argv)
    devices = resolve_devices(args.device)
    config = conditional_64() if args.preset == "flagship" else tiny_test(conditional=True)
    dirs = setup_directories(args.root_dir, config.name)
    print(f"device={devices[0] if len(devices) == 1 else devices}")

    result = run_on_devices(_train_job, devices, (args, config, dirs))
    last = result.history[-1]
    print(f"training: {result.steps_per_sec:.3f} steps/s, "
          f"final loss {last['train_loss']:.4f} "
          f"(flow {last['flow_loss']:.4f}, reconstruct {last['reconstruct_loss']:.4f})")
    return result


if __name__ == "__main__":
    main()
