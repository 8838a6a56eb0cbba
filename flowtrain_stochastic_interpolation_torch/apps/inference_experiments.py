"""Conditional inference experiments: scenarios -> ensembles -> statistics.

    python -m flowtrain_stochastic_interpolation_torch.apps.inference_experiments \
        --stage all --save-dir cond_experiments

Port of ``apps/inference_experiments.py``, in three stages:

1. ``create-data``: ``--n-scenarios`` synthetic volumes (one batch of the
   configured dataset, seed 0), the port's combined borehole and surface
   mask of scenario ``s`` drawn from a generator seeded with ``s``, saved
   as ``true_model.npy`` and ``boreholes.npy`` (unobserved
   voxels -1), int8, under ``scenario_<s>/``;
2. ``populate``: for each scenario, the mask ``(boreholes != -1) | (true ==
   -1)``, ``ATb = embed(true)·mask`` and an ensemble of ``--n-samples``
   conditional samples from one sampler for every scenario (batch ``b``'s
   noise seeded with ``42 + b``), saved as ``sol_<i>.npy`` (``decoded - 1``,
   int8); ``--method`` picks the solver (``sde``: the velocity SDE at
   ``--sde-epsilon`` with the linear-decay schedule);
3. ``analyze``: vote probabilities, entropy, air-masked entropy, the most
   probable model and the dike probability (``ops/ensemble.py``), saved as
   ``.npy``, and the most probable model's voxel accuracy against the truth.

Weights come from ``--checkpoint-path`` (a reference ``.ckpt``, a release
directory or a checkpoint directory of the port), else a seeded fresh init
with a warning; nothing is downloaded. ``--device`` is ``cuda`` (the default) or
``cpu``. Importing this module runs nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.apps.unconditional import load_weights
from flowtrain_stochastic_interpolation_torch.config import conditional_64, tiny_test
from flowtrain_stochastic_interpolation_torch.data.geogen import get_dataset
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.inference import (
    SampleResult,
    build_atb,
    make_sampler,
    sample_conditional,
)
from flowtrain_stochastic_interpolation_torch.ops import ensemble as ens
from flowtrain_stochastic_interpolation_torch.ops.masks import make_combined_mask

DIKE_CATEGORY = 13
ENSEMBLE_SEED = 42


def _scenarios(save_dir: str):
    for folder in sorted(os.listdir(save_dir)):
        path = os.path.join(save_dir, folder)
        if os.path.isdir(path) and folder.startswith("scenario"):
            yield folder, path


def create_cond_data(save_dir: str, n_scenarios: int, config, seed: int = 0,
                     device=None) -> None:
    """The scenarios' true volumes and observed boreholes (unobserved = -1)."""
    dev = resolve_device(device)
    # GeoGen's batches are numpy arrays on the host, the synthetic ones tensors on dev
    volumes = torch.as_tensor(
        next(get_dataset(config.data, seed=seed, device=dev).batches(n_scenarios)), device=dev)
    for s in range(n_scenarios):
        folder = os.path.join(save_dir, f"scenario_{s}")
        os.makedirs(folder, exist_ok=True)
        true = volumes[s]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + s)
        mask = make_combined_mask(gen, true[None])[0]
        boreholes = torch.where(mask, true, torch.full_like(true, -1))
        np.save(os.path.join(folder, "true_model.npy"), true.cpu().numpy().astype(np.int8))
        np.save(os.path.join(folder, "boreholes.npy"), boreholes.cpu().numpy().astype(np.int8))
        print(f"scenario {s}: observed {float(mask.float().mean()):.3%} of voxels")


def load_model_with_ema_option(config, checkpoint_path: Optional[str], use_ema: bool,
                               device=None):
    """``(model, table)`` with the EMA weights where ``use_ema`` and the weights
    have them. Kept under the JAX app's name only; it is
    :func:`apps.unconditional.load_weights`."""
    return load_weights(config, checkpoint_path, use_ema, device)


def populate_solutions(save_dir: str, model, table: torch.Tensor, config, args,
                       device=None) -> Dict[str, SampleResult]:
    """An ensemble per scenario from one sampler; ``{folder: SampleResult}``."""
    dev = resolve_device(device)
    ic = config.inference
    sampler = make_sampler(model, table.to(dev), conditional=True, t0=ic.t0, tf=ic.tf,
                           n_frames=ic.n_frames, substeps=ic.substeps, method=ic.method,
                           sde_epsilon=args.sde_epsilon)
    results = {}
    for folder, path in _scenarios(save_dir):
        true = torch.from_numpy(np.load(os.path.join(path, "true_model.npy"))).long().to(dev)
        boreholes = torch.from_numpy(np.load(os.path.join(path, "boreholes.npy"))).long().to(dev)
        mask = (boreholes != -1) | (true == -1)
        atb = build_atb(true, mask, table.to(dev))
        result = sample_conditional(model, table, atb, n_samples=args.n_samples,
                                    batch_size=args.batch_size, seed=ENSEMBLE_SEED,
                                    device=dev, sampler=sampler, method=ic.method)
        for i in range(result.decoded.shape[0]):
            np.save(os.path.join(path, f"sol_{i}.npy"), (result.decoded[i] - 1).astype(np.int8))
        results[folder] = result
        print(f"{folder}: {args.n_samples} solutions in {sum(result.seconds_per_batch):.1f}s")
    return results


def ensemble_analysis(save_dir: str, config, dike_category: int = DIKE_CATEGORY,
                      device=None) -> Dict[str, float]:
    """The ensemble maps per scenario; ``{folder: voxel accuracy of the most
    probable model}``."""
    dev = resolve_device(device)
    n_cats = config.data.num_categories
    accuracies = {}
    for folder, path in _scenarios(save_dir):
        sols = [np.load(os.path.join(path, f)) for f in sorted(os.listdir(path))
                if f.startswith("sol_")]
        if not sols:
            continue
        probs = ens.vote_probabilities(torch.from_numpy(np.stack(sols)).to(dev), n_cats)
        most_probable = ens.most_probable_model(probs)
        maps = {
            "probability_tensor": probs,
            "entropy": ens.entropy(probs),
            "entropy_air_masked": ens.air_masked_entropy(probs),
            "most_probable": most_probable.to(torch.int8),
            "dike_probability": ens.category_probability(probs, dike_category),
        }
        for name, value in maps.items():
            np.save(os.path.join(path, f"{name}.npy"), value.cpu().numpy())
        true = np.load(os.path.join(path, "true_model.npy"))
        accuracies[folder] = float((most_probable.cpu().numpy() == true).mean())
        print(f"{folder}: ensemble={len(sols)}, voxel accuracy vs truth "
              f"{accuracies[folder]:.3f}")
    return accuracies


def parse_arguments(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Conditional ensemble experiments")
    p.add_argument("--stage", choices=["create-data", "populate", "analyze", "all"],
                   default="all")
    p.add_argument("--n-samples", type=int, default=8)
    p.add_argument("--n-scenarios", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--checkpoint-path", type=str, default=None,
                   help="reference .ckpt, release-weights directory or checkpoint "
                        "directory of this port")
    p.add_argument("--preset", choices=["flagship", "tiny"], default="flagship")
    p.add_argument("--save-dir", type=str,
                   default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "cond_experiments"))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--method", default=None, choices=["euler", "heun", "midpoint", "rk4", "sde"],
                   help="the ensemble's solver in place of the recipe's ('sde': "
                        "Euler–Maruyama with the velocity-recovered score)")
    p.add_argument("--sde-epsilon", type=float, default=0.5,
                   help="diffusion strength of --method sde (linear-decay schedule)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the stages; returns ``{"populate": {folder: SampleResult} or None,
    "analyze": {folder: accuracy} or None}``."""
    args = parse_arguments(argv)
    dev = resolve_device(args.device)
    config = conditional_64() if args.preset == "flagship" else tiny_test(conditional=True)
    if args.method is not None:
        config = dataclasses.replace(
            config, inference=dataclasses.replace(config.inference, method=args.method))
    os.makedirs(args.save_dir, exist_ok=True)
    out = {"populate": None, "analyze": None}

    if args.stage in ("create-data", "all"):
        create_cond_data(args.save_dir, args.n_scenarios, config, device=dev)
    if args.stage in ("populate", "all"):
        model, table = load_model_with_ema_option(config, args.checkpoint_path, args.use_ema,
                                                  device=dev)
        out["populate"] = populate_solutions(args.save_dir, model, table, config, args,
                                             device=dev)
    if args.stage in ("analyze", "all"):
        out["analyze"] = ensemble_analysis(args.save_dir, config, device=dev)
    return out


if __name__ == "__main__":
    main()
