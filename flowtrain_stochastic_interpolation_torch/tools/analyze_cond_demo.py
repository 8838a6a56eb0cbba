"""Quality of a conditional train-demo ensemble against its held-out truth.

Port of the root ``tools/analyze_cond_demo.py``. It reads ``true_model.npy``
and ``sol_*.npy`` from a ``tools/train_demo.py --conditional`` output
directory and reports the observed-voxel accuracy (overall, air, rock), the
accuracy of the ensemble's most probable model on observed and unobserved
voxels, the mean entropy of the vote, the categories in use and the air
fractions (``ops.ensemble``). The observation mask is redrawn as the port's
``train_demo`` drew it: ``make_combined_mask`` on a host generator seeded
with 998. Host-side; it needs no card.

    python -m flowtrain_stochastic_interpolation_torch.tools.analyze_cond_demo \\
        [--dir artifacts/torch/train_demo_cond] [--json-out path]
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.ops import ensemble
from flowtrain_stochastic_interpolation_torch.tools.train_demo import observation_mask

ROOT = Path(__file__).resolve().parents[2]


def analyze(true: np.ndarray, sols: np.ndarray, mask: np.ndarray) -> dict:
    """The JAX tool's report of the ensemble ``sols [S, X, Y, Z]`` against the
    truth ``true [X, Y, Z]`` observed under ``mask`` (air = -1)."""
    true, sols, mask = true.astype(np.int32), sols.astype(np.int32), mask > 0
    air = mask & (true == -1)
    rock = mask & (true != -1)

    def acc(region):
        if region.sum() == 0:
            return float("nan")
        return float((sols[:, region] == true[region][None]).mean())

    probs = ensemble.vote_probabilities(torch.from_numpy(sols), 15)
    mpm = ensemble.most_probable_model(probs).numpy()
    ent = ensemble.entropy(probs).numpy()
    return {
        "n_samples": int(sols.shape[0]),
        "observed_frac": round(float(mask.mean()), 3),
        "obs_acc_overall": round(acc(mask), 3),
        "obs_acc_air": round(acc(air), 3),
        "obs_acc_rock": round(acc(rock), 3),
        "mpm_obs_acc": round(float((mpm[mask] == true[mask]).mean()), 3),
        "mpm_unobs_acc": round(float((mpm[~mask] == true[~mask]).mean()), 3),
        "mean_entropy": round(float(ent.mean()), 3),
        "true_categories": int(len(np.unique(true))),
        "sample_categories": int(len(np.unique(sols))),
        "air_frac_true": round(float((true == -1).mean()), 3),
        "air_frac_samples": round(float((sols == -1).mean()), 3),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=str(ROOT / "artifacts" / "torch" / "train_demo_cond"))
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    true = np.load(os.path.join(args.dir, "true_model.npy")).astype(np.int32)
    sols = np.stack([np.load(os.path.join(args.dir, f)).astype(np.int32)
                     for f in sorted(os.listdir(args.dir)) if f.startswith("sol_")])
    report = analyze(true, sols, observation_mask(torch.from_numpy(true)).numpy())
    print(json.dumps(report))
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(json.dumps(report, indent=1) + "\n")
    return report


if __name__ == "__main__":
    main()
