"""Distributional quality of generated volumes against the data prior.

Port of the root ``tools/eval_samples.py``: cheap statistics of a set of
generated samples beside a reference batch drawn from the training data's
generator (``data.synthetic.synthetic_geology_batch``, on the card unless
``--device cpu``):

* per-category voxel frequency (generated and prior) and the total-variation
  distance between the two distributions;
* the air fraction of each Z layer, bottom to top, and its mean absolute
  deviation from the prior's profile;
* the number of categories in each sample.

    python -m flowtrain_stochastic_interpolation_torch.tools.eval_samples \\
        --samples 'artifacts/torch/train_demo/sample_*.npy' [--ref-batch 64] \\
        [--shape 64] [--seed 0] [--json-out path] [--device cpu]

Samples are int8 or int32 ``[X, Y, Z]`` volumes in GeoGen's convention (air =
-1, rock categories 0..13). The statistics are numpy on the host.
"""

from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.data.synthetic import synthetic_geology_batch
from flowtrain_stochastic_interpolation_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]


def category_histogram(vols: np.ndarray, n_categories: int = 15) -> np.ndarray:
    """Normalised frequency over {air = -1, 0..n_categories-2}: ``[n_categories]``."""
    flat = vols.reshape(-1).astype(np.int64) + 1  # air -> 0
    counts = np.bincount(flat, minlength=n_categories)[:n_categories]
    return counts / max(counts.sum(), 1)


def air_depth_profile(vols: np.ndarray) -> np.ndarray:
    """Air fraction per Z layer, bottom (z = 0) to top: ``[Z]``."""
    return (vols == -1).mean(axis=tuple(range(vols.ndim - 1)))


def prior_batch(n: int, side: int, seed: int, device) -> np.ndarray:
    """``n`` synthetic ``side³`` volumes from a generator on ``device`` seeded with
    ``seed``, as int32 numpy."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return synthetic_geology_batch(gen, n, (side,) * 3).cpu().numpy().astype(np.int32)


def report(gen: np.ndarray, ref: np.ndarray) -> dict:
    """The JAX tool's report of generated volumes ``gen [N, X, Y, Z]`` against the
    prior batch ``ref``."""
    gen, ref = gen.astype(np.int32), ref.astype(np.int32)
    hist_gen = category_histogram(gen)
    hist_ref = category_histogram(ref)
    tv = 0.5 * float(np.abs(hist_gen - hist_ref).sum())

    prof_gen = air_depth_profile(gen)
    # the prior's profile at the generated Z resolution (profiles are smooth)
    prof_ref = air_depth_profile(ref)
    if prof_ref.shape != prof_gen.shape:
        prof_ref = np.interp(np.linspace(0.0, 1.0, prof_gen.shape[0]),
                             np.linspace(0.0, 1.0, prof_ref.shape[0]), prof_ref)
    profile_mad = float(np.abs(prof_gen - prof_ref).mean())

    def ends(prof):
        return [round(float(prof[0]), 3), round(float(prof[len(prof) // 2]), 3),
                round(float(prof[-1]), 3)]

    return {
        "n_samples": int(gen.shape[0]),
        "sample_shape": list(gen.shape[1:]),
        "category_tv_distance": round(tv, 4),
        "air_fraction": {"generated": round(float(hist_gen[0]), 4),
                         "prior": round(float(hist_ref[0]), 4)},
        "air_profile_mad": round(profile_mad, 4),
        "air_profile_generated_bottom_mid_top": ends(prof_gen),
        "air_profile_prior_bottom_mid_top": ends(prof_ref),
        "categories_per_sample": [int(len(np.unique(v))) for v in gen],
        "category_freq_generated": [round(float(v), 4) for v in hist_gen],
        "category_freq_prior": [round(float(v), 4) for v in hist_ref],
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--samples", default=str(ROOT / "artifacts" / "torch" / "train_demo"
                                            / "sample_*.npy"),
                   help="glob of generated [X,Y,Z] .npy volumes (air=-1)")
    p.add_argument("--ref-batch", type=int, default=64,
                   help="number of prior volumes to draw for the reference stats")
    p.add_argument("--shape", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json-out", default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    paths = sorted(glob.glob(args.samples))
    if not paths:
        raise SystemExit(f"no samples match {args.samples!r}")
    gen = np.stack([np.load(path) for path in paths]).astype(np.int32)
    ref = prior_batch(args.ref_batch, args.shape, args.seed, dev)
    result = report(gen, ref)
    out = json.dumps(result, indent=2)
    print(out)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(out + "\n")
    return result


if __name__ == "__main__":
    main()
