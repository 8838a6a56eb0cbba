"""Paper figures from saved ensembles and samples.

    python -m flowtrain_stochastic_interpolation_torch.apps.paper_figures
        --experiments-dir <dir> --out-dir <dir> [--samples-dir <dir>] [--geoprocess]

Port of ``apps/paper_figures.py``: dike-probability maps, entropy beside the
true model, realization grids and the volume views of each ``scenario_*``
directory that ``apps.inference_experiments --stage analyze`` writes
(``dike_probability.npy``, ``entropy_air_masked.npy``, ``true_model.npy``,
``boreholes.npy``, ``sol_*.npy``); slice grids and a sample row of the
``decoded*.npy`` volumes of ``--samples-dir``; and with ``--geoprocess`` the
synthetic generator's transformation stages (drawn on ``--device``, ``cuda``
unless ``cpu`` is named). The figures are matplotlib's (PyVista's volume views
where it is installed), from numpy arrays: they need no card.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.data.synthetic import synthetic_geology_stages
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.utils import volview as vv
from flowtrain_stochastic_interpolation_torch.utils.plotting import (
    _mpl,
    plot_2d_slices,
    plot_volume,
)


def dike_probability_figure(scenario_dir: str, out_path: str, threshold: float = 0.15):
    """Dike probability map: max-projection heatmaps + thresholded volume."""
    plt = _mpl()
    prob = np.load(os.path.join(scenario_dir, "dike_probability.npy"))
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, axis, name in zip(axes, (0, 1, 2), "XYZ"):
        im = ax.imshow(prob.max(axis=axis), cmap="magma", vmin=0, vmax=1)
        ax.set_title(f"P(dike) max-projection along {name}")
        ax.axis("off")
    fig.colorbar(im, ax=axes, shrink=0.8, label="probability")
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)

    vol_path = out_path.replace(".png", "_volume.png")
    plot_volume((prob > threshold).astype(np.int8), save_path=vol_path)


def entropy_figure(scenario_dir: str, out_path: str):
    plt = _mpl()
    ent = np.load(os.path.join(scenario_dir, "entropy_air_masked.npy"))
    true = np.load(os.path.join(scenario_dir, "true_model.npy"))
    fig, axes = plt.subplots(2, 3, figsize=(12, 8))
    mid = [s // 2 for s in ent.shape]
    for j, (axis, name) in enumerate(zip((0, 1, 2), "XYZ")):
        im0 = axes[0, j].imshow(np.take(true, mid[axis], axis=axis), cmap="tab20",
                                interpolation="nearest")
        axes[0, j].set_title(f"true, mid-{name}")
        im1 = axes[1, j].imshow(np.take(ent, mid[axis], axis=axis), cmap="viridis")
        axes[1, j].set_title(f"entropy, mid-{name}")
        axes[0, j].axis("off"); axes[1, j].axis("off")
    fig.colorbar(im1, ax=axes[1], shrink=0.8, label="nats")
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def realization_grid(scenario_dir: str, out_path: str, dike_category: int = 13):
    """Grid of dike realizations across the ensemble (ref ``:268-341``)."""
    plt = _mpl()
    sols = sorted(f for f in os.listdir(scenario_dir) if f.startswith("sol_"))
    if not sols:
        return
    n = min(len(sols), 9)
    fig, axes = plt.subplots(3, 3, figsize=(9, 9))
    for i, ax in enumerate(axes.reshape(-1)):
        ax.axis("off")
        if i < n:
            vol = np.load(os.path.join(scenario_dir, sols[i]))
            ax.imshow((vol == dike_category).max(axis=2), cmap="gray_r",
                      interpolation="nearest")
            ax.set_title(f"realization {i}", fontsize=8)
    fig.suptitle("dike realizations (max-projection)")
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def unconditional_sample_grid(samples_dir: str, out_path: str):
    """Slice-grid figure per generated sample (ref ``:237``)."""
    vols = sorted(f for f in os.listdir(samples_dir) if f.startswith("decoded"))
    for i, f in enumerate(vols[:4]):
        vol = np.load(os.path.join(samples_dir, f))
        plot_2d_slices(vol, save_path=out_path.replace(".png", f"_{i}.png"))
    # 1×3 sample row with shared colorbar (ref make_unconditioned_figures :236)
    if len(vols) >= 3:
        row = [np.load(os.path.join(samples_dir, f)) for f in vols[:3]]
        vv.sample_row_figure(row, out_path.replace(".png", "_row.png"))
    vv.standalone_scalarbar(out_path.replace(".png", "_scalarbar.png"))


def volume_view_figures(scenario_dir: str, out_dir: str, folder: str):
    """Volume-view builders (ref ``visualize.py:268-341,675-815``): volview of
    the true model, dike-only views, 2×1 model/boreholes, realization sheet,
    probability contours.  PyVista when present, matplotlib fallbacks here."""
    def load(name):
        path = os.path.join(scenario_dir, name)
        return np.load(path) if os.path.exists(path) else None

    true = load("true_model.npy")
    boreholes = load("boreholes.npy")
    dike_prob = load("dike_probability.npy")
    sols = sorted(f for f in os.listdir(scenario_dir) if f.startswith("sol_"))
    vols = [np.load(os.path.join(scenario_dir, f)) for f in sols[:12]]

    if true is not None:
        vv.volview(true, os.path.join(out_dir, f"{folder}_volview.png"),
                   title="true model")
        vv.dike_view(true, os.path.join(out_dir, f"{folder}_dikes_true.png"))
    if true is not None and boreholes is not None:
        vv.model_and_boreholes_figure(
            true, boreholes, os.path.join(out_dir, f"{folder}_model_boreholes.png"))
    if vols:
        vv.realization_sheet(
            vols, os.path.join(out_dir, f"{folder}_realization_sheet.png"))
    if dike_prob is not None:
        obs = None
        if boreholes is not None:
            obs = boreholes == vv.DIKE_CATEGORY
        vv.probability_contour_view(
            dike_prob, os.path.join(out_dir, f"{folder}_prob_contours.png"),
            observations=obs)


def geoprocess_stages_figure(out_path: str, shape=(64, 64, 64), seed: int = 0,
                             n_examples: int = 3, device=None):
    """The synthetic generator's transformation chain, one random volume a row
    and one stage a column (strata, tilt, fold, dike, topography), each as a
    mid-Y cross-section with depth down and air white. The volumes come from
    :func:`data.synthetic.synthetic_geology_stages` with a generator on
    ``device`` (``cuda`` unless named) seeded with ``seed + row``."""
    dev = resolve_device(device)
    plt = _mpl()
    order = ["strata", "tilt", "fold", "dike", "topography"]
    fig, axes = plt.subplots(n_examples, len(order),
                             figsize=(2.2 * len(order), 2.2 * n_examples),
                             squeeze=False)
    for i in range(n_examples):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + i)
        stages = synthetic_geology_stages(gen, tuple(shape))
        for j, name in enumerate(order):
            vol = stages[name].cpu().numpy()
            sl = vol[:, vol.shape[1] // 2, :].T.astype(np.float32)  # [Z, X]
            sl[sl < 0] = np.nan  # air → white
            ax = axes[i, j]
            ax.imshow(sl, origin="upper", cmap="tab20", interpolation="nearest")
            ax.axis("off")
            if i == 0:
                ax.set_title(name, fontsize=10)
    fig.suptitle("synthetic geology: transformation stages")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Generate paper figures")
    p.add_argument("--experiments-dir", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "cond_experiments"))
    p.add_argument("--samples-dir", default=None)
    p.add_argument("--out-dir", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "figures"))
    p.add_argument("--geoprocess", action="store_true",
                   help="render the synthetic generator's transformation stages")
    p.add_argument("--geoprocess-shape", type=int, default=64)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where --geoprocess draws its volumes")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.geoprocess:
        out = os.path.join(args.out_dir, "geoprocess_stages.png")
        geoprocess_stages_figure(out, shape=(args.geoprocess_shape,) * 3, device=args.device)
        print(f"figures written: {out}")

    if os.path.isdir(args.experiments_dir):
        for folder in sorted(os.listdir(args.experiments_dir)):
            sdir = os.path.join(args.experiments_dir, folder)
            if not os.path.isdir(sdir) or not folder.startswith("scenario"):
                continue
            if os.path.exists(os.path.join(sdir, "dike_probability.npy")):
                dike_probability_figure(
                    sdir, os.path.join(args.out_dir, f"{folder}_dike_prob.png"))
                entropy_figure(
                    sdir, os.path.join(args.out_dir, f"{folder}_entropy.png"))
            realization_grid(
                sdir, os.path.join(args.out_dir, f"{folder}_realizations.png"))
            volume_view_figures(sdir, args.out_dir, folder)
            print(f"figures written for {folder}")

    if args.samples_dir and os.path.isdir(args.samples_dir):
        unconditional_sample_grid(
            args.samples_dir, os.path.join(args.out_dir, "uncond_samples.png"))


if __name__ == "__main__":
    main()
