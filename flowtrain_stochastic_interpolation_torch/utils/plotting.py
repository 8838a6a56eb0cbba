"""Slice mosaics of categorical volumes and prominence heatmaps (matplotlib).

The two plots of ``flowtrain_stochastic_interpolation_tpu/utils/plotting.py``
that the training callback and the app draw, copied: ``plot_2d_slices`` and
``plot_prominence_maps``. They take numpy arrays, touch no device, and import
matplotlib only when called.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_2d_slices(
    volume: np.ndarray,
    n_slices: int = 64,
    axis: int = 2,
    save_path: Optional[str] = None,
    cmap: str = "tab20",
    title: Optional[str] = None,
):
    """8×8 grid of z-slices of a categorical volume (reference ``utils.py:32-92``)."""
    plt = _mpl()
    volume = np.asarray(volume)
    n_slices = min(n_slices, volume.shape[axis])
    grid = math.ceil(math.sqrt(n_slices))
    idxs = np.linspace(0, volume.shape[axis] - 1, n_slices).astype(int)
    fig, axes = plt.subplots(grid, grid, figsize=(1.4 * grid, 1.4 * grid))
    axes = np.atleast_1d(axes).reshape(-1)
    vmin, vmax = volume.min(), volume.max()
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n_slices:
            sl = np.take(volume, idxs[i], axis=axis)
            ax.imshow(sl, cmap=cmap, vmin=vmin, vmax=vmax, interpolation="nearest")
    if title:
        fig.suptitle(title)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


def plot_prominence_maps(
    prominence: np.ndarray, save_path: Optional[str] = None, axis: int = 2
):
    """Uncertainty (top1−top2) slice heatmaps (reference ``callbacks.py:89-169``)."""
    plt = _mpl()
    prominence = np.asarray(prominence)
    idxs = np.linspace(0, prominence.shape[axis] - 1, 16).astype(int)
    fig, axes = plt.subplots(4, 4, figsize=(8, 8))
    for i, ax in enumerate(axes.reshape(-1)):
        ax.axis("off")
        sl = np.take(prominence, idxs[i], axis=axis)
        im = ax.imshow(sl, cmap="viridis", vmin=0.0, vmax=1.0)
    fig.colorbar(im, ax=axes, shrink=0.7)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig
