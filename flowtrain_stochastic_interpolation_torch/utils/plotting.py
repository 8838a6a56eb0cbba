"""Plots of the port's samples (matplotlib; PyVista where installed).

A copy of ``flowtrain_stochastic_interpolation_tpu/utils/plotting.py``: image
grids, interpolation sequences and GIFs, slice mosaics of categorical volumes,
prominence heatmaps, ensemble solutions, a volume beside its boreholes, 2-D
trajectories and volume renderings (orthogonal slices without PyVista). They
take numpy arrays (or tensors that numpy converts), touch no device, and
import matplotlib, imageio and pyvista only when called.
:func:`make_interpolation_sequence` takes the port's interpolants.
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


def denormalize_images(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 (reference ``denormalize_images`` :69-74)."""
    x = np.clip(np.asarray(x), -1.0, 1.0)
    return ((x + 1.0) * 127.5).astype(np.uint8)


def show_images(images, n_cols: int = 8, save_path: Optional[str] = None, title=None):
    """Grid of [N, H, W(, C)] images (reference ``show_images`` :11-57)."""
    plt = _mpl()
    images = np.asarray(images)
    n = images.shape[0]
    n_rows = math.ceil(n / n_cols)
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(1.6 * n_cols, 1.6 * n_rows))
    axes = np.atleast_1d(axes).reshape(-1)
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            img = images[i]
            ax.imshow(img.squeeze(), cmap="gray" if img.ndim == 2 or img.shape[-1] == 1 else None)
    if title:
        fig.suptitle(title)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


def make_interpolation_sequence(interpolant, x0, x1, z=None, n_steps: int = 10):
    """XT snapshots ``[n_steps, B, ...]`` on a linear time grid from 0 to 1, of
    the port's ``interpolant`` between the tensors ``x0`` and ``x1`` (and ``z``)."""
    import torch

    ts = np.linspace(0.0, 1.0, n_steps)
    frames = []
    for t in ts:
        tb = torch.full((x0.shape[0],), float(t), dtype=torch.float32, device=x0.device)
        frames.append(interpolant.get_xt(tb, x0, x1, z).detach().cpu().numpy())
    return np.stack(frames, axis=0)


def show_time_series(frames, save_path: Optional[str] = None):
    """Mosaic of an interpolation sequence [T, B, H, W(, C)] (ref ``:110-124``)."""
    plt = _mpl()
    frames = np.asarray(frames)
    t_len, b = frames.shape[0], frames.shape[1]
    fig, axes = plt.subplots(b, t_len, figsize=(1.4 * t_len, 1.4 * b))
    axes = np.atleast_2d(axes)
    for i in range(b):
        for j in range(t_len):
            axes[i, j].axis("off")
            axes[i, j].imshow(frames[j, i].squeeze(), cmap="gray")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


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


def make_interpolation_gif(frames, save_path: str, fps: int = 8) -> bool:
    """GIF of an interpolation sequence [T, H, W(, C)] (reference ``:127-170``).

    Needs imageio; returns False (no-op) when unavailable.
    """
    try:
        import imageio
    except ImportError:
        return False
    frames = np.asarray(frames)
    u8 = denormalize_images(frames)
    if u8.ndim == 4 and u8.shape[-1] == 1:
        u8 = u8[..., 0]
    imageio.mimsave(save_path, list(u8), fps=fps)
    return True


def animate_batch(trajectory, save_path: str, fps: int = 8, n_cols: int = 4) -> bool:
    """GIF animating a batch through time [T, B, H, W(, C)] (ref ``:173-210``)."""
    try:
        import imageio
    except ImportError:
        return False
    traj = np.asarray(trajectory)
    t_len, b = traj.shape[0], traj.shape[1]
    n_cols = min(n_cols, b)
    n_rows = math.ceil(b / n_cols)
    frames = []
    for t in range(t_len):
        imgs = denormalize_images(traj[t])
        if imgs.ndim == 4 and imgs.shape[-1] == 1:
            imgs = imgs[..., 0]
        h, w = imgs.shape[1:3]
        canvas_shape = (n_rows * h, n_cols * w) + imgs.shape[3:]
        canvas = np.zeros(canvas_shape, dtype=np.uint8)
        for i in range(b):
            r, c = divmod(i, n_cols)
            canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = imgs[i]
        frames.append(canvas)
    imageio.mimsave(save_path, frames, fps=fps)
    return True


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


def show_solutions(solutions, save_path: Optional[str] = None, axis: int = 2):
    """Grid of ensemble solutions, mid-slice each (reference
    ``model_inference_experiments.py:320-340`` viewer)."""
    plt = _mpl()
    sols = np.asarray(solutions)
    n = sols.shape[0]
    cols = min(n, 3)
    rows = math.ceil(n / cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    axes = np.atleast_1d(axes).reshape(-1)
    vmin, vmax = sols.min(), sols.max()
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            sl = np.take(sols[i], sols[i].shape[axis] // 2, axis=axis)
            ax.imshow(sl, cmap="tab20", vmin=vmin, vmax=vmax, interpolation="nearest")
            ax.set_title(f"solution {i}", fontsize=8)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


def show_model_and_boreholes(true_model, boreholes, save_path: Optional[str] = None):
    """Truth next to its sparse observations (reference
    ``show_model_and_boreholes``, ``model_inference_experiments.py:343-352``)."""
    plt = _mpl()
    true_model = np.asarray(true_model)
    boreholes = np.asarray(boreholes)
    fig, axes = plt.subplots(2, 3, figsize=(10, 7))
    vmin, vmax = true_model.min(), true_model.max()
    for j, axis in enumerate((0, 1, 2)):
        mid = true_model.shape[axis] // 2
        axes[0, j].imshow(np.take(true_model, mid, axis=axis), cmap="tab20",
                          vmin=vmin, vmax=vmax, interpolation="nearest")
        axes[0, j].set_title(f"true, mid-{'XYZ'[axis]}", fontsize=8)
        # observed voxels only (unobserved = -1 sentinel shown as background)
        obs = np.take(boreholes, mid, axis=axis).astype(float)
        obs[obs == -1] = np.nan
        axes[1, j].imshow(obs, cmap="tab20", vmin=vmin, vmax=vmax,
                          interpolation="nearest")
        axes[1, j].set_title("observations", fontsize=8)
        axes[0, j].axis("off"); axes[1, j].axis("off")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


def plot_trajectories(trajectory: np.ndarray, save_path: Optional[str] = None):
    """2D ODE trajectories [T, N, 2] (reference ``plot_trajectories`` :229-264)."""
    plt = _mpl()
    traj = np.asarray(trajectory)
    fig, ax = plt.subplots(figsize=(6, 6))
    for i in range(traj.shape[1]):
        ax.plot(traj[:, i, 0], traj[:, i, 1], alpha=0.5, lw=0.8)
    ax.scatter(traj[0, :, 0], traj[0, :, 1], s=6, c="tab:blue", label="x0")
    ax.scatter(traj[-1, :, 0], traj[-1, :, 1], s=6, c="tab:red", label="x1")
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


def pyvista_available() -> bool:
    try:
        import pyvista  # noqa: F401

        return True
    except ImportError:
        return False


def plot_volume(volume: np.ndarray, save_path: Optional[str] = None, threshold=None):
    """3D voxel rendering via PyVista when available (reference ``:213-226``);
    falls back to a 3-plane orthogonal slice figure otherwise."""
    if pyvista_available():
        import pyvista as pv

        grid = pv.ImageData(dimensions=np.asarray(volume.shape) + 1)
        grid.cell_data["values"] = np.asarray(volume).flatten(order="F")
        plotter = pv.Plotter(off_screen=save_path is not None)
        plotter.add_volume(grid, scalars="values")
        if save_path:
            plotter.screenshot(save_path)
            plotter.close()
            return None
        return plotter
    # fallback: orthogonal mid-slices
    plt = _mpl()
    v = np.asarray(volume)
    fig, axes = plt.subplots(1, 3, figsize=(10, 3.5))
    for ax, (axis, name) in zip(axes, enumerate("XYZ")):
        ax.imshow(np.take(v, v.shape[axis] // 2, axis=axis), cmap="tab20",
                  interpolation="nearest")
        ax.set_title(f"mid-{name}")
        ax.axis("off")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig
