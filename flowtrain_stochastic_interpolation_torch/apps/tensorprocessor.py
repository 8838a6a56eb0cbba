"""Offline renderer for saved sample tensors.

    python -m flowtrain_stochastic_interpolation_torch.apps.tensorprocessor <folder> --device cpu

Port of ``apps/tensorprocessor.py``: every ``.npy`` volume of a folder (the
decoded int volumes that the apps save, or raw ``[..., E]`` embedding
tensors, which are decoded first with a saved table or the frozen simplex
table) rendered as a slice grid and a volume view, and with ``--gif`` as a
rotating-camera GIF where PyVista and imageio are installed. Decoding runs
on ``--device`` (``cuda`` unless ``cpu`` is named); the figures are
matplotlib's.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.ops.embedding import decode, simplex_embedding
from flowtrain_stochastic_interpolation_torch.utils.plotting import (
    plot_2d_slices,
    plot_volume,
    pyvista_available,
)


def load_embedding(path: Optional[str], n_cats: int = 15, dim: int = 18) -> np.ndarray:
    """A saved embedding table, or the frozen simplex table."""
    if path and os.path.exists(path):
        return np.load(path)
    return simplex_embedding(n_cats, dim)


def decode_with_loaded_embedding(tensor: np.ndarray, table: np.ndarray,
                                 device=None) -> np.ndarray:
    """The categories (air = -1) of a raw ``[..., E]`` tensor, decoded on ``device``."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.asarray(tensor, np.float32)).to(dev)
    return decode(x, torch.from_numpy(np.asarray(table, np.float32)).to(dev)).cpu().numpy() - 1


def animate_tensor_to_gif(volume: np.ndarray, save_path: str, n_frames: int = 36) -> bool:
    """Rotating-camera GIF through PyVista and imageio; False without them."""
    if not pyvista_available():
        return False
    try:
        import imageio
        import pyvista as pv
    except ImportError:
        return False
    grid = pv.ImageData(dimensions=np.asarray(volume.shape) + 1)
    grid.cell_data["values"] = volume.flatten(order="F")
    plotter = pv.Plotter(off_screen=True)
    plotter.add_volume(grid, scalars="values")
    frames = []
    for i in range(n_frames):
        plotter.camera.azimuth = 360.0 * i / n_frames
        frames.append(plotter.screenshot(return_img=True))
    plotter.close()
    imageio.mimsave(save_path, frames, fps=12)
    return True


def process_folder_of_tensors(folder: str, out_dir: str, table: np.ndarray, gif: bool,
                              device=None) -> None:
    """Render every saved volume of ``folder`` into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    for fname in sorted(os.listdir(folder)):
        if not fname.endswith(".npy"):
            continue
        vol = np.load(os.path.join(folder, fname))
        stem = os.path.splitext(fname)[0]
        if vol.ndim == 4:  # a raw embedding tensor [..., E]
            vol = decode_with_loaded_embedding(vol, table, device)
        if vol.ndim != 3:
            continue
        plot_2d_slices(vol, save_path=os.path.join(out_dir, f"{stem}_slices.png"))
        plot_volume(vol, save_path=os.path.join(out_dir, f"{stem}_view.png"))
        if gif and not animate_tensor_to_gif(vol, os.path.join(out_dir, f"{stem}.gif")):
            print(f"{stem}: GIF skipped (pyvista/imageio not installed)")
        print(f"rendered {stem}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Render saved sample tensors")
    p.add_argument("folder", help="folder of .npy volumes")
    p.add_argument("--out", default=None, help="output dir (default <folder>/rendered)")
    p.add_argument("--embedding", default=None, help="saved embedding table .npy")
    p.add_argument("--gif", action="store_true", help="also write rotating GIFs")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where raw tensors are decoded")
    args = p.parse_args(argv)
    out = args.out or os.path.join(args.folder, "rendered")
    process_folder_of_tensors(args.folder, out, load_embedding(args.embedding), args.gif,
                              args.device)


if __name__ == "__main__":
    main()
