"""3-D volume-view figures of categorical volumes and probability maps.

A copy of ``flowtrain_stochastic_interpolation_tpu/utils/volview.py``: the
voxel-grid conversion, the volume view, dike-only and probability-contour
views, a volume beside its boreholes, realization sheets, a sample row with a
shared colour bar. Each renders with PyVista where it is installed and falls
back to an equivalent matplotlib figure (orthogonal max-projections, slice
mosaics) where it is not; both are imported only when called. They take
numpy arrays and touch no device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

Bounds = Tuple[Tuple[float, float], ...]
DEFAULT_BOUNDS: Bounds = ((-1920, 1920), (-1920, 1920), (-1920, 1920))
DIKE_CATEGORY = 13  # last rock category in the GeoGen convention


def _pv():
    try:
        import pyvista as pv

        return pv
    except ImportError:
        return None


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def voxel_grid_from_tensor(data: np.ndarray, bounds: Bounds = DEFAULT_BOUNDS,
                           threshold: Optional[float] = None):
    """``pv.ImageData`` voxel grid from a ``[X, Y, Z]`` categorical volume.

    Cell-centred: n+1 nodes per axis, origin shifted by half a cell, values
    raveled in Fortran order (the layout PyVista expects for cell data).
    Reference: ``visualize.py:788-812``.
    """
    pv = _pv()
    if pv is None:
        raise RuntimeError("pyvista not installed")
    data = np.asarray(data)
    assert data.ndim == 3, "expected a [X, Y, Z] volume"
    dims = data.shape
    spacing = tuple((b[1] - b[0]) / (r - 1) for b, r in zip(bounds, dims))
    origin = tuple(b[0] - s / 2 for b, s in zip(bounds, spacing))
    grid = pv.ImageData(dimensions=tuple(d + 1 for d in dims),
                        spacing=spacing, origin=origin)
    grid["values"] = data.ravel(order="F")
    if threshold is not None:
        grid = grid.threshold(threshold, all_scalars=True)
    return grid


def _projections(vol: np.ndarray, reduce=np.max):
    return [reduce(vol, axis=a) for a in (0, 1, 2)]


def volview(vol: np.ndarray, save_path: str, *, bounds: Bounds = DEFAULT_BOUNDS,
            threshold: float = -0.5, clim=None, title: str = "") -> str:
    """Volumetric categorical view (reference ``volview`` ``:675-737``).

    PyVista: thresholded voxel grid with axes + bounds.  Fallback: three
    orthogonal max-projections.
    """
    pv = _pv()
    if pv is not None:
        grid = voxel_grid_from_tensor(vol, bounds, threshold)
        p = pv.Plotter(off_screen=True, window_size=(800, 800))
        kw = {"clim": clim} if clim else {}
        p.add_mesh(grid, scalars="values", cmap="gist_ncar",
                   interpolate_before_map=False, **kw)
        p.add_axes(line_width=5)
        p.show_bounds(grid="back", location="outer", ticks="outside")
        p.screenshot(save_path)
        p.close()
        return save_path

    plt = _mpl()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    shown = np.where(vol > threshold, vol, np.nan)
    for ax, proj, name in zip(axes, _projections(np.nan_to_num(shown, nan=-2)),
                              "XYZ"):
        ax.imshow(np.where(proj <= threshold, np.nan, proj), cmap="gist_ncar",
                  interpolation="nearest", vmin=-1, vmax=13)
        ax.set_title(f"max-projection ⊥{name}")
        ax.axis("off")
    if title:
        fig.suptitle(title)
    fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def dike_view(vol: np.ndarray, save_path: str, *,
              dike_category: int = DIKE_CATEGORY,
              bounds: Bounds = DEFAULT_BOUNDS, title: str = "") -> str:
    """Dike-only view (reference ``plot_only_dikes`` usage ``:268-341``)."""
    mask = (np.asarray(vol) == dike_category).astype(np.int8)
    pv = _pv()
    if pv is not None:
        grid = voxel_grid_from_tensor(mask, bounds, threshold=0.5)
        p = pv.Plotter(off_screen=True, window_size=(800, 800))
        if grid.n_cells:
            p.add_mesh(grid, color="red", show_scalar_bar=False)
        p.add_axes(line_width=5)
        p.screenshot(save_path)
        p.close()
        return save_path

    plt = _mpl()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, proj, name in zip(axes, _projections(mask), "XYZ"):
        ax.imshow(proj, cmap="gray_r", interpolation="nearest")
        ax.set_title(f"dikes ⊥{name}")
        ax.axis("off")
    if title:
        fig.suptitle(title)
    fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def probability_contour_view(prob: np.ndarray, save_path: str, *,
                             contour_values: Sequence[float] = (0.05, 0.3, 0.6, 0.9),
                             observations: Optional[np.ndarray] = None,
                             bounds: Bounds = DEFAULT_BOUNDS) -> str:
    """Probability iso-contours + observed voxels
    (reference ``plot_estimated_dike_with_samples`` ``:191-231``)."""
    pv = _pv()
    if pv is not None:
        grid = voxel_grid_from_tensor(prob, bounds)
        p = pv.Plotter(off_screen=True, window_size=(800, 800))
        contour = grid.cell_data_to_point_data().contour(list(contour_values),
                                                         scalars="values")
        p.add_mesh(contour, opacity=0.3, cmap="Wistia", show_scalar_bar=False)
        if observations is not None:
            obs = voxel_grid_from_tensor(
                observations.astype(np.int8), bounds, threshold=0.5)
            if obs.n_cells:
                p.add_mesh(obs, color="red", show_scalar_bar=False)
        p.add_scalar_bar("probability contour", vertical=False, fmt="%.2f",
                         n_labels=len(contour_values))
        bb = pv.Box([v for b in bounds for v in b])
        p.add_mesh(bb, color="black", style="wireframe", line_width=2, opacity=0.2)
        p.screenshot(save_path)
        p.close()
        return save_path

    plt = _mpl()
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    for ax, axis, name in zip(axes, (0, 1, 2), "XYZ"):
        proj = np.asarray(prob).max(axis=axis)
        im = ax.imshow(proj, cmap="Wistia", vmin=0, vmax=1)
        cs = ax.contour(proj, levels=list(contour_values), colors="k",
                        linewidths=0.7)
        ax.clabel(cs, inline=True, fontsize=6, fmt="%.2f")
        if observations is not None:
            om = np.asarray(observations).max(axis=axis)
            ys, xs = np.nonzero(om)
            ax.scatter(xs, ys, s=1.5, c="red")
        ax.set_title(f"P max-projection ⊥{name}")
        ax.axis("off")
    fig.colorbar(im, ax=axes, shrink=0.8, label="probability")
    fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def model_and_boreholes_figure(model: np.ndarray, boreholes: np.ndarray,
                               save_path: str, *,
                               dike_category: int = DIKE_CATEGORY,
                               bounds: Bounds = DEFAULT_BOUNDS) -> str:
    """2×1 linked view: dikes in the true model vs in the borehole samples
    (reference ``make_2x1_model_borehole_plot`` ``:289-307``)."""
    pv = _pv()
    if pv is not None:
        p = pv.Plotter(shape=(2, 1), off_screen=True, window_size=(900, 1800),
                       border=False)
        for row, vol in enumerate((model, boreholes)):
            p.subplot(row, 0)
            grid = voxel_grid_from_tensor(
                (np.asarray(vol) == dike_category).astype(np.int8), bounds, 0.5)
            if grid.n_cells:
                p.add_mesh(grid, color="red", show_scalar_bar=False)
            p.show_bounds(grid="back", location="outer")
        p.link_views()
        p.screenshot(save_path)
        p.close()
        return save_path

    plt = _mpl()
    fig, axes = plt.subplots(2, 3, figsize=(12, 8))
    for row, (vol, label) in enumerate(((model, "true model"),
                                        (boreholes, "borehole samples"))):
        mask = (np.asarray(vol) == dike_category).astype(np.int8)
        for ax, proj, name in zip(axes[row], _projections(mask), "XYZ"):
            ax.imshow(proj, cmap="gray_r", interpolation="nearest")
            ax.set_title(f"{label} dikes ⊥{name}", fontsize=9)
            ax.axis("off")
    fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def realization_sheet(vols: Sequence[np.ndarray], save_path: str, *,
                      rows: int = 3, cols: int = 4,
                      dike_category: int = DIKE_CATEGORY,
                      bounds: Bounds = DEFAULT_BOUNDS) -> str:
    """r×c sheet of dike realizations across an ensemble
    (reference ``make_nxn_dike_realization_plot`` ``:310-341``)."""
    vols = list(vols)[: rows * cols]
    pv = _pv()
    if pv is not None:
        p = pv.Plotter(shape=(rows, cols), off_screen=True,
                       window_size=(400 * cols, 400 * rows), border=False)
        for i, vol in enumerate(vols):
            p.subplot(i // cols, i % cols)
            grid = voxel_grid_from_tensor(
                (np.asarray(vol) == dike_category).astype(np.int8), bounds, 0.5)
            if grid.n_cells:
                p.add_mesh(grid, color="red", show_scalar_bar=False)
            p.show_bounds(grid="back", location="outer")
        p.screenshot(save_path)
        p.close()
        return save_path

    plt = _mpl()
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    for i, ax in enumerate(np.asarray(axes).reshape(-1)):
        ax.axis("off")
        if i < len(vols):
            mask = np.asarray(vols[i]) == dike_category
            ax.imshow(mask.max(axis=2), cmap="gray_r", interpolation="nearest")
            ax.set_title(f"realization {i}", fontsize=8)
    fig.suptitle("dike realizations (max-projection ⊥Z)")
    fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def sample_row_figure(vols: Sequence[np.ndarray], save_path: str, *,
                      labels: Optional[Sequence[str]] = None,
                      bounds: Bounds = DEFAULT_BOUNDS) -> str:
    """1×N sample row with one shared colorbar
    (reference ``make_1x3_subplot_with_single_colorbar`` usage ``:236-262``)."""
    vols = list(vols)
    labels = labels or [f"({chr(97 + i)})" for i in range(len(vols))]
    pv = _pv()
    if pv is not None:
        p = pv.Plotter(shape=(1, len(vols)), off_screen=True,
                       window_size=(500 * len(vols), 520), border=False)
        for i, vol in enumerate(vols):
            p.subplot(0, i)
            grid = voxel_grid_from_tensor(np.asarray(vol), bounds, threshold=-0.5)
            p.add_mesh(grid, scalars="values", cmap="gist_ncar",
                       interpolate_before_map=False,
                       show_scalar_bar=(i == len(vols) - 1))
            p.add_text(labels[i], font_size=14)
        p.screenshot(save_path)
        p.close()
        return save_path

    plt = _mpl()
    fig, axes = plt.subplots(1, len(vols), figsize=(4 * len(vols), 4))
    axes = np.atleast_1d(axes)
    for ax, vol, label in zip(axes, vols, labels):
        vol = np.asarray(vol)
        im = ax.imshow(np.where(vol.max(axis=2) < -0.5, np.nan, vol.max(axis=2)),
                       cmap="gist_ncar", vmin=-1, vmax=13,
                       interpolation="nearest")
        ax.set_title(label)
        ax.axis("off")
    fig.colorbar(im, ax=axes, shrink=0.8, label="rock category")
    fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def standalone_scalarbar(save_path: str, n_cats: int = 15) -> str:
    """Standalone categorical colorbar (reference ``make_standalone_scalarbar``)."""
    plt = _mpl()
    import matplotlib as mpl

    fig, ax = plt.subplots(figsize=(6, 1))
    cmap = plt.get_cmap("gist_ncar", n_cats)
    norm = mpl.colors.Normalize(vmin=-1, vmax=n_cats - 2)
    fig.colorbar(mpl.cm.ScalarMappable(norm=norm, cmap=cmap), cax=ax,
                 orientation="horizontal", label="rock category (-1 = air)")
    fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path
