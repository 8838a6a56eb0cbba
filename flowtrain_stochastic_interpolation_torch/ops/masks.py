"""Observation masks of the conditional problem: boreholes and the surface.

Port of ``flowtrain_stochastic_interpolation_tpu/ops/masks.py``, vectorised
over the batch on the tensors' device:

* boreholes (:func:`make_boreholes_mask`): per item, ``n_bores ~ U{lo..hi-1}``
  full-depth vertical columns on a jittered ⌊√n⌋ × ⌈n/⌊√n⌋⌉ grid of (x, y)
  points, truncated row-major to n (at most 8 × 8 cells, as in JAX);
* surface (:func:`make_surface_mask`): the top z-slice, every air voxel
  (category -1) and the voxel just below each air voxel;
* combined: their union;
* reduced (:func:`make_boreholes_reduced_mask`,
  :func:`make_combined_reduced_mask`): boreholes start ``depth`` voxels below
  the lowest air voxel of their column. As in the JAX package, a column
  qualifies only if it really contains air.

Each random draw is split from its deterministic part: the draws come from a
``torch.Generator`` (``n_bores`` by ``randint``, then the jitter by ``rand``),
and :func:`boreholes_from_draws`, :func:`reduced_boreholes` and
:func:`combined_reduced` take them (or the JAX package's own draws) as
arguments. Masks are bool ``[B, X, Y, Z]``;
broadcast them against ``[B, X, Y, Z, E]`` data with ``mask[..., None]``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# n_bores < 32 gives at most floor(sqrt(31)) = 5 by ceil(31 / 5) = 7 cells
_MAX_GRID = 8


def _jittered_grid_xy(u: torch.Tensor, size_x: int, size_y: int, n_bores: torch.Tensor):
    """Jittered grid points from the uniform draws ``u [..., 2, 8, 8]`` and the
    counts ``n_bores [...]``: ``(px, py, valid)``, each ``[..., 64]``.

    n_x = ⌊√n⌋, n_y = ⌈n / n_x⌉; cell centres plus U(-w/2, w/2) jitter, clamped
    to [0, size - 1] and truncated to integers; points past the n_x × n_y grid
    or past ``n_bores`` in row-major order are flagged invalid.
    """
    n = n_bores.to(torch.float32)[..., None, None]
    n_x = torch.floor(torch.sqrt(n))
    n_y = torch.ceil(n / n_x)
    cell_w_x = size_x / n_x
    cell_w_y = size_y / n_y
    idx = torch.arange(_MAX_GRID, device=u.device)
    ii, jj = idx[:, None], idx[None, :]
    px = (ii + 0.5) * cell_w_x + (u[..., 0, :, :] * cell_w_x - cell_w_x / 2.0)
    py = (jj + 0.5) * cell_w_y + (u[..., 1, :, :] * cell_w_y - cell_w_y / 2.0)
    px = px.clamp(0.0, size_x - 1).to(torch.int64)
    py = py.clamp(0.0, size_y - 1).to(torch.int64)
    flat_rank = ii * n_y.to(torch.int64) + jj
    valid = (jj < n_y) & (ii < n_x) & (flat_rank < n_bores[..., None, None])
    flat = lambda a: a.reshape(*a.shape[:-2], _MAX_GRID * _MAX_GRID)
    return flat(px), flat(py), flat(valid)


def boreholes_from_draws(u: torch.Tensor, n_bores: torch.Tensor,
                         shape: Sequence[int]) -> torch.Tensor:
    """The borehole mask ``[B, X, Y, Z]`` of the draws ``u [B, 2, 8, 8]`` and
    ``n_bores [B]`` (the deterministic part of :func:`make_boreholes_mask`)."""
    b, size_x, size_y, size_z = shape
    px, py, valid = _jittered_grid_xy(u, size_x, size_y, n_bores)
    # invalid points write to one spare cell past the plane, dropped below
    cell = torch.where(valid, px * size_y + py, size_x * size_y)
    plane = torch.zeros(b, size_x * size_y + 1, dtype=torch.bool, device=u.device)
    plane.scatter_(1, cell, True)
    plane = plane[:, :-1].reshape(b, size_x, size_y)
    return plane[..., None].expand(b, size_x, size_y, size_z)


def draw_boreholes(generator: torch.Generator, batch: int,
                   n_bores_range: Tuple[int, int] = (8, 32)):
    """The random part of :func:`make_boreholes_mask`: ``(u [B, 2, 8, 8],
    n_bores [B])`` on the generator's device, ``n_bores`` drawn first."""
    lo, hi = n_bores_range
    dev = generator.device
    n_bores = torch.randint(lo, hi, (batch,), generator=generator, device=dev)
    u = torch.rand((batch, 2, _MAX_GRID, _MAX_GRID), generator=generator, device=dev)
    return u, n_bores


def make_boreholes_mask(generator: torch.Generator, shape: Sequence[int],
                        n_bores_range: Tuple[int, int] = (8, 32)) -> torch.Tensor:
    """Bool mask ``[B, X, Y, Z]`` of full-depth vertical borehole columns, on the
    generator's device."""
    u, n_bores = draw_boreholes(generator, shape[0], n_bores_range)
    return boreholes_from_draws(u, n_bores, shape)


def _air_and_below(batch: torch.Tensor, air_value: int):
    air = batch == air_value
    # the voxel just below an air voxel along z is index z - 1
    below = torch.cat([air[..., 1:], torch.zeros_like(air[..., :1])], dim=-1)
    return air, below


def make_surface_mask(batch: torch.Tensor, air_value: int = -1) -> torch.Tensor:
    """Top z-slice ∪ air voxels ∪ the voxel just below each air voxel, from the
    categorical ``batch [B, X, Y, Z]``."""
    air, below = _air_and_below(batch, air_value)
    top = torch.zeros_like(air)
    top[..., -1] = True
    return air | below | top


def make_combined_mask(generator: torch.Generator, batch: torch.Tensor,
                       air_value: int = -1) -> torch.Tensor:
    """Boreholes ∪ surface."""
    return make_boreholes_mask(generator, batch.shape) | make_surface_mask(batch, air_value)


def reduced_boreholes(batch: torch.Tensor, columns: torch.Tensor, air_value: int = -1,
                      depth: int = 16) -> torch.Tensor:
    """Air voxels ∪ the borehole ``columns [B, X, Y]`` from ``depth`` voxels
    below the lowest air voxel of each column down; a column without air
    carries no borehole (the deterministic part of
    :func:`make_boreholes_reduced_mask`)."""
    size_z = batch.shape[-1]
    air = batch == air_value
    zidx = torch.arange(size_z, device=batch.device)
    min_z = torch.where(air, zidx, size_z).amin(dim=-1)  # [B, X, Y]; Z where no air
    has_air = min_z < size_z
    z_start = (min_z - depth).clamp_min(0)
    keep = (columns & has_air)[..., None]
    return air | ((zidx >= z_start[..., None]) & keep)


def make_boreholes_reduced_mask(generator: torch.Generator, batch: torch.Tensor,
                                air_value: int = -1, n_bores_range: Tuple[int, int] = (8, 64),
                                depth: int = 16) -> torch.Tensor:
    """Boreholes starting ``depth`` voxels below the surface, plus the air voxels."""
    columns = make_boreholes_mask(generator, batch.shape, n_bores_range)[..., 0]
    return reduced_boreholes(batch, columns, air_value, depth)


def combined_reduced(batch: torch.Tensor, columns: torch.Tensor, air_value: int = -1,
                     depth: int = 16) -> torch.Tensor:
    """:func:`reduced_boreholes` ∪ air ∪ the voxel just below each air voxel
    (the deterministic part of :func:`make_combined_reduced_mask`)."""
    air, below = _air_and_below(batch, air_value)
    return reduced_boreholes(batch, columns, air_value, depth) | air | below


def make_combined_reduced_mask(generator: torch.Generator, batch: torch.Tensor,
                               air_value: int = -1, n_bores_range: Tuple[int, int] = (8, 64),
                               depth: int = 16) -> torch.Tensor:
    """Reduced boreholes ∪ air ∪ the voxel just below each air voxel."""
    columns = make_boreholes_mask(generator, batch.shape, n_bores_range)[..., 0]
    return combined_reduced(batch, columns, air_value, depth)
