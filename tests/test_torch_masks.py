"""The port's observation masks against the JAX package's ``ops/masks.py``.

The draws differ (a ``torch.Generator`` against a JAX key), so the
deterministic parts are held against JAX on JAX's own draws, exactly: the
jittered grid, the borehole columns, the surface mask, the combined mask and
both reduced masks (whose columns qualify only where they hold air, the JAX
behaviour). The port's seeded masks are checked for their structure.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch.data.synthetic import synthetic_geology_batch
from flowtrain_stochastic_interpolation_torch.ops import masks
from flowtrain_stochastic_interpolation_tpu.ops import masks as jax_masks


def _jax_draws(key, batch, n_bores_range):
    """The uniform draws and borehole counts that ``make_boreholes_mask(key, ...)``
    makes, item by item: ``(u [B, 2, 8, 8], n_bores [B])``."""
    lo, hi = n_bores_range

    def per_item(k):
        k_n, k_grid = jax.random.split(k)
        return jax.random.uniform(k_grid, (2, 8, 8)), jax.random.randint(k_n, (), lo, hi)

    return jax.vmap(per_item)(jax.random.split(key, batch))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_boreholes(key, shape, n_bores_range):
    """JAX's draws, its jittered grid on them and its borehole mask, in one program."""
    u, n = _jax_draws(key, shape[0], n_bores_range)
    grid = jax.vmap(lambda k, count: jax_masks._jittered_grid_xy(
        jax.random.split(k)[1], shape[1], shape[2], count))(jax.random.split(key, shape[0]), n)
    return u, n, grid, jax_masks.make_boreholes_mask(key, shape, n_bores_range)


@pytest.mark.parametrize("shape,n_bores_range,seed", [
    ((4, 16, 16, 8), (8, 32), 0),
    ((3, 13, 21, 5), (8, 32), 1),
    ((4, 64, 64, 4), (8, 64), 2),   # counts past 8 x 8 cells are truncated, as in JAX
])
def test_boreholes_on_jax_draws_match_jax_exactly(shape, n_bores_range, seed):
    u, n, grid, want = (jax.tree_util.tree_map(np.asarray, a) for a in _jax_boreholes(
        jax.random.PRNGKey(seed), shape, n_bores_range))
    got = masks.boreholes_from_draws(torch.from_numpy(u), torch.from_numpy(n), shape)
    assert got.shape == want.shape == shape and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    ours = masks._jittered_grid_xy(torch.from_numpy(u), shape[1], shape[2], torch.from_numpy(n))
    for a, b in zip(ours, grid):  # px, py and valid of every grid cell
        np.testing.assert_array_equal(a.numpy(), b)


@jax.jit
def _jax_masks(key, batch):
    """JAX's reduced borehole columns (n_bores in [8, 64)) and its surface,
    combined, reduced and combined-reduced masks of ``batch``."""
    columns = jax_masks.make_boreholes_mask(key, batch.shape, (8, 64))[..., 0]
    return (columns, jax_masks.make_surface_mask(batch),
            jax_masks.make_combined_mask(key, batch),
            jax_masks.make_boreholes_reduced_mask(key, batch),
            jax_masks.make_combined_reduced_mask(key, batch))


def test_surface_combined_and_reduced_masks_match_jax_exactly():
    key = jax.random.PRNGKey(7)
    batch = synthetic_geology_batch(torch.Generator().manual_seed(3), 3, (16, 16, 24)).numpy()
    cols = np.asarray(_jax_masks(key, jnp.asarray(batch))[0])
    x, y = np.argwhere(cols[0])[0]
    batch[0, x, y, :] = 5  # item 0's first borehole column made solid rock: no air there
    cols, surface_want, combined_want, reduced_want, combined_reduced_want = (
        np.asarray(a) for a in _jax_masks(key, jnp.asarray(batch)))
    tb = torch.from_numpy(batch)
    tcols = torch.from_numpy(cols.copy())

    surface = masks.make_surface_mask(tb)
    np.testing.assert_array_equal(surface.numpy(), surface_want)
    assert surface[..., -1].all() and surface[tb == -1].all()

    reduced = masks.reduced_boreholes(tb, tcols)
    np.testing.assert_array_equal(reduced.numpy(), reduced_want)
    assert not reduced[0, x, y].any()  # no air in that column: no borehole either
    combined_reduced = masks.combined_reduced(tb, tcols)
    np.testing.assert_array_equal(combined_reduced.numpy(), combined_reduced_want)
    assert not combined_reduced[0, x, y, :-1].any()

    u, n = (torch.from_numpy(np.asarray(a)) for a in _jax_draws(key, batch.shape[0], (8, 32)))
    combined = masks.boreholes_from_draws(u, n, batch.shape) | surface
    np.testing.assert_array_equal(combined.numpy(), combined_want)


def test_seeded_masks_have_full_depth_columns_and_counts_in_range():
    shape = (6, 32, 32, 16)
    gen = torch.Generator().manual_seed(0)
    u, n = masks.draw_boreholes(gen, shape[0])
    assert u.shape == (6, 2, 8, 8) and ((u >= 0) & (u < 1)).all()
    assert ((n >= 8) & (n < 32)).all()
    mask = masks.make_boreholes_mask(torch.Generator().manual_seed(0), shape)
    assert torch.equal(mask, masks.boreholes_from_draws(u, n, shape))  # counts, then jitter
    assert torch.equal(mask, mask[..., :1].expand(shape))  # full-depth vertical columns
    per_item = mask[..., 0].flatten(1).sum(dim=1)
    assert ((per_item >= 1) & (per_item <= n)).all()
    other = masks.make_boreholes_mask(torch.Generator().manual_seed(1), shape)
    assert not torch.equal(mask, other)

    batch = synthetic_geology_batch(torch.Generator().manual_seed(2), shape[0], shape[1:])
    combined = masks.make_combined_mask(torch.Generator().manual_seed(0), batch)
    assert torch.equal(combined, mask | masks.make_surface_mask(batch))
    reduced = masks.make_boreholes_reduced_mask(torch.Generator().manual_seed(0), batch,
                                                n_bores_range=(8, 32), depth=4)
    assert torch.equal(reduced, masks.reduced_boreholes(batch, mask[..., 0], depth=4))
    air = batch == -1  # synthetic air lies above the surface only
    surface = air.int().argmax(dim=-1)  # the lowest air voxel of each column
    rock = (reduced & ~air).sum(dim=-1)  # the borehole's depth below the surface
    has_air = air.any(dim=-1)
    assert torch.equal(reduced & air, air)
    want = torch.where(mask[..., 0] & has_air, surface.clamp_max(4), 0)
    assert torch.equal(rock, want) and (rock > 0).any()
