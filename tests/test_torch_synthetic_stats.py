"""The port's synthetic geology against the JAX package's, by distribution.

The two generators draw from different random streams (a ``torch.Generator``
and JAX keys), so their volumes differ; what they share is the distribution.
Volumes at 32³ from each, one fixed seed a side: 256 through
``synthetic_geology_batch``, and 3072 through ``synthetic_geology_stages``
(strata, tilt, fold, dike, topography; JAX's vmapped over its keys, 256 at a
time), must agree on:

* the mean air fraction, within ``AIR_TOL``;
* the mean number of distinct categories per volume (air counted), within
  ``DISTINCT_TOL``;
* the share of neighbouring voxels whose categories differ, along z and along
  x, each within ``CHANGE_REL_TOL`` of JAX's;
* the category histogram (air and the 14 rock categories, over all voxels),
  L1 distance under ``HIST_L1_TOL``.

Over 40 seeds of 256 volumes a package the means agree (x changes: tilt,
port 0.0691 and JAX 0.0683; fold 0.1630 and 0.1640; topography 0.1649 and
0.1657), and one seed's spread about them is 1.6% of the z changes and 2.5%
of the final volumes' x changes (1σ, relative). The tilt stage's x changes
spread 4.6%: one tilt draw a volume sets them. So the stages are compared on
3072 volumes a side, where that spread is 1.3% and the 6% limit over 3σ of
the difference between two seeds (``tests/torch_trajectory_probe.py
synthetic`` measures the spreads).
"""

import jax
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch.data import synthetic as port_synthetic
from flowtrain_stochastic_interpolation_tpu.data import synthetic as jax_synthetic

N_VOLUMES, N_STAGE_VOLUMES, SHAPE, N_CATEGORIES = 256, 3072, (32, 32, 32), 15
STAGES = ("strata", "tilt", "fold", "dike", "topography")
AIR_TOL = 0.003
DISTINCT_TOL = 0.4
CHANGE_REL_TOL = 0.06
HIST_L1_TOL = 0.12


def statistics(volumes: np.ndarray) -> dict:
    """The statistics of the module docstring for ``[N, X, Y, Z]`` categories."""
    v = np.asarray(volumes)
    assert v.dtype == np.int32 and v.min() >= -1 and v.max() <= N_CATEGORIES - 2
    n = v.shape[0]
    # per-volume counts of each category: [n, N_CATEGORIES]
    counts = np.bincount((np.arange(n)[:, None] * N_CATEGORIES + (v + 1).reshape(n, -1)).ravel(),
                         minlength=n * N_CATEGORIES).reshape(n, N_CATEGORIES)
    return {
        "air": float((v == -1).mean()),
        "distinct": float((counts > 0).sum(axis=1).mean()),
        "z_changes": float((v[..., 1:] != v[..., :-1]).mean()),
        "x_changes": float((v[:, 1:] != v[:, :-1]).mean()),
        "histogram": counts.sum(axis=0) / v.size,
    }


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _accumulate(chunks) -> dict:
    """:func:`statistics` over ``[n, X, Y, Z]`` chunks, weighted by their sizes."""
    parts = [(len(c), statistics(c)) for c in chunks]
    total = sum(n for n, _ in parts)
    return {key: sum(n * st[key] for n, st in parts) / total for key in parts[0][1]}


@pytest.fixture(scope="module")
def stats():
    """``{"batch": (port, jax), stage: (port, jax), ...}``: their statistics."""
    out = {"batch": (
        statistics(port_synthetic.synthetic_geology_batch(
            torch.Generator().manual_seed(0), N_VOLUMES, SHAPE).numpy()),
        statistics(np.asarray(jax_synthetic.synthetic_geology_batch(
            jax.random.PRNGKey(0), N_VOLUMES, SHAPE))))}
    gen = torch.Generator().manual_seed(1)
    stages = jax.jit(jax.vmap(lambda k: jax_synthetic.synthetic_geology_stages(k, SHAPE)))
    keys = jax.random.split(jax.random.PRNGKey(1), N_STAGE_VOLUMES).reshape(-1, N_VOLUMES, 2)
    port, theirs = [], []
    for chunk_keys in keys:
        chunk = [port_synthetic.synthetic_geology_stages(gen, SHAPE) for _ in range(N_VOLUMES)]
        port.append({k: np.stack([v[k].numpy() for v in chunk]) for k in STAGES})
        theirs.append({k: np.asarray(v) for k, v in stages(chunk_keys).items()})
    for stage in STAGES:
        out[stage] = (_accumulate(c[stage] for c in port), _accumulate(c[stage] for c in theirs))
    return out


@pytest.mark.parametrize("source", ("batch",) + STAGES)
def test_synthetic_geology_matches_jax_distribution(stats, source):
    ours, theirs = stats[source]
    l1 = float(np.abs(ours["histogram"] - theirs["histogram"]).sum())
    print(f"{source}: port " + ", ".join(f"{k} {ours[k]:.4f}" for k in ours if k != "histogram")
          + "; JAX " + ", ".join(f"{k} {theirs[k]:.4f}" for k in theirs if k != "histogram")
          + f"; histogram L1 {l1:.4f}")
    assert abs(ours["air"] - theirs["air"]) <= AIR_TOL
    assert abs(ours["distinct"] - theirs["distinct"]) <= DISTINCT_TOL
    for key in ("z_changes", "x_changes"):
        assert abs(ours[key] - theirs[key]) <= CHANGE_REL_TOL * theirs[key], key
    assert l1 < HIST_L1_TOL
