"""On-device synthetic 3-D geology: the training data of the unconditional model.

Port of ``flowtrain_stochastic_interpolation_tpu/data/synthetic.py``: tilted
and folded stratigraphy under a random topographic surface, up to three
cross-cutting dike planes, and air above the surface, generated on the
device. Randomness comes from an explicit ``torch.Generator`` (on the device
the volumes are made on), so the volumes are not the JAX package's but follow
the same distributions and conventions: int32 categories in
``[-1, n_categories - 2]``, with air = -1 (GeoGen's convention).

The whole batch is generated at once; every random draw carries a leading
batch axis, so the items are independent.

:class:`SyntheticGeoDataset` is the streaming surface the training loop
reads (the JAX package's ``SyntheticGeoDataset``): ``batches(batch_size,
epoch)`` yields an epoch's batches on the device, batch ``i`` drawn from a
generator seeded from ``(seed, epoch, i)`` (the counterpart of JAX's
``fold_in`` chain), so a stream restarted at an epoch repeats it exactly.
:func:`data.geogen.get_dataset` resolves ``DataConfig.source``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.utils.rng import generator

_MAX_DIKES = 3
_N_SURF_WAVES = 4
_N_FOLD_WAVES = 3
_N_PALETTE = 32


def _uniform(gen, shape, low, high, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return low + (high - low) * u


def _rand_waves(gen, batch, n_waves, shape_xy, amp_scale, freq_scale, device) -> torch.Tensor:
    """Sum of random 2-D sinusoids over an ``[X, Y]`` grid, per item: ``[B, X, Y]``."""
    x = torch.linspace(0.0, 1.0, shape_xy[0], device=device)[None, :, None]
    y = torch.linspace(0.0, 1.0, shape_xy[1], device=device)[None, None, :]
    freqs = _uniform(gen, (batch, n_waves, 2), 0.5, freq_scale, device)
    amps = _uniform(gen, (batch, n_waves), 0.2, 1.0, device) * amp_scale
    phases = _uniform(gen, (batch, n_waves), 0.0, 2 * math.pi, device)
    field = torch.zeros(batch, *shape_xy, device=device)
    for i in range(n_waves):
        f = freqs[:, i, :, None, None]
        field = field + amps[:, i, None, None] * torch.sin(
            2 * math.pi * (f[:, 0] * x + f[:, 1] * y) + phases[:, i, None, None]
        )
    return field


def _stages(gen: torch.Generator, batch: int, shape: Tuple[int, int, int],
            n_categories: int) -> Dict[str, torch.Tensor]:
    X, Y, Z = shape
    device = gen.device
    n_rock = n_categories - 1  # rock categories 0..n_rock-1; -1 is air
    i32 = torch.int32

    # topographic surface height in voxels (air above)
    surf = _rand_waves(gen, batch, _N_SURF_WAVES, (X, Y), 0.08 * Z, 2.5, device)
    height = torch.clamp(0.75 * Z + surf, 0.55 * Z, Z - 1.0)          # [B, X, Y]

    # stratigraphy: tilted, folded depth field
    zz = torch.arange(Z, device=device, dtype=torch.float32)[None, None, None, :]
    xx = (torch.arange(X, device=device, dtype=torch.float32) / X)[None, :, None, None]
    yy = (torch.arange(Y, device=device, dtype=torch.float32) / Y)[None, None, :, None]
    tilt = _uniform(gen, (batch, 2), -0.35, 0.35, device) * Z
    fold = _rand_waves(gen, batch, _N_FOLD_WAVES, (X, Y), 0.05 * Z, 3.0, device)
    s_tilt = zz + tilt[:, 0, None, None, None] * xx + tilt[:, 1, None, None, None] * yy
    s = s_tilt + fold[..., None]

    thickness = _uniform(gen, (batch,), 0.04 * Z, 0.12 * Z, device)[:, None, None, None]
    base_offset = _uniform(gen, (batch,), 0.0, 8.0, device)[:, None, None, None] * thickness

    # random layer -> category lookup (a repeating strata palette): [0, n_rock - 2]
    palette = torch.randint(0, n_rock - 1, (batch, _N_PALETTE), generator=gen, device=device)

    def to_cat(depth):
        depth = depth.expand(batch, X, Y, Z)
        layer = torch.floor((depth + base_offset) / thickness).long()
        return torch.gather(palette, 1, torch.remainder(layer, _N_PALETTE).reshape(batch, -1)
                            ).reshape(batch, X, Y, Z)

    cat_strata = to_cat(zz)
    cat_tilt = to_cat(s_tilt)
    cat = to_cat(s)
    cat_fold = cat

    # dikes: thin cross-cutting planes of the last rock category
    n_dikes = torch.randint(0, _MAX_DIKES + 1, (batch,), generator=gen, device=device)
    normals = torch.randn(batch, _MAX_DIKES, 3, generator=gen, device=device)
    normals = normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    p0 = _uniform(gen, (batch, _MAX_DIKES, 3), 0.0, 1.0, device)
    widths = _uniform(gen, (batch, _MAX_DIKES), 0.008, 0.025, device)
    coords = (xx, yy, zz / Z)  # the unit cube
    for i in range(_MAX_DIKES):
        dist = sum((c - p0[:, i, j, None, None, None]) * normals[:, i, j, None, None, None]
                   for j, c in enumerate(coords)).abs()
        is_dike = (dist < widths[:, i, None, None, None]) & (i < n_dikes)[:, None, None, None]
        cat = torch.where(is_dike, n_rock - 1, cat)

    air = zz > height[..., None]
    final = torch.where(air, -1, cat)
    return {
        "strata": cat_strata.to(i32),
        "tilt": cat_tilt.to(i32),
        "fold": cat_fold.to(i32),
        "dike": cat.to(i32),
        "topography": final.to(i32),
    }


def synthetic_geology_stages(generator: torch.Generator, shape: Tuple[int, int, int],
                             n_categories: int = 15) -> Dict[str, torch.Tensor]:
    """The generator's chain for one volume, every stage ``[X, Y, Z]`` int32:
    ``strata`` → ``tilt`` → ``fold`` → ``dike`` → ``topography`` (the output)."""
    return {k: v[0] for k, v in _stages(generator, 1, tuple(shape), n_categories).items()}


def synthetic_geology(generator: torch.Generator, shape: Tuple[int, int, int],
                      n_categories: int = 15) -> torch.Tensor:
    """One volume ``[X, Y, Z]`` of int32 categories in ``[-1, n_categories - 2]``."""
    return synthetic_geology_stages(generator, shape, n_categories)["topography"]


def synthetic_geology_batch(generator: torch.Generator, batch_size: int,
                            shape: Tuple[int, int, int], n_categories: int = 15) -> torch.Tensor:
    """``[B, X, Y, Z]`` independent volumes, on the generator's device."""
    return _stages(generator, batch_size, tuple(shape), n_categories)["topography"]


class SyntheticGeoDataset:
    """The synthetic generator as a stream of epochs of ``dataset_size`` volumes
    on ``device`` (``cuda`` by default)."""

    host_side = False  # the batches are made on the device

    def __init__(self, model_resolution: Tuple[int, int, int] = (64, 64, 64),
                 dataset_size: int = 10_000, n_categories: int = 15,
                 seed: int = 0, device=None):
        self.model_resolution = tuple(model_resolution)
        self.dataset_size = dataset_size
        self.n_categories = n_categories
        self.seed = seed
        self.device = resolve_device(device)

    def batches(self, batch_size: int, epoch: int = 0) -> Iterator[torch.Tensor]:
        """``max(dataset_size // batch_size, 1)`` batches ``[B, X, Y, Z]`` int32."""
        for i in range(max(self.dataset_size // batch_size, 1)):
            gen = generator(self.device, self.seed, epoch, i)
            yield synthetic_geology_batch(gen, batch_size, self.model_resolution,
                                          self.n_categories)
