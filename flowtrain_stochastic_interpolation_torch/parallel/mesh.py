"""The rank grid and the blocks of a batch that each rank holds.

Port of ``flowtrain_stochastic_interpolation_tpu/parallel/mesh.py``. A JAX
mesh is a grid of devices with named axes; here it is the grid of ranks of
the process group, ``n_data`` rows by ``n_spatial`` columns in rank order
(rank = ``di * n_spatial + si``), and each named axis becomes a process
group: the ``data`` group of a rank holds the ranks of its column (the
replicas that see other samples), the ``spatial`` group the ranks of its row
(the slabs of one sample's X axis). Every collective names its group.

One process is the 1 × 1 mesh, with no groups: every collective over a
missing group is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from flowtrain_stochastic_interpolation_torch.parallel.distributed import (
    host_local_batch_to_global,
)


@dataclass(frozen=True)
class Sharding:
    """How a tensor's leading axes split over the mesh: ``splits[a] = (n, i)``
    says that axis ``a`` splits into ``n`` equal blocks of which this rank holds
    block ``i``."""

    splits: Tuple[Tuple[int, int], ...] = ()

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``x`` (a view)."""
        for axis, (n, i) in enumerate(self.splits):
            if n == 1:
                continue
            size = x.shape[axis]
            if size % n:
                raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split into {n}")
            x = x.narrow(axis, i * (size // n), size // n)
        return x


@dataclass(eq=False)
class Mesh:
    """The ``(data, spatial)`` grid of ranks, this rank's place in it and its groups."""

    n_data: int
    n_spatial: int
    di: int = 0
    si: int = 0
    world_group: Optional[dist.ProcessGroup] = None    # None in one process
    data_group: Optional[dist.ProcessGroup] = None     # None when n_data == 1
    spatial_group: Optional[dist.ProcessGroup] = None  # None when n_spatial == 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",) if self.n_spatial == 1 else ("data", "spatial")

    @property
    def size(self) -> int:
        return self.n_data * self.n_spatial

    @property
    def rank(self) -> int:
        return self.di * self.n_spatial + self.si


def create_mesh(n_data: Optional[int] = None, n_spatial: int = 1) -> Mesh:
    """The ``n_data`` × ``n_spatial`` mesh over every rank of the process group
    (``n_data`` defaults to the ranks left after ``n_spatial``).

    Every rank must call it, with the same arguments: each group is made on
    every rank in the same order, as ``dist.new_group`` requires.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_spatial
    if n_data < 1 or n_spatial < 1 or n_data * n_spatial != world:
        raise ValueError(f"a {n_data} x {n_spatial} mesh needs {n_data * n_spatial} ranks; "
                         f"the process group has {world}")
    if world == 1:
        return Mesh(1, 1)
    rank = dist.get_rank()
    di, si = divmod(rank, n_spatial)
    data_group = spatial_group = None
    if n_data > 1:
        for col in range(n_spatial):
            group = dist.new_group([d * n_spatial + col for d in range(n_data)])
            if col == si:
                data_group = group
    if n_spatial > 1:
        for row in range(n_data):
            group = dist.new_group([row * n_spatial + s for s in range(n_spatial)])
            if row == di:
                spatial_group = group
    return Mesh(n_data, n_spatial, di, si, dist.group.WORLD, data_group, spatial_group)


def batch_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """The leading batch axis on ``data`` and, with a spatial axis, the first
    volume axis (X) on ``spatial``."""
    splits = [(mesh.n_data, mesh.di)]
    if mesh.n_spatial > 1 and ndim >= 2:
        splits.append((mesh.n_spatial, mesh.si))
    return Sharding(tuple(splits))


def replicate_sharding(mesh: Mesh) -> Sharding:
    return Sharding()


def spatial_shardings(mesh: Mesh, ndim: int) -> Sharding:
    """The sharding of volumetric activations ``[B, X, Y, Z, C]``: batch on
    ``data``, X on ``spatial``."""
    return batch_sharding(mesh, ndim)


def shard_batch(batch, mesh: Mesh):
    """This rank's block of the global ``batch`` (a tensor or a dict / list /
    tuple of them): batch on ``data``, X on ``spatial``."""
    return host_local_batch_to_global(batch, lambda ndim: batch_sharding(mesh, ndim))
