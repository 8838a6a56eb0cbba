"""Data and spatial parallelism over ``torch.distributed``.

Port of ``flowtrain_stochastic_interpolation_tpu/parallel``. The JAX package
runs one program over a device mesh; here each rank is a process, the mesh
is the grid of ranks (:mod:`.mesh`), each mesh axis a process group, and
each collective is explicit (:mod:`.collectives`): the gradient all-reduce
of data parallelism (``train.steps``, ``train.shard_map_step``) and the
halo exchanges, ring passes and reductions of spatial parallelism
(:mod:`.spatial`). :mod:`.launch` starts the ranks of a one-machine job.
"""

from flowtrain_stochastic_interpolation_torch.parallel.distributed import (
    host_local_batch_to_global,
    is_primary,
    maybe_initialize,
    process_count,
)
from flowtrain_stochastic_interpolation_torch.parallel.mesh import (
    Mesh,
    Sharding,
    batch_sharding,
    create_mesh,
    replicate_sharding,
    shard_batch,
    spatial_shardings,
)

__all__ = [
    "Mesh",
    "Sharding",
    "create_mesh",
    "batch_sharding",
    "replicate_sharding",
    "shard_batch",
    "spatial_shardings",
    "maybe_initialize",
    "is_primary",
    "process_count",
    "host_local_batch_to_global",
]
