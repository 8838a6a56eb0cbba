"""Joining a multi-process job, per-rank data feeding and write guards.

Port of ``flowtrain_stochastic_interpolation_tpu/parallel/distributed.py``.
The JAX package is multi-controller SPMD over ``jax.distributed``; here each
rank is one process in a ``torch.distributed`` process group, with one card
of its own (NCCL) or, for the CPU tests and for ranks that share one card,
gloo (:mod:`parallel.mesh` says which).

* :func:`maybe_initialize` joins a job when its configuration is present,
  in JAX's order: explicit arguments, then torchrun's environment, then SLURM
  with ``SLURM_NTASKS > 1``; otherwise it returns False and touches nothing.
* :func:`is_primary` is the rank that owns the host-side writes (the metrics
  CSV, images, the callback and the checkpoints).
* :func:`host_local_batch_to_global`: the port holds no global array, so
  this is the rank's block of the global batch (batch on ``data``, X on
  ``spatial``), which every rank draws whole from the same seed.

Every process group is made with a timeout (:data:`TIMEOUT`): a collective
that waits on a dead or diverged rank fails within it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=300)
DEFAULT_PORT = 29500


def init(rank: int, world_size: int, init_method: str, *, backend: str,
         local_rank: Optional[int] = None,
         timeout: datetime.timedelta = TIMEOUT) -> None:
    """``init_process_group`` with a timeout; an NCCL rank first makes card
    ``local_rank`` (``rank`` when None) its current device."""
    if backend == "nccl":
        torch.cuda.set_device(rank if local_rank is None else local_rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout)


def _resolve(coordinator_address: Optional[str], num_processes: Optional[int],
             process_id: Optional[int], local_rank: Optional[int] = None):
    """``(address, world, rank, local_rank)`` of the job to join, or None: explicit
    arguments, then torchrun's environment, then SLURM with more than one task."""
    env = os.environ
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        return coordinator_address, num_processes, process_id, local_rank
    if env.get("MASTER_ADDR") and env.get("WORLD_SIZE") and env.get("RANK"):
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', DEFAULT_PORT)}"
        return (address, int(env["WORLD_SIZE"]), int(env["RANK"]),
                int(env.get("LOCAL_RANK", env["RANK"])))
    if int(env.get("SLURM_NTASKS", "1")) > 1:
        host = env.get("MASTER_ADDR") or env.get("SLURM_LAUNCH_NODE_IPADDR")
        if not host:
            raise RuntimeError("SLURM job without MASTER_ADDR or SLURM_LAUNCH_NODE_IPADDR")
        address = f"{host}:{env.get('MASTER_PORT', DEFAULT_PORT)}"
        return (address, int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"]),
                int(env.get("SLURM_LOCALID", "0")))
    return None


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join the job that the arguments or the environment describe.

    Returns True when the process group is (or already was) initialised, False
    for a plain one-process run, with no side effect. ``coordinator_address``
    is ``host:port``. The backend is NCCL when a card is present (each rank
    takes card ``local_rank``), else gloo.
    """
    if dist.is_initialized():
        return True
    job = _resolve(coordinator_address, num_processes, process_id, local_rank)
    if job is None:
        return False
    address, world, rank, local = job
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init(rank, world, f"tcp://{address}", backend=backend, local_rank=local)
    return True


def is_primary() -> bool:
    """True on the process that owns the host-side writes: rank 0, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_local_batch_to_global(batch, sharding):
    """This rank's block of ``batch`` (a tensor or a dict / list / tuple of them)
    under ``sharding``: a :class:`parallel.mesh.Sharding`, or a callable from
    ``ndim`` to one."""
    def put(x):
        sh = sharding(x.ndim) if callable(sharding) else sharding
        return sh.local(x)

    if isinstance(batch, dict):
        return {k: host_local_batch_to_global(v, sharding) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(host_local_batch_to_global(v, sharding) for v in batch)
    return put(batch)
