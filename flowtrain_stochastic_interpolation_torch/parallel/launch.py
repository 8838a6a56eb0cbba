"""Starting the ranks of a job on one machine, with a deadline.

:func:`spawn` starts ``nprocs`` processes with ``torch.multiprocessing`` and
the ``spawn`` start method, joins them into one process group over
``tcp://127.0.0.1:<free port>`` and runs ``fn(rank, *args)`` in each; it
returns every rank's result (rank order), moved to the CPU. A rank that
raises fails the whole call with its traceback; a call that has not ended by
``deadline_s`` seconds stops every rank and raises ``TimeoutError``.

``backend="nccl"`` gives rank r card ``devices[r]`` (its current device,
set before anything launches); ``"gloo"`` serves the CPU and several ranks
that share one card, whose collectives then go through pinned host memory
(:func:`parallel.collectives.stages`).

:func:`resolve_devices` and :func:`run_on_devices` serve the apps'
``--train-devices`` (the JAX apps' ``resolve_devices``): a job that
torchrun or SLURM started is joined (:func:`parallel.distributed.maybe_initialize`),
a list of several cards gets one NCCL rank per card, and one device runs in
this process.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.parallel.distributed import init, maybe_initialize


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _rank_main(rank: int, fn: Callable, args: tuple, world: int, port: int, backend: str,
               devices: Optional[Sequence[int]], threads: Optional[int], out_dir: str) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    local = None if devices is None else devices[rank]
    if local is not None and backend != "nccl":
        torch.cuda.set_device(local)
    init(rank, world, f"tcp://127.0.0.1:{port}", backend=backend, local_rank=local)
    try:
        result = fn(rank, *args)
        torch.save(_to_cpu(result), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (), *, backend: str = "gloo",
          devices: Optional[Sequence[int]] = None, threads: Optional[int] = None,
          deadline_s: Optional[float] = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``nprocs`` ranks of one process group; their
    results, in rank order. ``fn`` must be importable (a module-level function).
    ``devices[r]`` is rank r's card; ``threads`` caps each rank's CPU threads;
    ``deadline_s=None`` waits as long as the ranks run."""
    if devices is not None and len(devices) != nprocs:
        raise ValueError(f"{nprocs} ranks but {len(devices)} devices")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="flowtrain_ranks_") as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, nprocs, port, backend, devices, threads, out_dir),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if deadline_s is None else time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks not done after {deadline_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]


def resolve_devices(spec: str) -> List[torch.device]:
    """The devices of ``--train-devices``: ``cpu``; ``cuda`` (the current card);
    ``auto`` (every visible card); or a comma list of card indices. Raises for
    cards that are not there."""
    s = (spec or "auto").strip().lower()
    if s in ("cpu", "cuda"):
        return [resolve_device(s)]
    resolve_device("cuda")
    count = torch.cuda.device_count()
    idxs = list(range(count)) if s == "auto" else [int(x) for x in s.split(",")]
    if not idxs or max(idxs) >= count or min(idxs) < 0 or len(set(idxs)) != len(idxs):
        raise ValueError(f"card indices {idxs} do not name distinct cards of the {count} here")
    return [torch.device("cuda", i) for i in idxs]


def _on_current_card(rank: int, fn: Callable, args: tuple):
    return fn(torch.device("cuda", torch.cuda.current_device()), *args)


def run_on_devices(fn: Callable, devices: Sequence[torch.device], args: tuple = ()):
    """``fn(device, *args)`` as a job: in this process when torchrun or SLURM
    started it (its card the local rank's) or when ``devices`` is one device;
    else on one NCCL rank per card of ``devices``. Returns rank 0's result."""
    if maybe_initialize():
        dev = (torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
               else torch.device("cpu"))
        return fn(dev, *args)
    if len(devices) == 1:
        return fn(devices[0], *args)
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"several ranks need one card each, got {list(devices)}")
    return spawn(_on_current_card, len(devices), (fn, args), backend="nccl",
                 devices=[d.index for d in devices], deadline_s=None)[0]
