"""The port's process-group plumbing: joining a job, the write guard, the
transport's staging rule, the rank grid's blocks, and a 2-rank ``train()``
with checkpoints on gloo.

``maybe_initialize`` is tested with its environment patched and the process
group's start replaced by a recorder (no group is made); the 2-rank run
(``tests/torch_parallel_cases.py::train_run``, spawned once) trains 3
micro-steps, then resumes for 2 more, on the tiny configuration.
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist

from flowtrain_stochastic_interpolation_torch.config import tiny_test
from flowtrain_stochastic_interpolation_torch.parallel import (
    Mesh,
    batch_sharding,
    create_mesh,
    distributed,
    host_local_batch_to_global,
    is_primary,
    process_count,
    replicate_sharding,
    shard_batch,
)
from flowtrain_stochastic_interpolation_torch.parallel.collectives import stages
from flowtrain_stochastic_interpolation_torch.parallel.launch import spawn
from flowtrain_stochastic_interpolation_torch.train.checkpoint import find_steps

import torch_parallel_cases as cases

JOB_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_NTASKS",
           "SLURM_PROCID", "SLURM_LOCALID", "SLURM_LAUNCH_NODE_IPADDR")


@pytest.fixture
def recorded(monkeypatch):
    """No job in the environment; ``init`` records its arguments instead."""
    for name in JOB_ENV:
        monkeypatch.delenv(name, raising=False)
    calls = []
    monkeypatch.setattr(distributed, "init",
                        lambda rank, world, method, **kw: calls.append((rank, world, method, kw)))
    return calls


def test_maybe_initialize_does_nothing_without_a_job(recorded, monkeypatch):
    assert distributed.maybe_initialize() is False
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert distributed.maybe_initialize() is False
    assert recorded == []
    assert is_primary() and process_count() == 1


def test_maybe_initialize_resolution_order(recorded, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    # explicit arguments first
    assert distributed.maybe_initialize("host:99", 2, 1, backend="gloo")
    assert recorded[-1] == (1, 2, "tcp://host:99", {"backend": "gloo", "local_rank": None})
    # then torchrun's environment
    assert distributed.maybe_initialize(backend="gloo")
    assert recorded[-1] == (5, 8, "tcp://10.0.0.1:1234", {"backend": "gloo", "local_rank": 1})
    # then SLURM, with the launch node's address where MASTER_ADDR is unset
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name)
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_LOCALID", "0")
    monkeypatch.setenv("SLURM_LAUNCH_NODE_IPADDR", "10.0.0.2")
    assert distributed.maybe_initialize(backend="gloo")
    assert recorded[-1] == (3, 4, "tcp://10.0.0.2:1234", {"backend": "gloo", "local_rank": 0})
    # a card present: NCCL; none: gloo
    assert distributed.maybe_initialize()
    assert recorded[-1][3]["backend"] == ("nccl" if torch.cuda.is_available() else "gloo")
    with pytest.raises(ValueError, match="num_processes and process_id"):
        distributed.maybe_initialize("host:99")


def test_staging_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert stages("gloo", cuda) is True
    assert stages("gloo", cpu) is False
    assert stages("nccl", cuda) is False
    with pytest.raises(ValueError, match="NCCL takes CUDA tensors only"):
        stages("nccl", cpu)
    with pytest.raises(ValueError, match="unsupported backend"):
        stages("mpi", cpu)


def test_one_process_mesh_and_blocks():
    mesh = create_mesh()
    assert (mesh.n_data, mesh.n_spatial, mesh.axis_names) == (1, 1, ("data",))
    assert mesh.data_group is None and mesh.spatial_group is None and mesh.world_group is None
    with pytest.raises(ValueError, match="needs 2 ranks"):
        create_mesh(2, 1)
    x = torch.arange(4 * 8 * 2).reshape(4, 8, 2)
    assert torch.equal(shard_batch(x, mesh), x)
    # rank (di=1, si=2) of a 2 x 4 grid: batch block 1 of 2, X block 2 of 4
    grid = Mesh(2, 4, di=1, si=2)
    assert grid.axis_names == ("data", "spatial") and grid.rank == 6
    assert torch.equal(shard_batch(x, grid), x[2:4, 4:6])
    assert torch.equal(batch_sharding(grid, 1).local(x[:, 0, 0]), x[2:4, 0, 0])
    assert torch.equal(replicate_sharding(grid).local(x), x)
    blocks = host_local_batch_to_global({"a": x, "b": (x, x)}, batch_sharding(grid, 3))
    assert torch.equal(blocks["b"][1], x[2:4, 4:6])
    with pytest.raises(ValueError, match="does not split into 4"):
        shard_batch(x[:, :6], grid)


def test_two_rank_training_writes_on_rank_zero_and_both_resume(tmp_path):
    cfg = tiny_test()
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training,
                                                                checkpoint_every_steps=2))
    root = str(tmp_path / "ckpt")
    first, second = zip(*spawn(cases.train_run, 2, (cfg, root, (3, 2)), threads=1,
                               deadline_s=240))
    assert [r["saves"] for r in first] == [[2, 3], []]
    assert [r["saves"] for r in second] == [[4, 5], []]
    assert [r["start"] for r in second] == [3, 3] and [r["step"] for r in second] == [5, 5]
    assert find_steps(root)[-1] == 5
    for run in (first, second):
        assert run[0]["history"] == run[1]["history"]
        assert all(torch.equal(run[0]["params"][k], run[1]["params"][k])
                   for k in run[0]["params"])
    assert not dist.is_initialized()
