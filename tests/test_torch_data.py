"""The port's host-side data sources against the JAX package's (CPU).

JAX ``tests/test_data.py``'s cases on the port's modules: ``prefetch`` keeps
the order and raises the producer's exception where the items are consumed;
the GeoGen adapter, driven by a stub ``geogen`` package over the recorded
fixture ``tests/fixtures/geogen_recorded.npz``, gives JAX's adapter's batches
and draws disjoint indices per process; ``get_dataset`` falls back to the
synthetic source with JAX's warning; the native generator, built by the port
with ``g++``, keeps GeoGen's conventions and gives JAX's ``generate_batch``'s
volumes bit for bit (skipped where no compiler exists, as JAX's case is).
Then the training loop reads a host-side source through ``prefetch``.
"""

import dataclasses
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.data import geogen as port_geogen
from flowtrain_stochastic_interpolation_torch.data import native as port_native
from flowtrain_stochastic_interpolation_torch.data.prefetch import (
    parallel_map_batches,
    prefetch,
)
from flowtrain_stochastic_interpolation_torch.data.synthetic import SyntheticGeoDataset
from flowtrain_stochastic_interpolation_torch.train import loop as port_loop
from flowtrain_stochastic_interpolation_tpu.data import geogen as jax_geogen
from flowtrain_stochastic_interpolation_tpu.data import native as jax_native

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "geogen_recorded.npz")
CPU = torch.device("cpu")


def test_prefetch_order_and_exception():
    assert list(prefetch(iter(range(10)), depth=2)) == list(range(10))

    def bad():
        yield 1
        raise ValueError("producer broke")

    it = prefetch(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer broke"):
        list(it)


def test_prefetch_runs_the_producer_on_a_daemon_thread_and_stops_it_when_closed():
    threads, made = [], []

    def items():
        threads.append(threading.current_thread())
        for i in range(1000):
            made.append(i)
            yield i

    it = prefetch(items(), depth=2)
    assert next(it) == 0
    it.close()  # a consumer of one item, as the pre-train smoke
    producer = threads[0]
    producer.join(timeout=5)
    assert producer.daemon and producer is not threading.main_thread()
    assert not producer.is_alive() and len(made) < 10
    out = list(parallel_map_batches(lambda i: i * i, [[0, 1], [2, 3], [4]], sum,
                                    num_workers=3))
    assert out == [1, 13, 16]


def _stub_geogen(monkeypatch, streaming):
    pkg = types.ModuleType("geogen")
    mod = types.ModuleType("geogen.dataset")
    mod.GeoData3DStreamingDataset = streaming
    pkg.dataset = mod
    monkeypatch.setitem(sys.modules, "geogen", pkg)
    monkeypatch.setitem(sys.modules, "geogen.dataset", mod)


def test_geogen_adapter_with_recorded_fixture_matches_jax(monkeypatch):
    samples = np.load(FIXTURE)["samples"]  # [8, 16, 16, 16] int32, air = -1

    class FakeStreaming:
        def __init__(self, model_resolution, model_bounds, dataset_size, device):
            assert tuple(model_resolution) == (16, 16, 16) and device == "cpu"

        def __getitem__(self, idx):
            # the reference yields [1, X, Y, Z] torch tensors
            return torch.from_numpy(samples[idx % len(samples)])[None]

    _stub_geogen(monkeypatch, FakeStreaming)
    assert port_geogen.geogen_available()
    ds = port_geogen.GeoGenDataset((16, 16, 16), None, dataset_size=8, num_workers=4)
    assert ds.host_side and len(ds) == 8
    batches = list(ds.batches(4, epoch=0))
    assert len(batches) == 2
    assert batches[0].shape == (4, 16, 16, 16) and batches[0].dtype == np.int32
    np.testing.assert_array_equal(batches[0], samples[:4])
    np.testing.assert_array_equal(batches[1], samples[4:])
    ref = jax_geogen.GeoGenDataset((16, 16, 16), None, dataset_size=8, num_workers=4)
    for epoch in (0, 1):
        for got, want in zip(ds.batches(2, epoch=epoch), ref.batches(2, epoch=epoch)):
            np.testing.assert_array_equal(got, want)
    # get_dataset takes GeoGen where it is installed
    cfg = port_config.tiny_test().data
    geo = port_geogen.get_dataset(dataclasses.replace(cfg, source="geogen", shape=(16, 16, 16)))
    assert isinstance(geo, port_geogen.GeoGenDataset)


def test_geogen_indices_distinct_per_process(monkeypatch):
    seen = []

    class RecordingStreaming:
        def __init__(self, model_resolution, model_bounds, dataset_size, device):
            pass

        def __getitem__(self, idx):
            seen.append(idx)
            return torch.zeros((1, 4, 4, 4), dtype=torch.int32)

    _stub_geogen(monkeypatch, RecordingStreaming)
    ds = port_geogen.GeoGenDataset((4, 4, 4), None, dataset_size=4, num_workers=2)
    assert port_geogen.process_index_and_count() == (0, 1)
    list(ds.batches(2, epoch=1))
    assert sorted(seen) == [4, 5, 6, 7]  # one process: epoch · dataset_size + i
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    by_rank = []
    for rank in (0, 1):
        monkeypatch.setattr(dist, "get_rank", lambda rank=rank: rank)
        seen.clear()
        list(ds.batches(2, epoch=0))
        by_rank.append(set(seen))
    assert by_rank[0].isdisjoint(by_rank[1]) and by_rank == [{0, 1, 2, 3}, {4, 5, 6, 7}]


def test_get_dataset_falls_back_to_synthetic_with_jax_warning(monkeypatch):
    monkeypatch.setitem(sys.modules, "geogen", None)  # not installed
    assert not port_geogen.geogen_available() and not jax_geogen.geogen_available()
    cfg = dataclasses.replace(port_config.tiny_test().data, source="geogen")
    with pytest.warns(UserWarning, match="GeoGen not installed; falling back to synthetic"):
        ds = port_geogen.get_dataset(cfg, seed=1, device=CPU)
    assert isinstance(ds, SyntheticGeoDataset) and not ds.host_side
    batch = next(ds.batches(2))
    assert batch.shape == (2, 8, 8, 8) and batch.dtype == torch.int32
    assert int(batch.min()) >= -1 and int(batch.max()) <= 13
    synthetic = port_geogen.get_dataset(port_config.tiny_test().data, seed=1, device=CPU)
    assert isinstance(synthetic, SyntheticGeoDataset)


@pytest.fixture(scope="module")
def native():
    if not port_native.native_available():
        pytest.skip("no native toolchain")
    return port_native


def test_native_generator_matches_conventions_and_jax(native):
    b = native.generate_batch(2, (32, 32, 32), seed=5)
    assert b.shape == (2, 32, 32, 32) and b.dtype == np.int32
    assert b.min() >= -1 and b.max() <= 13 and (b == -1).any()
    np.testing.assert_array_equal(b, native.generate_batch(2, (32, 32, 32), seed=5))
    assert native.library_path().parent.name == "_build"  # never native/'s tracked library
    if not jax_native.native_available():
        pytest.skip("the JAX package's native generator is not available")
    for seed, shape in ((5, (32, 32, 32)), (11, (16, 24, 40)), (2**40 + 3, (8, 8, 8))):
        np.testing.assert_array_equal(native.generate_batch(3, shape, seed=seed),
                                      jax_native.generate_batch(3, shape, seed=seed))
    ds = native.NativeGeoDataset((16, 16, 16), dataset_size=8, seed=1)
    ref = jax_native.NativeGeoDataset((16, 16, 16), dataset_size=8, seed=1)
    assert ds.host_side and len(ds) == 8
    batches = list(ds.batches(4, epoch=2))
    assert len(batches) == 2 and batches[0].shape == (4, 16, 16, 16)
    for got, want in zip(batches, ref.batches(4, epoch=2)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ds[3], ref[3])


def test_train_loop_reads_a_host_side_source_through_prefetch(native, monkeypatch):
    cfg = port_config.tiny_test()
    ds = native.NativeGeoDataset(cfg.data.shape, dataset_size=6, seed=2)
    threads, consumed = [], []
    batches = ds.batches

    def recorded(batch_size, epoch=0):
        threads.append(threading.current_thread())
        yield from batches(batch_size, epoch)

    monkeypatch.setattr(ds, "batches", recorded)
    got = list(port_loop.device_batches(ds, 2, 0, CPU))
    assert len(got) == 3 and threads[-1] is not threading.main_thread()
    for a, b in zip(got, batches(2, 0)):
        assert isinstance(a, torch.Tensor) and a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b)
    # the loop itself, two micro-steps on the native source
    monkeypatch.setattr(port_loop, "get_dataset", lambda data, seed, device: ds)
    step = port_loop.make_train_step

    def spying(model, tx, config, mesh=None):
        inner = step(model, tx, config, mesh)

        def train_step(state, batch, gen):
            consumed.append(batch.clone())
            return inner(state, batch, gen)
        return train_step

    monkeypatch.setattr(port_loop, "make_train_step", spying)
    result = port_loop.train(cfg, num_steps=2, device="cpu")
    assert result.state.step == 2 and len(consumed) == 2
    for a, b in zip(consumed, batches(cfg.data.batch_size, 0)):
        np.testing.assert_array_equal(a.numpy(), b)
