"""The GeoGen (StructuralGeo) adapter, the reference's data source, and
:func:`get_dataset`.

Port of ``flowtrain_stochastic_interpolation_tpu/data/geogen.py``. GeoGen's
``GeoData3DStreamingDataset`` generates geology with numpy on the host; it is
an optional dependency, as in the reference. Where it is absent,
:func:`get_dataset` falls back to the synthetic generator on the device
(:mod:`.synthetic`, the same category convention) with a warning.
"""

from __future__ import annotations

import threading
import warnings
from typing import Iterator, Tuple

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.config import DataConfig
from flowtrain_stochastic_interpolation_torch.data.prefetch import parallel_map_batches
from flowtrain_stochastic_interpolation_torch.data.synthetic import SyntheticGeoDataset


def geogen_available() -> bool:
    try:
        import geogen  # noqa: F401

        return True
    except ImportError:
        return False


def process_index_and_count() -> Tuple[int, int]:
    """This process's rank and the world size of the initialised
    ``torch.distributed`` group; ``(0, 1)`` without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class GeoGenDataset:
    """GeoGen's streaming dataset behind the ``batches`` surface: int32 numpy
    volumes ``[B, X, Y, Z]`` made on host threads, which the training loop
    copies to the device (``host_side``). The reference's call is
    ``GeoData3DStreamingDataset(model_resolution, model_bounds, dataset_size,
    device)``."""

    host_side = True

    def __init__(self, model_resolution: Tuple[int, int, int], model_bounds,
                 dataset_size: int, n_categories: int = 15, seed: int = 0,
                 num_workers: int = 16, prefetch_depth: int = 2):
        self._ctor_kwargs = dict(model_resolution=model_resolution, model_bounds=model_bounds,
                                 dataset_size=dataset_size, device="cpu")
        # one GeoGen dataset per worker thread: its __getitem__ is not known to
        # be thread-safe, and each sample follows from its index, so instances
        # per thread give the same samples for the same indices
        self._local = threading.local()
        self._local.ds = self._make_ds()  # at once: checks the import and the arguments
        self.model_resolution = tuple(model_resolution)
        self.dataset_size = dataset_size
        self.n_categories = n_categories
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth

    def _make_ds(self):
        from geogen.dataset import GeoData3DStreamingDataset  # type: ignore

        return GeoData3DStreamingDataset(**self._ctor_kwargs)

    def _thread_ds(self):
        ds = getattr(self._local, "ds", None)
        if ds is None:
            ds = self._local.ds = self._make_ds()
        return ds

    def __len__(self) -> int:
        return self.dataset_size

    def __getitem__(self, idx: int) -> np.ndarray:
        sample = self._thread_ds()[idx]  # [1, X, Y, Z] torch tensor
        return np.asarray(sample.squeeze(0).cpu().numpy(), dtype=np.int32)

    def batches(self, batch_size: int, epoch: int = 0) -> Iterator[np.ndarray]:
        """``max(dataset_size // batch_size, 1)`` batches, the items made on a
        thread pool (the reference's 16 loader workers), 2 batches ahead. Each
        process draws its own block of indices: ``(epoch, process)`` maps to a
        stride of ``dataset_size`` indices (one process: ``epoch ·
        dataset_size + i``)."""
        n_batches = max(self.dataset_size // batch_size, 1)
        rank, world = process_index_and_count()
        block = epoch * world + rank
        index_lists = [
            [block * self.dataset_size + i * batch_size + j for j in range(batch_size)]
            for i in range(n_batches)
        ]
        yield from parallel_map_batches(self.__getitem__, index_lists,
                                        lambda items: np.stack(items, axis=0),
                                        num_workers=self.num_workers,
                                        depth=self.prefetch_depth)


def get_dataset(cfg: DataConfig, seed: int = 0, device=None):
    """The configured source: ``"geogen"`` (the synthetic generator, with a
    warning, where GeoGen is not installed) or ``"synthetic"`` on ``device``."""
    if cfg.source == "geogen":
        if geogen_available():
            return GeoGenDataset(cfg.shape, cfg.bounds, cfg.epoch_size, cfg.num_categories, seed)
        warnings.warn("GeoGen not installed; falling back to synthetic generator")
    return SyntheticGeoDataset(cfg.shape, cfg.epoch_size, cfg.num_categories, seed,
                               device=device)
