"""ctypes bindings for the native C++ geology generator (``native/geogen_native.cpp``).

Port of ``flowtrain_stochastic_interpolation_tpu/data/native.py``: the host
cores generate the next batches while the card trains (the reference's 16
loader workers, done natively), with threads over the items of a batch.

The library is built at first use by one ``g++`` call with the flags of
``native/Makefile``, into the port's ``_build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags. ``make`` in ``native/`` is never
run: it would overwrite the tracked ``native/libgeogen_native.so``.
:func:`native_available` is False where the build fails (no compiler, say);
:func:`build_library` raises with the compiler's output instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from flowtrain_stochastic_interpolation_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "geogen_native.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-shared", "-pthread")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgeogen_native-{digest.hexdigest()[:12]}.so"


def build_library() -> Path:
    """The generator's library, built by ``g++`` (``$CXX``) if it is missing;
    raises ``RuntimeError`` with the compiler's output where the build fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # concurrent builders never load a half-written library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_library() -> Optional[ctypes.CDLL]:
    """The generator's library (built if needed); None where it cannot be built."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build_library()))
        except (RuntimeError, OSError, subprocess.SubprocessError):
            return None
        lib.geogen_generate_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.geogen_generate_batch.restype = None
        lib.geogen_abi_version.restype = ctypes.c_int
        if lib.geogen_abi_version() != 1:
            raise RuntimeError(f"native generator ABI {lib.geogen_abi_version()}, expected 1")
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


def generate_batch(batch: int, shape: Tuple[int, int, int], n_categories: int = 15,
                   seed: int = 0, n_threads: int = 0) -> np.ndarray:
    """``[batch, X, Y, Z]`` int32 volumes from the native generator (air = -1)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native generator not available (no compiler?)")
    x, y, z = shape
    out = np.empty((batch, x, y, z), dtype=np.int32)
    lib.geogen_generate_batch(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        batch, x, y, z, n_categories, ctypes.c_uint64(seed), n_threads,
    )
    return out


class NativeGeoDataset:
    """The native generator behind the ``batches`` surface: int32 numpy batches
    made on the host (``host_side``), the next one generated on a worker thread
    while the current one is consumed."""

    host_side = True

    def __init__(self, model_resolution: Tuple[int, int, int] = (64, 64, 64),
                 model_bounds=None, dataset_size: int = 10_000, n_categories: int = 15,
                 seed: int = 0):
        if not native_available():
            raise RuntimeError("native generator not available")
        self.model_resolution = tuple(model_resolution)
        self.dataset_size = dataset_size
        self.n_categories = n_categories
        self.seed = seed

    def __len__(self) -> int:
        return self.dataset_size

    def __getitem__(self, idx: int) -> np.ndarray:
        return generate_batch(1, self.model_resolution, self.n_categories,
                              self.seed * 1_000_003 + idx)[0]

    def batches(self, batch_size: int, epoch: int = 0) -> Iterator[np.ndarray]:
        n_batches = max(self.dataset_size // batch_size, 1)
        base = (self.seed * 1_000_003 + epoch) * 1_000_003
        result: dict = {}

        def produce(i: int):
            result[i] = generate_batch(batch_size, self.model_resolution, self.n_categories,
                                       base + i)

        thread = threading.Thread(target=produce, args=(0,))
        thread.start()
        for i in range(n_batches):
            thread.join()
            batch = result.pop(i)
            if i + 1 < n_batches:
                thread = threading.Thread(target=produce, args=(i + 1,))
                thread.start()
            yield batch
