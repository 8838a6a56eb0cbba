"""Build and load the port's CUDA sources: one ``nvcc`` call, bound with ``ctypes``.

Each source under ``csrc/`` is compiled at first use, by one ``nvcc`` call
of its own (:func:`load_all` starts several together), into a shared library
with a plain C interface, for Hopper only (``sm_90a``), into ``_build/`` inside
the package (listed in ``.gitignore``). The library's name carries a hash of
the source, the headers under ``csrc/`` and the flags, so an edited source or
header is built anew. Nothing is
compiled while a module is imported: the CPU tests import every module.

``nvcc`` is looked up under ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``),
then on ``PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


@dataclass(frozen=True)
class Build:
    """A loaded library and how it came to be."""

    library: ctypes.CDLL
    path: Path
    seconds: float  # wall time of the nvcc call; 0.0 if the library was already built
    log: str        # nvcc's output (the -Xptxas -v register/shared/spill summary)


_LOADED: Dict[str, Build] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found at {cand} or on PATH")
    return found


def build_command(source: Path, output: Path, nvcc: str = "nvcc") -> List[str]:
    """The one nvcc call that turns ``source`` into the shared library ``output``."""
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source, of every
    header in ``csrc/`` (a source may include any of them) and of the flags."""
    digest = hashlib.sha256((SOURCE_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _wait(entry) -> Tuple[float, str]:
    """Wait for one nvcc: (seconds from its start to its end, its output)."""
    proc, _, _, _, start = entry
    log, _ = proc.communicate()
    return time.perf_counter() - start, log


def load(name: str) -> Build:
    """Build ``csrc/<name>.cu`` if its library is missing, load it, and keep it loaded."""
    return load_all([name])[name]


def load_all(names: Iterable[str]) -> Dict[str, Build]:
    """Load several sources, building the missing ones with one ``nvcc`` each, all
    started together and then waited for."""
    names = list(dict.fromkeys(names))
    pending = {}
    for name in names:
        path = library_path(name)
        if name in _LOADED or path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = build_command(SOURCE_DIR / f"{name}.cu", Path(tmp), nvcc_path())
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, cmd, tmp, path, time.perf_counter())

    # wait for every build, each in its own thread, so that each one's time is its own
    with ThreadPoolExecutor(max_workers=max(1, len(pending))) as pool:
        built = dict(zip(pending, pool.map(_wait, pending.values())))
    failures = []
    for name, (proc, cmd, tmp, path, start) in pending.items():
        log = built[name][1]
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    for name in names:
        if name not in _LOADED:
            path = library_path(name)
            seconds, log = built.get(name, (0.0, ""))
            _LOADED[name] = Build(ctypes.CDLL(str(path)), path, seconds, log)
    return {name: _LOADED[name] for name in names}
