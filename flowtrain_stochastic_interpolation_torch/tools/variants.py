"""Variants of a kernel source for A/B runs on the card: the source with a few
lines substituted, each built by its own ``nvcc`` call into ``_build/``."""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from typing import Callable, Dict, List, Tuple

from flowtrain_stochastic_interpolation_torch.ops import cuda_build

Substitutions = List[Tuple[str, str]]


def variant_source(source: str, subs: Substitutions) -> str:
    """``csrc/<source>.cu`` with ``subs`` applied; raises if one no longer applies."""
    text = (cuda_build.SOURCE_DIR / f"{source}.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"{source}.cu no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(source: str, variants: Dict[str, Substitutions],
                   bind: Callable[[ctypes.CDLL], None]) -> Dict[str, ctypes.CDLL]:
    """Build every variant, one nvcc each, all started together; ``bind`` sets the
    argument types of each library's C entry points."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.nvcc_path()
    jobs = {}
    for name, subs in variants.items():
        text = variant_source(source, subs)
        digest = hashlib.sha256(text.encode()).hexdigest()[:12]
        # beside the original source, so that its headers resolve
        path = cuda_build.SOURCE_DIR / f"_ab_{digest}.cu"
        path.write_text(text)
        library = cuda_build.BUILD_DIR / f"libab_{source}-{digest}.so"
        cmd = cuda_build.build_command(path, library, nvcc)
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), path, library)
    libs = {}
    for name, (proc, path, library) in jobs.items():
        log, _ = proc.communicate()
        path.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        registers = [line.split("Used ")[1].split(",")[0] for line in log.splitlines()
                     if "Used" in line and "registers" in line]
        print(f"built {name}: registers per template {registers}", flush=True)
        lib = ctypes.CDLL(str(library))
        bind(lib)
        libs[name] = lib
    return libs
