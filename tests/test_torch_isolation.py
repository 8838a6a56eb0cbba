"""The port stands alone: no JAX on its import path, no quiet CPU fallback,
and a kernel build that targets Hopper into an ignored directory."""

import fnmatch
import os
import subprocess
import sys
from pathlib import Path

from flowtrain_stochastic_interpolation_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "flowtrain_stochastic_interpolation_torch"
POISONED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
            "flowtrain_stochastic_interpolation_tpu")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {POISONED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import {PACKAGE}
names = [m.name for m in pkgutil.walk_packages({PACKAGE}.__path__, "{PACKAGE}.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(n.split(".")[0] in {POISONED!r} for n in sys.modules if sys.modules[n] is not None)
print(len(names), "modules")
"""


def _run(args, **kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(args, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300, **kw)


def test_port_and_chip_smoke_import_without_jax():
    proc = _run([sys.executable, "-c", _IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 12, proc.stdout  # every module of the port


def test_chip_smoke_without_a_card_exits_nonzero_and_says_why():
    proc = _run([sys.executable, "chip_smoke.py"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_build_targets_sm90a_into_an_ignored_directory():
    out = cuda_build.library_path("linear_attention")
    cmd = cuda_build.build_command(cuda_build.SOURCE_DIR / "linear_attention.cu", out)
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in cmd and cmd[cmd.index("-o") + 1] == str(out)
    assert out.parent == cuda_build.BUILD_DIR
    rel = cuda_build.BUILD_DIR.relative_to(ROOT).as_posix()
    patterns = [line.strip() for line in (ROOT / ".gitignore").read_text().splitlines()
                if line.strip() and not line.startswith("#")]
    assert any(fnmatch.fnmatch(rel + "/", p) or fnmatch.fnmatch(rel, p.rstrip("/"))
               for p in patterns), (rel, patterns)
