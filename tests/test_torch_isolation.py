"""The port stands alone: no JAX on its import path, no quiet CPU fallback,
a kernel build that targets Hopper into an ignored directory, and a chip copy
that carries the release weights."""

import fnmatch
import os
import subprocess
import sys
from pathlib import Path

from flowtrain_stochastic_interpolation_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "flowtrain_stochastic_interpolation_torch"
# matplotlib may be imported only when a picture is asked for; nothing imports wandb
POISONED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "matplotlib", "wandb",
            "flowtrain_stochastic_interpolation_tpu")
RELEASE_WEIGHTS = "artifacts/weights/uncond_demo_64/weights.msgpack"

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {POISONED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import {PACKAGE}
names = [m.name for m in pkgutil.walk_packages({PACKAGE}.__path__, "{PACKAGE}.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from {PACKAGE}.ops.linear_attention import (  # the v1 path and its kernels
    linear_attention, linear_attention_backward, linear_attention_reference, linear_context,
    linear_context_plain, linear_project, linear_project_plain,
)
from {PACKAGE}.models.attention import LinearAttention
assert LinearAttention(8, fused=True, device="cpu").fused
from {PACKAGE}.ops.tap_conv import (  # the fourth slice: the tap-folded conv and the probes
    tap_conv3d, tap_conv_forward, tap_conv_forward_plain, tap_conv_weight_grad,
    tap_conv_weight_grad_plain, use_tap_conv,
)
from {PACKAGE}.ops.gemm_probes import gemm_probe, gemm_probe_t, mma_probe
from {PACKAGE}.tools import bench_gemm, bench_mma_shapes, bench_tap_conv
from {PACKAGE}.models.unet_cond import EmbedATb, MixATb, UNet3DCond  # the conditional slice
from {PACKAGE}.ops import ensemble, masks
from {PACKAGE}.inference import build_atb, sample_conditional
from {PACKAGE}.train.objectives import conditional_loss
from {PACKAGE}.config import tiny_test, unconditional_64
from {PACKAGE}.apps import unconditional  # the eleventh slice: the app and its layers
from {PACKAGE}.models.persistence import load_release_weights, save_release_weights
from {PACKAGE}.train.callbacks import InferenceCallback
from {PACKAGE}.train.checkpoint import CheckpointManager
from {PACKAGE}.train.loop import train
from {PACKAGE}.utils import logging, msgpack_tree, plotting
from {PACKAGE}.apps import conditional, inference_experiments  # the twelfth slice
from {PACKAGE}.interpolants import (
    EncDecInterpolant, MirrorInterpolant, SBDMInterpolant, StochasticInterpolator, TrigInterpolant,
)
from {PACKAGE}.solvers import (
    ODEFlowSolver, denoiser_to_velocity, eps_schedule, make_frame_advancer, ode_sol_rk4,
    solve_denoising_ode, solve_denoising_sde, solve_ode_adaptive, solve_velocity_sde,
    velocity_to_denoiser,
)
from {PACKAGE}.solvers.dopri5 import dopri5_integrate
from {PACKAGE}.inference import make_sampler
tree, cfg, meta = load_release_weights("{RELEASE_WEIGHTS.rsplit('/', 1)[0]}")
leaves = lambda t: sum(leaves(v) if isinstance(v, dict) else 1 for v in t.values())
assert leaves(tree["params"]) == 299 and meta["step"] == 3000 and cfg.model == unconditional_64().model
import torch
x = torch.zeros(1, 8, 8, 8, 2)
assert tap_conv3d(x, torch.zeros(3, 3, 3, 2, 3), torch.zeros(3)).shape == (1, 8, 8, 8, 3)
cond = UNet3DCond.from_config(tiny_test(conditional=True).model, device="cpu")
x = torch.zeros(1, 8, 8, 8, 15)
assert cond(x, x, torch.zeros(1)).shape == x.shape
batch = torch.full((1, 8, 8, 8), 3)
mask = masks.make_combined_mask(torch.Generator().manual_seed(0), batch)
atb = build_atb(batch[0], mask[0], torch.eye(15))
assert ensemble.vote_probabilities(batch, 15).shape == (8, 8, 8, 15)
model = UNet3DCond.from_config(tiny_test(conditional=True).model, device="cpu")
for kw in ({{"method": "heun"}}, {{"frame_dispatch": True}}, {{"method": "sde"}}):
    sampler = make_sampler(model, torch.eye(15), conditional=True, n_frames=2, substeps=1, **kw)
    gen = {{"generator": torch.Generator()}} if kw.get("method") == "sde" else {{}}
    assert sampler(x, x, **gen)["decoded"].shape == (1, 8, 8, 8)
traj, nfe = solve_ode_adaptive(lambda y, t: -y, torch.ones(1, 2), n_frames=3)
assert nfe > 0 and traj.shape == (3, 1, 2)
# the thirteenth slice: the data sources, the remat helper, and the writer of
# reference-layout checkpoints that chip_smoke.py loads by its path
from {PACKAGE}.data import geogen, native, prefetch
from {PACKAGE}.data.geogen import GeoGenDataset, get_dataset
from {PACKAGE}.data.native import NativeGeoDataset, generate_batch
from {PACKAGE}.models import remat
from {PACKAGE}.models.persistence import convert_lightning_module, variables_to_jax
import importlib.util, tempfile, os
spec = importlib.util.spec_from_file_location("torch_lightning_layout",
                                              "tests/torch_lightning_layout.py")
layout = importlib.util.module_from_spec(spec)
spec.loader.exec_module(layout)
from {PACKAGE}.train.loop import init_model_variables
tiny = tiny_test()
tiny = tiny.__class__(**{{**tiny.__dict__, "model": tiny.model.__class__(
    **{{**tiny.model.__dict__, "time_learned_emb": False}})}})
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "tiny.ckpt")
    layout.write_checkpoint(path, variables_to_jax(init_model_variables(tiny, device="cpu")),
                            torch.eye(15).numpy(), {{"dim_mults": [1, 2], "time_learned_emb": False}})
    import contextlib, io
    with contextlib.redirect_stdout(io.StringIO()):
        loaded, table = unconditional.load_weights(tiny, path, device="cpu")
    assert sorted(dict(loaded.named_buffers())) == ["time_mlp.embed.freqs", "time_mlp.embed.phases"]
assert list(prefetch.prefetch(iter(range(3)))) == [0, 1, 2]
# the fourteenth slice: parallelism over torch.distributed
from {PACKAGE}.parallel import create_mesh, maybe_initialize, shard_batch
from {PACKAGE}.parallel.launch import spawn
from {PACKAGE}.parallel.spatial import halo_conv3d, ring_attention, sharded_linear_attention
from {PACKAGE}.train.shard_map_step import make_shard_map_train_step, make_spatial_train_step
from {PACKAGE}.inference import make_spatial_sampler
assert create_mesh().axis_names == ("data",) and not maybe_initialize()
# the fifteenth slice: the 2-D family, the toys, the utils and the last apps
from {PACKAGE}.models import UNet2D, Unet2D, VelocityMLP
from {PACKAGE}.models.unet import Downsample2D, Upsample2D
from {PACKAGE}.data.toy import GaussianMixed, get_cifar10, get_fashion_mnist, synthetic_images
from {PACKAGE}.utils import debug, flops, profiling, volview
from {PACKAGE}.apps import paper_figures, tensorprocessor, toy2d, toy2d_images
from {PACKAGE}.tools import sde_repro
net = UNet2D(dim=8, dim_mults=(1, 2), attn_heads=2, attn_dim_head=8, device="cpu")
assert net(torch.zeros(1, 8, 8, 3), torch.zeros(1)).shape == (1, 8, 8, 3)
assert VelocityMLP(device="cpu")(torch.zeros(4, 2), torch.zeros(4)).shape == (4, 2)
assert GaussianMixed(device="cpu").sample(torch.Generator(), 5).shape == (5, 2)
assert synthetic_images(torch.Generator(), 2, 8).shape == (2, 8, 8, 1)
assert flops.forward_flops(tiny_test(), 1) > 0
debug.check_finite({{"x": torch.zeros(2)}})
assert profiling.StepTimer().summary() == {{}}
decoded = tensorprocessor.decode_with_loaded_embedding(
    torch.zeros(2, 2, 2, 18).numpy(), tensorprocessor.load_embedding(None), device="cpu")
assert decoded.shape == (2, 2, 2)
# the sixteenth slice: the demo and trace tools
from {PACKAGE}.tools import (
    analyze_cond_demo, build_notebook, eval_samples, export_weights, plot_interpolants,
    profile_breakdown, sample_from_ckpt, trace_forward, trace_summary, trace_train, train_demo,
)
assert "folded_project" in trace_summary.hand_written_kernels()
assert train_demo.parse_arguments([]).out.endswith("artifacts/torch/train_demo")
assert plot_interpolants.interpolant_curves("cpu")["LinearInterpolant"]["beta"][-1] == 1.0
# the seventeenth slice: the fixed evaluation and the window means
from {PACKAGE}.tools import fixed_eval
assert fixed_eval.window_stats("artifacts/train_demo/metrics.csv")["rows"] == 51
assert fixed_eval.parse_arguments([]).window == [2500, 2999]
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
    # every module of the port, the training slice's (interpolants, data, train), the
    # conditional slice's (models.unet_cond, ops.masks, ops.ensemble), the app's
    # (apps, utils, train.checkpoint, train.callbacks) and the samplers' slice's
    # (solvers.dopri5, apps.conditional, apps.inference_experiments) too
    assert int(proc.stdout.split()[0]) >= 40, proc.stdout


def test_spawned_ranks_import_no_jax():
    """The ranks that ``parallel.launch.spawn`` starts (chip_smoke.py's phase 12
    runs in such processes) load nothing of JAX, even from a parent that has."""
    import torch_parallel_cases as cases
    from flowtrain_stochastic_interpolation_torch.parallel.launch import spawn

    assert "jax" in sys.modules  # this test process has it (tests/conftest.py)
    ranks = spawn(cases.loaded_modules, 2, (POISONED,), threads=1, deadline_s=240)
    assert ranks == [[], []]


def test_importing_the_app_runs_nothing(tmp_path):
    apps = ROOT / PACKAGE / "apps"
    before = sorted(p.name for p in apps.iterdir())
    names = ("unconditional", "conditional", "inference_experiments", "toy2d", "toy2d_images",
             "paper_figures", "tensorprocessor")
    code = "; ".join(f"import {PACKAGE}.apps.{n} as {n}; print({n}.main)" for n in names)
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=tmp_path, env=dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == len(names) and all(line.startswith("<function main") for line in lines)
    assert proc.stderr == ""
    assert sorted(p.name for p in apps.iterdir()) == before and not any(tmp_path.iterdir())


def _copy_patterns():
    return [line.strip() for line in (ROOT / ".chiprunignore").read_text().splitlines()
            if line.strip() and not line.startswith("#")]


def _copy_ignores(path: str) -> bool:
    """Whether a ``.chiprunignore`` pattern matches ``path``: its name, the path
    itself, the path under a "./" or a directory prefix, or any part of it after a
    "/", with "*" crossing "/" (the chip copy matches whole paths so)."""
    candidates = [path, "./" + path, "repo/" + path]
    candidates += [path[i + 1:] for i, ch in enumerate(path) if ch == "/"]
    return any(fnmatch.fnmatch(c, p) for c in candidates for p in _copy_patterns())


def test_release_weights_reach_the_chip_copy_and_git_keeps_them():
    assert (ROOT / RELEASE_WEIGHTS).is_file()
    check = ["git", "check-ignore", "--no-index", "-q"]
    assert _run(check + [RELEASE_WEIGHTS]).returncode == 1  # not ignored
    assert _run(check + [RELEASE_WEIGHTS.replace("uncond_demo_64", "another_run")]).returncode == 0
    assert _run(check + [f"{PACKAGE}/_build/linear_attention.so"]).returncode == 0
    assert not _copy_ignores(RELEASE_WEIGHTS)
    # the msgpack rule is narrowed, not dropped: other msgpack files stay out of the copy
    for other in ("artifacts/weights/uncond_demo_64/params.msgpack", "x/weights2.msgpack",
                  "x/myweights.msgpack", "checkpoints/ema.msgpack", "w.msgpack"):
        assert _copy_ignores(other), other
    assert _copy_ignores("artifacts/traces/run/vm.xplane.pb")


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


def test_every_kernel_source_builds_by_its_own_nvcc_call():
    sources = sorted(p.stem for p in cuda_build.SOURCE_DIR.glob("*.cu"))
    assert sources == ["flash_attention", "gemm_probes", "linear_attention", "tap_conv"]
    outputs = {cuda_build.library_path(name) for name in sources}
    assert len(outputs) == 4 and all(o.parent == cuda_build.BUILD_DIR for o in outputs)
    cmd = cuda_build.build_command(cuda_build.SOURCE_DIR / "flash_attention.cu",
                                   cuda_build.library_path("flash_attention"))
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"


def test_an_edited_header_names_a_new_library(tmp_path, monkeypatch):
    """The sources include csrc/*.cuh: a change to a header must not load a
    library built from the old one."""
    for path in cuda_build.SOURCE_DIR.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(cuda_build, "SOURCE_DIR", tmp_path)
    before = {name: cuda_build.library_path(name) for name in ("tap_conv", "gemm_probes")}
    header = tmp_path / "tile_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: cuda_build.library_path(name) for name in before}
    assert all(before[name] != after[name] for name in before)


def _fake_toolkit(tmp_path, fail: str = ""):
    """A CUDA_HOME whose nvcc builds an empty shared library with the C compiler
    (failing for sources named ``fail``) and logs each call with its start time."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$(date +%s.%N) $*" >> {tmp_path}/calls\n'
        'eval out=\\${$(($# - 1))} src=\\${$#}\n'  # build_command ends "-o OUT SOURCE"
        f'case "$src" in *{fail or "@never@"}*) echo "error: no" ; exit 2;; esac\n'
        "sleep 1\n"
        'exec cc -shared -fPIC -x c /dev/null -o "$out"\n'
    )
    nvcc.chmod(0o755)
    return tmp_path / "cuda"


def test_load_all_starts_every_nvcc_together_and_loads_each(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(_fake_toolkit(tmp_path)))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    builds = cuda_build.load_all(["linear_attention", "flash_attention"])
    calls = (tmp_path / "calls").read_text().splitlines()
    assert len(calls) == 2
    starts = [float(line.split()[0]) for line in calls]
    assert abs(starts[0] - starts[1]) < 0.9  # the second began before the first's 1 s ended
    for name, build in builds.items():
        assert build.path == cuda_build.library_path(name) and build.path.exists()
        assert build.seconds >= 1.0
    assert cuda_build.load("flash_attention") is builds["flash_attention"]  # no rebuild
    assert len((tmp_path / "calls").read_text().splitlines()) == 2


def test_load_all_waits_for_every_build_and_raises_on_a_failed_one(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(_fake_toolkit(tmp_path, fail="linear_attention")))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    try:
        cuda_build.load_all(["linear_attention", "flash_attention"])
    except RuntimeError as exc:
        assert "nvcc failed (2)" in str(exc) and "linear_attention.cu" in str(exc)
    else:
        raise AssertionError("a failed nvcc must raise")
    left = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert left == [cuda_build.library_path("flash_attention").name]  # no temporary files
