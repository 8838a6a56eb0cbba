"""The port's sample-quality tools against the JAX tools on the JAX demo's outputs.

``tools.eval_samples`` (its histogram, its depth profile and its report) is
held to the root ``tools/eval_samples.py`` on the committed
``artifacts/train_demo/sample_*.npy`` and a prior batch drawn by the JAX
generator, handed to both as numpy: the same numbers to 1e-12.
``tools.analyze_cond_demo.analyze`` is held to the root tool's report on
``artifacts/train_demo_cond/`` with the JAX tool's own seed-998 mask: the
same values. Then ``test_eval.py``'s two cases on the port's own draws.
"""

import contextlib
import importlib.util
import io
import json
import math
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch.data.synthetic import synthetic_geology_batch
from flowtrain_stochastic_interpolation_torch.tools import analyze_cond_demo, eval_samples
from flowtrain_stochastic_interpolation_tpu.data.synthetic import (
    synthetic_geology_batch as jax_synthetic_batch,
)
from flowtrain_stochastic_interpolation_tpu.ops.masks import make_combined_mask as jax_mask

ROOT = Path(__file__).resolve().parents[1]
JAX_DEMO = ROOT / "artifacts" / "train_demo"
JAX_COND_DEMO = ROOT / "artifacts" / "train_demo_cond"
PORT_COND_DEMO = ROOT / "artifacts" / "torch" / "train_demo_cond"
PRIOR_SEED, PRIOR_BATCH, PRIOR_SIDE = 3, 8, 16
PRIOR_TV_BOUND = 0.2  # see test_prior_vs_prior_statistics_are_tight


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _main_json(module, argv) -> dict:
    """The JSON that a tool's ``main`` prints, run with ``argv``."""
    buf = io.StringIO()
    with mock.patch.object(sys, "argv", ["tool", *argv]), contextlib.redirect_stdout(buf):
        module.main()
    return json.loads(buf.getvalue())


def _close(got, want, path="") -> None:
    """Equal structure; numbers within 1e-12 (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _close(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        assert got == pytest.approx(want, abs=1e-12, rel=0), path


@pytest.fixture(scope="module")
def jax_samples():
    return np.stack([np.load(p) for p in sorted(JAX_DEMO.glob("sample_*.npy"))]).astype(np.int32)


@pytest.fixture(scope="module")
def jax_prior():
    batch = jax_synthetic_batch(jax.random.PRNGKey(PRIOR_SEED), PRIOR_BATCH, (PRIOR_SIDE,) * 3)
    return np.asarray(batch).astype(np.int32)


def test_histogram_and_profile_match_the_jax_tool(jax_samples, jax_prior):
    jax_eval = _jax_tool("eval_samples")
    for vols in (jax_samples, jax_prior):
        np.testing.assert_allclose(eval_samples.category_histogram(vols),
                                   jax_eval.category_histogram(vols), rtol=0, atol=1e-12)
        np.testing.assert_allclose(eval_samples.air_depth_profile(vols),
                                   jax_eval.air_depth_profile(vols), rtol=0, atol=1e-12)


def test_report_matches_the_jax_tool_on_the_jax_demo(jax_samples, jax_prior):
    """The JAX tool draws its prior itself (at 16³, so the profile is
    interpolated to the samples' 64 layers); the port's ``report`` gets the
    same batch as numpy."""
    want = _main_json(_jax_tool("eval_samples"), [
        "--samples", str(JAX_DEMO / "sample_*.npy"), "--ref-batch", str(PRIOR_BATCH),
        "--shape", str(PRIOR_SIDE), "--seed", str(PRIOR_SEED)])
    got = eval_samples.report(jax_samples, jax_prior)
    _close(got, want)
    assert want["category_tv_distance"] > 0 and want["sample_shape"] == [64, 64, 64]


def test_port_cli_writes_its_report(tmp_path, jax_samples):
    out = tmp_path / "eval.json"
    with contextlib.redirect_stdout(io.StringIO()):
        report = eval_samples.main(["--samples", str(JAX_DEMO / "sample_*.npy"), "--ref-batch",
                                    "2", "--shape", "16", "--json-out", str(out),
                                    "--device", "cpu"])
    assert json.loads(out.read_text()) == report
    assert report["n_samples"] == len(jax_samples) and report["sample_shape"] == [64, 64, 64]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_samples.main(["--samples", str(JAX_DEMO / "sample_*.npy")])


def test_analyze_matches_the_jax_tool_on_the_jax_demo():
    want = _main_json(_jax_tool("analyze_cond_demo"), ["--dir", str(JAX_COND_DEMO)])
    true = np.load(JAX_COND_DEMO / "true_model.npy").astype(np.int32)
    sols = np.stack([np.load(p) for p in sorted(JAX_COND_DEMO.glob("sol_*.npy"))])
    mask = np.asarray(jax_mask(jax.random.PRNGKey(998), true[None])[0])
    got = analyze_cond_demo.analyze(true, sols, mask)
    assert got == want
    assert want["obs_acc_overall"] == 0.75  # the README's figure


def test_port_cli_redraws_the_port_demos_mask():
    """On the port's own committed demo, the CLI (which redraws the mask from
    seed 998 on the host) reproduces the committed analysis, and its observed
    accuracy is the one the demo computed with the mask it sampled with."""
    with contextlib.redirect_stdout(io.StringIO()):
        report = analyze_cond_demo.main(["--dir", str(PORT_COND_DEMO)])
    assert report == json.loads((PORT_COND_DEMO / "analysis.json").read_text())
    summary = json.loads((PORT_COND_DEMO / "summary.json").read_text())
    assert report["obs_acc_overall"] == summary["observed_voxel_accuracy"]


def _port_prior(seed: int) -> np.ndarray:
    return synthetic_geology_batch(torch.Generator().manual_seed(seed), 16, (16,) * 3).numpy()


def test_prior_vs_prior_statistics_are_tight():
    """``test_eval.py``'s first case on the port's draws: two independent prior
    batches of 16 volumes at 16³ are near-identical under the statistics, and
    so is a port batch beside the JAX generator's. The TV bound is
    ``PRIOR_TV_BOUND``, not ``test_eval.py``'s 0.1: over 40 seed pairs the JAX
    generator's own TV has mean 0.108 and maximum 0.179 (55% of pairs above
    0.1), the port's mean 0.112 and maximum 0.150, JAX against the port 0.111."""
    a, b = _port_prior(0), _port_prior(1)
    ha, hb = eval_samples.category_histogram(a), eval_samples.category_histogram(b)
    assert ha.shape == (15,) and abs(ha.sum() - 1.0) < 1e-6
    assert 0.5 * float(np.abs(ha - hb).sum()) < PRIOR_TV_BOUND
    pa, pb = eval_samples.air_depth_profile(a), eval_samples.air_depth_profile(b)
    assert pa.shape == (16,)
    assert pa[-1] > 0.8 and pa[0] < 0.2  # air above the surface in both
    assert float(np.abs(pa - pb).mean()) < 0.1
    jax_16 = np.asarray(jax_synthetic_batch(jax.random.PRNGKey(0), 16, (16,) * 3))
    report = eval_samples.report(a, jax_16)
    assert report["category_tv_distance"] < PRIOR_TV_BOUND and report["air_profile_mad"] < 0.1


def test_degenerate_samples_are_flagged():
    """``test_eval.py``'s second case: an all-air sample sits far from the prior."""
    fake = -np.ones((2, 16, 16, 16), np.int32)
    report = eval_samples.report(fake, _port_prior(2))
    assert report["category_tv_distance"] > 0.5
    assert report["categories_per_sample"] == [1, 1]
