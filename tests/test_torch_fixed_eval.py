"""``tools/fixed_eval.py``: the fixed-evaluation loss and the window means.

The fixed evaluation runs on ``tiny_test`` weights over a two-batch set, from
a checkpoint directory and from its release exports: the same weights (the
EMA shadow, by ``sample_from_ckpt``'s rule) give the same losses whatever
holds them, the set is the same on every call, and each per-volume loss is
the JAX package's ``make_eval_loss`` on the same weights, volume and draws.
Rounding every parameter to bf16 (``--round-bf16 .``) gives the bf16
release's losses. The window statistic reproduces, from the committed
``metrics.csv`` files, the means and standard errors that the demos'
comparison quotes (steps 2500-2999, the last row of a repeated step).
"""

import contextlib
import dataclasses
import io
import json
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch.config import tiny_test
from flowtrain_stochastic_interpolation_torch.models.persistence import params_to_jax
from flowtrain_stochastic_interpolation_torch.tools import export_weights, fixed_eval
from flowtrain_stochastic_interpolation_torch.train import objectives as port_objectives
from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.train import objectives as jax_objectives
from flowtrain_stochastic_interpolation_tpu.train import state as jax_state
from flowtrain_stochastic_interpolation_tpu.train import steps as jax_steps
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model

ROOT = Path(__file__).resolve().parents[1]
SIDE, BATCHES, BATCH_SIZE, STEP = 8, 2, 2, 5
# the committed demos' metrics.csv: (rows in the file, steps, window mean, its standard error)
WINDOWS = {
    "artifacts/torch/train_demo/metrics.csv": (302, 302, 0.1641, 0.0150),
    "artifacts/train_demo/metrics.csv": (363, 302, 0.1464, 0.0128),
    "artifacts/torch/train_demo_cond/metrics.csv": (301, 301, 0.2267, 0.0177),
    "artifacts/train_demo_cond/metrics.csv": (301, 301, 0.2397, 0.0210),
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny checkpoint whose EMA shadow differs from its params, and its two
    release exports."""
    cfg = tiny_test()
    _, _, state = init_train_state(cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for v in state.ema_params.values():
            v.add_(0.05 * torch.randn(v.shape, generator=gen))
    state.step = STEP
    root = tmp_path_factory.mktemp("fixed_eval")
    ckpt = root / "ckpt"
    CheckpointManager(str(ckpt), cfg).save(STEP, state, metrics={"train_loss": 1.0})
    with contextlib.redirect_stdout(io.StringIO()):
        for dtype in ("float32", "bfloat16"):
            export_weights.main(["--ckpt", str(ckpt), "--out", str(root / dtype),
                                 "--dtype", dtype])
    return root, cfg, state


def _main(*argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        report = fixed_eval.main([*argv, "--device", "cpu"])
    return report, out.getvalue()


def test_fixed_eval_of_one_run_held_three_ways(run):
    root, cfg, state = run
    paths = [str(root / "ckpt"), str(root / "float32"), str(root / "bfloat16")]
    report, text = _main("--weights", *paths, "--batches", str(BATCHES), "--batch-size",
                         str(BATCH_SIZE), "--shape", str(SIDE), "--band", "1.5",
                         "--json-out", str(root / "fixed_eval.json"))
    assert json.loads((root / "fixed_eval.json").read_text()) == json.loads(json.dumps(report))
    assert report["device"] == "cpu" and report["card"] == "cpu" and "fixed-evaluation" in text
    ckpt, f32, bf16 = report["weights"]
    assert [r["step"] for r in report["weights"]] == [STEP] * 3
    assert [r["storage"] for r in report["weights"]] == [
        "checkpoint", "release float32", "release bfloat16"]
    for r in report["weights"]:
        assert r["n"] == BATCHES * BATCH_SIZE and np.isfinite([r["mean"], r["se"]]).all()
        assert r["se"] > 0 and len(r["batch_means"]) == BATCHES
    # one set of weights, however it is held: the f32 export is the checkpoint's
    np.testing.assert_allclose(f32["mean"], ckpt["mean"], rtol=1e-6)
    np.testing.assert_allclose(f32["batch_means"], ckpt["batch_means"], rtol=1e-6)
    assert bf16["mean"] != ckpt["mean"]  # rounded weights, nearly the same loss
    np.testing.assert_allclose(bf16["mean"], ckpt["mean"], rtol=2e-2)
    assert all(v["within_band"] for v in report["comparison"]["weights"])

    # the same set on every call; another seed, another set
    again, _ = _main("--weights", paths[0], "--batches", str(BATCHES), "--batch-size",
                     str(BATCH_SIZE), "--shape", str(SIDE))
    assert again["weights"][0]["batch_means"] == ckpt["batch_means"]
    other, _ = _main("--weights", paths[0], "--batches", str(BATCHES), "--batch-size",
                     str(BATCH_SIZE), "--shape", str(SIDE), "--seed", "1")
    assert other["weights"][0]["mean"] != ckpt["mean"]


def test_fixed_eval_losses_are_jax_eval_losses_of_the_ema_weights(run):
    """Every per-volume loss against the JAX ``make_eval_loss`` of the EMA shadow
    on the same volume and draws (the JAX draws patched with the port's)."""
    _, cfg, state = run
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, shape=(SIDE,) * 3))
    model, table, _ = fixed_eval.load(str(run[0] / "ckpt"), ema=True, no_folded=False,
                                      dev=torch.device("cpu"))
    seen = []
    draw = port_objectives._draw_common

    def recording(generator, batch, *args):
        out = draw(generator, batch, *args)
        seen.append((batch.numpy().copy(), [a.numpy().copy() for a in out]))
        return out

    with mock.patch.object(port_objectives, "_draw_common", recording):
        losses = fixed_eval.fixed_eval_losses(model, table, cfg, batches=1,
                                              batch_size=BATCH_SIZE, shape=(SIDE,) * 3)
    assert len(seen) == BATCH_SIZE == losses.size

    jcfg = jax_config.ExperimentConfig.from_dict(cfg.to_dict())
    jmodel = jax_build_model(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_jax(state.ema_params))
    jstate = jax_state.init_state(jparams, {"embedding": jnp.asarray(table.numpy())},
                                  jax_state.make_optimizer(jcfg.training, 1), jcfg.ema)
    for loss, (batch, drawn) in zip(losses, seen):
        fixed = tuple(jnp.asarray(a) for a in drawn)
        with mock.patch.object(jax_objectives, "_draw_common", lambda *a, **k: fixed):
            want = jax_steps.make_eval_loss(jmodel, jcfg)(jstate, jnp.asarray(batch),
                                                          jax.random.PRNGKey(0))
        np.testing.assert_allclose(loss, float(want["train_loss"]), rtol=1e-5)


def test_rounding_every_leaf_to_bf16_is_the_bf16_release(run):
    root, _, state = run
    args = ("--batches", "1", "--batch-size", str(BATCH_SIZE), "--shape", str(SIDE))
    rounded, text = _main("--weights", str(root / "float32"), "--round-bf16", ".", *args)
    release, _ = _main("--weights", str(root / "bfloat16"), *args)
    none, _ = _main("--weights", str(root / "float32"), "--round-bf16", "^no such leaf$", *args)
    unrounded, _ = _main("--weights", str(root / "float32"), *args)
    assert rounded["weights"][0]["rounded_leaves"] == len(state.params) and "rounded" in text
    assert rounded["weights"][0]["batch_means"] == release["weights"][0]["batch_means"]
    assert none["weights"][0]["rounded_leaves"] == 0
    assert none["weights"][0]["batch_means"] == unrounded["weights"][0]["batch_means"]


@pytest.mark.parametrize("path", sorted(WINDOWS))
def test_window_statistic_of_the_committed_demos(path):
    rows_in_file, steps, mean, se = WINDOWS[path]
    stats = fixed_eval.window_stats(str(ROOT / path))
    assert (stats["rows_in_file"], stats["steps_in_file"], stats["rows"]) == (rows_in_file,
                                                                             steps, 51)
    assert (round(stats["mean"], 4), round(stats["se"], 4)) == (mean, se)


def test_window_statistic_keeps_a_repeated_steps_last_row(tmp_path):
    path = tmp_path / "metrics.csv"
    path.write_text("step,time,train_loss,grad_norm\n10,0,9.0,1\n20,0,2.0,1\n10,0,4.0,1\n"
                    "30,0,6.0,1\n")
    stats = fixed_eval.window_stats(str(path), (10, 20))
    assert stats["rows"] == 2 and stats["mean"] == 3.0 and stats["se"] == 1.0 / np.sqrt(2)
    with pytest.raises(ValueError):
        fixed_eval.window_stats(str(path), (40, 50))


def test_band_comparison():
    weights = [{"path": "ref", "mean": 0.1}, {"path": "in", "mean": 0.149},
               {"path": "out", "mean": 0.0666}]
    windows = [{"path": "a", "mean": 0.15, "se": 0.03}, {"path": "b", "mean": 0.26, "se": 0.04}]
    verdict = fixed_eval.compare(weights, windows, 1.5)
    assert [v["within_band"] for v in verdict["weights"]] == [True, False]
    assert verdict["windows"][0]["combined_se"] == pytest.approx(0.05)
    assert verdict["windows"][0]["within_3se"] and not verdict["met"]


def test_fixed_eval_needs_the_card_unless_told(run):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fixed_eval.main(["--weights", str(run[0] / "ckpt")])
