"""``tools.train_demo`` on the CPU at the tiny preset, and its loop against JAX's step.

The tool's outputs keep the JAX tool's shapes: ``metrics.csv`` with the
header of the JAX demo's committed file of each mode, rows every 10 steps and
at the last, the summary's keys. ``--resume`` continues the checkpoint and a
rerun at ``--steps`` only samples; ``--init-from`` takes a release directory
or a checkpoint directory trained at another ``--shape``. Then the demo loop
(``run_loop``), fed the JAX demo's batches (``fold_in(PRNGKey(7), step)``),
the JAX step's draws and the same weights, against the JAX package's
``make_train_step`` over the same batches: the first 3 losses within 1e-4
relative (f32 on both sides; the tiny preset has no dropout, so no dropout
draw stands between them).
"""

import contextlib
import csv
import io
import json
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch.models.persistence import (
    params_to_jax,
    save_release_weights,
)
from flowtrain_stochastic_interpolation_torch.tools import train_demo
from flowtrain_stochastic_interpolation_torch.train import objectives as port_objectives
from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state
from flowtrain_stochastic_interpolation_torch.train.steps import make_train_step
from flowtrain_stochastic_interpolation_torch.utils.logging import MetricsWriter
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.data.synthetic import synthetic_geology_batch
from flowtrain_stochastic_interpolation_tpu.train import state as jax_state
from flowtrain_stochastic_interpolation_tpu.train import steps as jax_steps
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model
from flowtrain_stochastic_interpolation_tpu.train.objectives import _draw_common as jax_draw_common

ROOT = Path(__file__).resolve().parents[1]
# the JAX tool's summary keys (tools/train_demo.py:247-255, 279-282, 305-309)
SUMMARY_KEYS = {"conditional", "steps", "batch", "accum", "elapsed_s", "loss_first", "loss_last"}
COND_KEYS = {"observed_voxel_accuracy", "ensemble_agreement"}
UNCOND_KEYS = {"air_frac_top", "air_frac_bottom", "prominence_mean"}
STEPS = 12
LOSS_REL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _demo(out, *argv):
    """``train_demo.main`` at the tiny preset on the CPU, the sampler cut to 2
    frames: ``(summary, printed text)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = train_demo.main(["--preset", "tiny", "--device", "cpu", "--n-frames", "2",
                                   "--out", str(out), *argv])
    return summary, buf.getvalue()


def _csv(path: Path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [int(r[0]) for r in rows[1:]]


@pytest.mark.parametrize("conditional", [False, True])
def test_outputs_keep_the_jax_demos_shapes(tmp_path, conditional):
    flag = ["--conditional"] if conditional else []
    summary, _ = _demo(tmp_path, "--steps", str(STEPS), *flag)
    header, steps = _csv(tmp_path / "metrics.csv")
    jax_csv = ROOT / "artifacts" / ("train_demo_cond" if conditional else "train_demo") / "metrics.csv"
    assert header == _csv(jax_csv)[0]
    assert steps == [0, 10, STEPS - 1]
    assert set(summary) == SUMMARY_KEYS | (COND_KEYS if conditional else UNCOND_KEYS)
    assert json.loads((tmp_path / "summary.json").read_text()) == summary
    assert summary["steps"] == STEPS and summary["batch"] == (2 if conditional else 4)
    written = sorted(p.name for p in tmp_path.glob("*.npy"))
    assert written == (["sol_0.npy", "sol_1.npy", "sol_2.npy", "sol_3.npy", "true_model.npy"]
                       if conditional else [f"sample_{i}.npy" for i in range(4)])
    volume = np.load(tmp_path / written[0])
    assert volume.dtype == np.int8 and volume.shape == (8, 8, 8) and volume.min() >= -1
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == STEPS


def test_resume_continues_and_a_rerun_only_samples(tmp_path):
    _demo(tmp_path, "--steps", "5")
    summary, text = _demo(tmp_path, "--steps", str(STEPS), "--resume")
    assert "resumed from step 5" in text
    assert _csv(tmp_path / "metrics.csv")[1] == [0, 4, 10, STEPS - 1]
    assert summary["loss_first"] is not None
    rerun, text = _demo(tmp_path, "--steps", str(STEPS), "--resume")
    assert f"resumed from step {STEPS}" in text
    assert rerun["loss_first"] is None and rerun["loss_last"] is None
    assert _csv(tmp_path / "metrics.csv")[1] == [0, 4, 10, STEPS - 1]  # no new rows
    assert set(rerun) == SUMMARY_KEYS | UNCOND_KEYS


def test_init_from_a_release_and_a_checkpoint_at_another_shape(tmp_path):
    src = tmp_path / "src"
    _demo(src, "--steps", "3", "--accum", "2")  # accumulation: an optimiser state of another shape
    cfg = train_demo.demo_config(train_demo.parse_arguments(["--preset", "tiny", "--accum", "2"]))
    _, _, state = init_train_state(cfg, device="cpu")
    CheckpointManager(str(src / "ckpt")).restore(state)
    release = tmp_path / "release"
    save_release_weights(str(release), params=params_to_jax(state.params),
                         ema_params=params_to_jax(state.ema_params), config_json=cfg.to_json(),
                         step=3, dtype="float32")
    for source, want in ((release, state.ema_params), (src / "ckpt", state.params)):
        out = tmp_path / source.name
        summary, text = _demo(out, "--steps", "0", "--shape", "16", "--init-from", str(source))
        assert f"warm-started from {source} (step 3)" in text
        assert summary["steps"] == 0 and summary["loss_first"] is None
        assert np.load(out / "sample_0.npy").shape == (16, 16, 16)
        # the warm start holds the source's weights, and (with EMA) the shadow too
        args = train_demo.parse_arguments(["--preset", "tiny", "--shape", "16"])
        config = train_demo.demo_config(args)
        model, _, fresh = init_train_state(config, device="cpu")
        step = train_demo.warm_start(model, fresh, config, str(source), "cpu")
        assert step == 3 and fresh.step == 0 and fresh.opt_state.updates == 0
        for k, v in want.items():
            torch.testing.assert_close(fresh.params[k], v, rtol=0, atol=0)
            torch.testing.assert_close(fresh.ema_params[k], state.ema_params[k]
                                       if source == src / "ckpt" else v, rtol=0, atol=0)


def test_the_demo_loops_first_losses_match_jax(tmp_path):
    args = train_demo.parse_arguments(["--preset", "tiny", "--steps", "3"])
    cfg = train_demo.demo_config(args)
    model, tx, state = init_train_state(cfg, device="cpu")
    table = state.constants["embedding"].numpy()

    # JAX: the demo's loop over its own batches and key, from the same weights
    jcfg = jax_config.ExperimentConfig.from_dict(cfg.to_dict())
    jtx = jax_state.make_optimizer(jcfg.training, updates_per_epoch=tx.transition_steps)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))
    jstate = jax_state.init_state(jparams, {"embedding": jnp.array(table)}, jtx, jcfg.ema)
    jstep = jax_steps.make_train_step(jax_build_model(jcfg), jtx, jcfg)
    key = jax.random.PRNGKey(train_demo.DEMO_SEED)
    batches, draws, want = [], [], []
    for step in range(3):
        batch = synthetic_geology_batch(jax.random.fold_in(key, step), args.batch_size,
                                        cfg.data.shape)
        k_data, _ = jax.random.split(jax.random.fold_in(key, step))
        _, x1, x0, t = jax_draw_common(k_data, batch, jnp.asarray(table),
                                       cfg.training.time_range, cfg.training.x1_noise)
        batches.append(torch.from_numpy(np.array(batch)))
        draws.append(tuple(torch.from_numpy(np.array(a)) for a in (x1, x0, t)))
        jstate, metrics = jstep(jstate, batch, key)
        want.append(float(metrics["train_loss"]))

    # the port: run_loop over the same batches, each step fed its JAX draws
    got, step_fn, feed = [], make_train_step(model, tx, cfg), iter(draws)

    def recording(state, batch, generator):
        state, metrics = step_fn(state, batch, generator)
        got.append(float(metrics["train_loss"]))
        return state, metrics

    writer = MetricsWriter(str(tmp_path))
    with mock.patch.object(port_objectives, "_draw_common", lambda *a: (None, *next(feed))):
        state, logged = train_demo.run_loop(
            recording, state, lambda s: batches[s], lambda s: torch.Generator(), steps=3,
            writer=writer, conditional=False)
    writer.close()
    print(f"losses: port {got}, JAX {want}")
    np.testing.assert_allclose(got, want, rtol=LOSS_REL_TOL)
    assert logged == [got[0], got[2]] and state.step == 3
