"""The port's training harness and app against the JAX package's.

* ``CheckpointManager`` retention against the JAX (orbax) manager fed the same
  ``(step, train_loss)`` sequences: the same steps kept, ``latest_step`` and
  ``best_step`` after every save;
* resume exactness on the tiny preset: 8 + 8 micro-steps resumed at the epoch
  boundary give bit-identical params, EMA, ``OptState`` and step to 16;
* the loop's cadence against the JAX loop's on the same config (both with a
  stand-in step, dataset and checkpoint manager): the logged, written,
  checkpointed and callback steps, the callback's firing epochs, and the
  batches each loop draws (a resumed epoch restarts at its first batch);
* ``MetricsWriter``'s CSV byte-identical to the JAX writer's;
* ``InferenceCallback`` sampling with the EMA weights and putting the model's
  own back; the synthetic dataset's stream;
* the app, as ``tests/test_apps.py`` drives the JAX one.
"""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.apps import unconditional as port_app
from flowtrain_stochastic_interpolation_torch.data.synthetic import (
    SyntheticGeoDataset,
    get_dataset,
    synthetic_geology_batch,
)
from flowtrain_stochastic_interpolation_torch.inference import initial_noise, make_sampler
from flowtrain_stochastic_interpolation_torch.train import callbacks as port_callbacks
from flowtrain_stochastic_interpolation_torch.train import loop as port_loop
from flowtrain_stochastic_interpolation_torch.train.checkpoint import (
    CheckpointManager,
)
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state, train
from flowtrain_stochastic_interpolation_torch.train.state import OptState, TrainState
from flowtrain_stochastic_interpolation_torch.utils import logging as port_logging
from flowtrain_stochastic_interpolation_torch.utils.rng import generator
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.train import callbacks as jax_callbacks
from flowtrain_stochastic_interpolation_tpu.train import checkpoint as jax_checkpoint
from flowtrain_stochastic_interpolation_tpu.train import loop as jax_loop
from flowtrain_stochastic_interpolation_tpu.train import state as jax_state
from flowtrain_stochastic_interpolation_tpu.utils import logging as jax_logging

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# Checkpoint retention against orbax
# ---------------------------------------------------------------------------
SEQUENCES = {
    "falling": [(1, 5.0), (2, 4.0), (3, 3.0), (4, 2.0)],
    "rising": [(1, 1.0), (2, 2.0), (3, 3.0), (4, 0.5), (5, 4.0)],  # the newest is deleted
    "ties": [(1, 1.0), (2, 1.0), (3, 1.0), (4, 0.5), (5, 0.5)],
    "without_metrics": [(1, 3.0), (2, None), (3, 1.0), (4, 2.0), (5, 0.5)],
    "repeated_steps": [(2, 1.0), (2, 0.5), (1, 0.1), (5, 2.0), (6, 0.2)],
}


@pytest.mark.parametrize("keep_best_on", ["train_loss", None])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_checkpoint_retention_matches_orbax(tmp_path, name, keep_best_on):
    _, _, state = init_train_state(port_config.tiny_test(), device=CPU)
    ours = CheckpointManager(str(tmp_path / "port"), port_config.tiny_test(), max_to_keep=2,
                             keep_best_on=keep_best_on)
    theirs = jax_checkpoint.CheckpointManager(str(tmp_path / "jax"), None, max_to_keep=2,
                                              keep_best_on=keep_best_on)
    tree = {"w": np.zeros(2, np.float32)}
    for step, loss in SEQUENCES[name]:
        metrics = None if loss is None else {"train_loss": loss}
        ours.save(step, state, metrics=metrics)
        theirs.save(step, tree, metrics=metrics)
        theirs.wait()
        assert ours.all_steps() == list(theirs._mgr.all_steps()), (step, loss)
        assert ours.latest_step() == theirs.latest_step()
        assert ours.best_step() == theirs.best_step()
    theirs.close()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        ["config.json"] + [str(s) for s in ours.all_steps()])  # no temporary directory left
    assert CheckpointManager(str(tmp_path / "port")).latest_step() == theirs.latest_step()
    assert ours.load_config() == port_config.tiny_test()


# ---------------------------------------------------------------------------
# Resume exactness
# ---------------------------------------------------------------------------
def _tiny(accumulate: int):
    cfg = port_config.tiny_test()
    return dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, accumulate_grad_batches=accumulate))


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
        assert torch.equal(a.ema_params[name], b.ema_params[name]), name
    oa, ob = a.opt_state, b.opt_state
    assert (oa.mini_step, oa.updates) == (ob.mini_step, ob.updates)
    for field in ("acc", "mu", "nu"):
        assert len(getattr(oa, field)) == len(getattr(ob, field))
        for x, y in zip(getattr(oa, field), getattr(ob, field)):
            assert torch.equal(x, y), field


@pytest.mark.parametrize("accumulate", [1, 3])
def test_resume_at_the_epoch_boundary_is_bit_identical(tmp_path, accumulate, capsys):
    cfg = _tiny(accumulate)
    assert port_loop.steps_per_epoch(cfg) == 8
    whole = train(cfg, num_steps=16, checkpoint_dir=str(tmp_path / "whole"), device=CPU)
    first = train(cfg, num_steps=8, checkpoint_dir=str(tmp_path / "split"), device=CPU)
    second = train(cfg, num_steps=8, checkpoint_dir=str(tmp_path / "split"), device=CPU)
    assert "[train] resumed from step 8" in capsys.readouterr().out
    assert first.state.step == 8 and second.state.step == 16
    assert second.state.opt_state.mini_step == 16 % accumulate
    _assert_states_equal(second.state, whole.state)
    assert [h["train_loss"] for h in first.history + second.history] == [
        h["train_loss"] for h in whole.history]


# ---------------------------------------------------------------------------
# The loop's cadence against the JAX loop's
# ---------------------------------------------------------------------------
class _Recorder:
    def __init__(self):
        self.writes, self.saves, self.batches, self.tags = [], [], [], []


def _fake_dataset(rec, make):
    class Dataset:
        host_side = False

        def batches(self, batch_size, epoch=0):
            for i in range(3):  # a short epoch of 3 batches
                rec.batches.append((epoch, i))
                yield make()

    return Dataset()


def _fake_manager(rec, start):
    class Manager:
        def __init__(self, directory, config=None, max_to_keep=3, **kw):
            pass

        def latest_step(self):
            return start or None

        def restore(self, state):
            return state.replace(step=jnp.int32(start)) if hasattr(state, "replace") else (
                setattr(state, "step", start) or state)

        def save(self, step, state, metrics=None):
            rec.saves.append(step)

        def wait(self):
            pass

        def close(self):
            pass

    return Manager


class _Writer:
    def __init__(self, rec):
        self.rec = rec

    def write(self, step, metrics):
        self.rec.writes.append(step)

    def log_image(self, step, name, path):
        self.rec.tags.append(name)


def _run_jax_loop(monkeypatch, cfg, start, num_steps, tmp_path):
    rec = _Recorder()
    state = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params={"w": jnp.zeros(2)},
                                 constants={}, opt_state=(), ema_params=None)

    def step_fn(state, batch, key):
        return state.replace(step=state.step + 1), {"train_loss": jnp.float32(state.step)}

    monkeypatch.setattr(jax_loop, "init_train_state", lambda config, mesh: (None, None, state))
    monkeypatch.setattr(jax_loop, "make_train_step", lambda model, tx, config: step_fn)
    monkeypatch.setattr(jax_loop, "get_dataset",
                        lambda data, seed: _fake_dataset(rec, lambda: np.zeros(1)))
    monkeypatch.setattr(jax_loop, "shard_batch", lambda batch, mesh: batch)
    monkeypatch.setattr(jax_loop, "CheckpointManager", _fake_manager(rec, start))
    callback = jax_callbacks.InferenceCallback(
        jax_config.ExperimentConfig.from_dict(cfg.to_dict()), None, str(tmp_path / "jax"),
        every_n_epochs=2)
    monkeypatch.setattr(callback, "run_inference", lambda s, tag: rec.tags.append(tag))
    result = jax_loop.train(jax_config.ExperimentConfig.from_dict(cfg.to_dict()),
                            num_steps=num_steps, mesh="mesh", checkpoint_dir=str(tmp_path),
                            writer=_Writer(rec), callback=callback)
    return [h["step"] for h in result.history], rec


def _run_port_loop(monkeypatch, cfg, start, num_steps, tmp_path):
    rec = _Recorder()
    state = TrainState(step=0, params={"w": torch.zeros(2)}, constants={},
                       opt_state=OptState(), ema_params=None)

    def step_fn(state, batch, gen):
        metrics = {"train_loss": torch.tensor(float(state.step))}
        state.step += 1
        return state, metrics

    monkeypatch.setattr(port_loop, "init_train_state", lambda config, device: (None, None, state))
    monkeypatch.setattr(port_loop, "make_train_step", lambda model, tx, config: step_fn)
    monkeypatch.setattr(port_loop, "get_dataset",
                        lambda data, seed, device: _fake_dataset(rec, lambda: torch.zeros(1)))
    monkeypatch.setattr(port_loop, "CheckpointManager", _fake_manager(rec, start))
    callback = port_callbacks.InferenceCallback(cfg, None, str(tmp_path / "port"),
                                                every_n_epochs=2)
    monkeypatch.setattr(callback, "run_inference", lambda s, tag: rec.tags.append(tag))
    result = train(cfg, num_steps=num_steps, checkpoint_dir=str(tmp_path),
                   writer=_Writer(rec), callback=callback, device=CPU)
    return [h["step"] for h in result.history], rec


# (log_every_n_steps, epoch_size // batch_size, checkpoint_every_steps, num_steps, resume step)
CADENCES = [(3, 5, 4, 11, 0), (5, 3, 7, 10, 0), (2, 5, 3, 9, 7), (1, 1, 1, 4, 0),
            (4, 2, 5, 13, 3)]


@pytest.mark.parametrize("log_every,per_epoch,ckpt_every,num_steps,start", CADENCES)
def test_loop_cadence_matches_jax(monkeypatch, tmp_path, log_every, per_epoch, ckpt_every,
                                  num_steps, start):
    cfg = port_config.tiny_test()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=4, epoch_size=4 * per_epoch),
        training=dataclasses.replace(cfg.training, log_every_n_steps=log_every,
                                     checkpoint_every_steps=ckpt_every))
    ours = _run_port_loop(monkeypatch, cfg, start, num_steps, tmp_path)
    theirs = _run_jax_loop(monkeypatch, cfg, start, num_steps, tmp_path)
    assert ours[0] == theirs[0]  # the history's steps
    for field in ("writes", "saves", "batches", "tags"):
        assert getattr(ours[1], field) == getattr(theirs[1], field), field
    assert ours[1].saves[-1] == start + num_steps
    if start:  # the resumed epoch's stream starts again at its first batch
        assert ours[1].batches[0] == (start // per_epoch, 0)


def test_metrics_writer_csv_is_byte_identical_to_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    writes = [(0, {"time_to_solve": 0.5}), (1, {"train_loss": 2.0, "grad_norm": 1.5}),
              (2, {"train_loss": 1.25, "grad_norm": 0.75}), (2, {"time_to_solve": 0.25}),
              (3, {"train_loss": 1.0, "grad_norm": 0.5, "lr": 1e-3})]
    for module, name in ((port_logging, "port"), (jax_logging, "jax")):
        for chunk in (writes[:3], writes[3:]):  # a second writer appends, as a resumed run does
            writer = module.MetricsWriter(str(tmp_path / name))
            for step, metrics in chunk:
                writer.write(step, metrics)
            assert writer.log_image(3, "missing", str(tmp_path / "none.png"), retries=1) is False
            writer.close()
    port_csv = (tmp_path / "port" / "metrics.csv").read_bytes()
    assert port_csv == (tmp_path / "jax" / "metrics.csv").read_bytes()
    assert port_csv.splitlines()[0] == b"step,time,time_to_solve,train_loss,grad_norm,lr"


# ---------------------------------------------------------------------------
# The callback, the dataset
# ---------------------------------------------------------------------------
def test_callback_samples_with_the_ema_weights_and_puts_the_model_back(tmp_path):
    cfg = port_config.tiny_test()
    model, _, state = init_train_state(cfg, device=CPU)
    with torch.no_grad():
        for p in state.ema_params.values():
            p.mul_(0.5)  # the shadow differs from the params
    sampler_model = port_loop.init_model_variables(cfg, seed=3, device=CPU)
    own = {k: v.detach().clone() for k, v in sampler_model.named_parameters()}
    rec = _Recorder()
    cb = port_callbacks.InferenceCallback(cfg, sampler_model, str(tmp_path), n_samples=2,
                                          n_frames=3, writer=_Writer(rec))
    out = cb.run_inference(state, tag="t")
    assert rec.writes == [0] and out["time_to_solve"] > 0
    assert rec.tags == ["samples/t_0", "prominence/t_0", "samples/t_1", "prominence/t_1"]
    assert out["decoded"].shape == out["prominence"].shape == (2, 8, 8, 8)
    for k, v in sampler_model.named_parameters():
        assert torch.equal(v, own[k]), k  # its own weights are back
    # the same solve on the EMA weights, from the callback's seeded x0
    model.load_state_dict(state.ema_params)
    x0 = initial_noise(torch.Generator().manual_seed(42), 2, (8, 8, 8), 15, torch.float32, CPU)
    want = make_sampler(model, state.constants["embedding"], t0=cfg.inference.t0, tf=0.999,
                        n_frames=3, substeps=1, method="euler", with_prominence=True)(x0)
    np.testing.assert_array_equal(out["decoded"], want["decoded"].numpy() - 1)
    np.testing.assert_array_equal(out["prominence"], want["prominence"].numpy())


def test_dataset_stream_is_seeded_by_seed_epoch_and_index():
    data = SyntheticGeoDataset((8, 8, 8), dataset_size=12, seed=3, device=CPU)
    first = list(data.batches(4, epoch=1))
    assert len(first) == 3 and all(b.shape == (4, 8, 8, 8) for b in first)
    assert all(torch.equal(a, b) for a, b in zip(first, data.batches(4, epoch=1)))
    assert not torch.equal(first[0], next(data.batches(4, epoch=0)))
    assert torch.equal(first[2], synthetic_geology_batch(generator(CPU, 3, 1, 2), 4, (8, 8, 8)))
    # fewer volumes than one batch still make one batch an epoch, as in JAX
    assert len(list(SyntheticGeoDataset((8, 8, 8), dataset_size=3, device=CPU).batches(4))) == 1
    cfg = port_config.tiny_test().data
    assert isinstance(get_dataset(cfg, seed=1, device=CPU), SyntheticGeoDataset)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        get_dataset(dataclasses.replace(cfg, source="geogen"), device=CPU)


def test_with_ema_applied_and_state_dict_round_trip():
    _, _, state = init_train_state(port_config.tiny_test(), device=CPU)
    assert state.with_ema_applied().params is state.ema_params
    no_ema = dataclasses.replace(state, ema_params=None)
    assert no_ema.with_ema_applied() is no_ema
    saved = {k: v for k, v in state.state_dict().items()}
    cfg = port_config.tiny_test()
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, seed=9))
    _, _, other = init_train_state(cfg, device=CPU)
    other.load_state_dict(saved)
    _assert_states_equal(other, state)
    with pytest.raises(ValueError, match="EMA"):
        dataclasses.replace(other, ema_params=None).load_state_dict(saved)


# ---------------------------------------------------------------------------
# The app
# ---------------------------------------------------------------------------
def _run_app(args, **env):
    proc = subprocess.run(
        [sys.executable, "-m", "flowtrain_stochastic_interpolation_torch.apps.unconditional",
         *args], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **env))
    return proc


TINY_BOTH = ["--preset", "tiny", "--mode", "both", "--steps", "3", "--n-samples", "2",
             "--batch-size", "2", "--seed", "7", "--train-devices", "cpu", "--infer-device",
             "cpu", "--no-save-images", "--no-pretrain-smoke"]


def test_app_trains_samples_and_resumes_on_the_cpu(tmp_path):
    proc = _run_app(TINY_BOTH + ["--root-dir", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "samples/min" in proc.stdout and "resumed" not in proc.stdout
    samples = tmp_path / "samples" / "tiny-smoke"
    decoded = sorted(samples.glob("decoded_s7_*.npy"))
    assert len(decoded) == 2
    for path in decoded:
        vol = np.load(path)
        assert vol.shape == (8, 8, 8) and vol.dtype == np.int8
        assert vol.min() >= -1 and vol.max() <= 13
    header = (tmp_path / "metrics" / "tiny-smoke" / "metrics.csv").read_text().splitlines()[0]
    assert {"train_loss", "grad_norm"} <= set(header.split(","))
    assert CheckpointManager(str(tmp_path / "saved_models" / "tiny-smoke")).latest_step() == 3

    again = _run_app(TINY_BOTH + ["--root-dir", str(tmp_path)])
    assert again.returncode == 0, again.stderr[-4000:]
    assert "[train] resumed from step 3" in again.stdout
    assert "loaded checkpoint step 6" in again.stdout


def test_app_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    proc = _run_app(["--preset", "flagship", "--mode", "inference", "--root-dir", str(tmp_path)])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "samples/min" not in proc.stdout


def test_app_raises_for_what_is_not_ported(tmp_path):
    dirs = port_app.setup_directories(str(tmp_path), "tiny-smoke")
    with pytest.raises(NotImplementedError, match="ckpt"):
        port_app.load_variables(port_config.tiny_test(), "weights.ckpt", dirs, device="cpu")
    with pytest.raises(NotImplementedError, match="dopri5"):
        port_app.main(["--preset", "tiny", "--mode", "inference", "--adaptive",
                       "--infer-device", "cpu", "--root-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        port_app.parse_arguments(["--train-devices", "0,1"])
    args = port_app.parse_arguments([])
    assert (args.train_devices, args.infer_device, args.mode) == ("cuda", "cuda", "inference")


def test_app_reads_release_weights_and_starts_fresh_without_any(tmp_path, capsys):
    cfg = port_config.tiny_test()
    model = port_loop.init_model_variables(cfg, seed=4, device=CPU)
    from flowtrain_stochastic_interpolation_torch.models import persistence

    persistence.save_release_weights(
        str(tmp_path / "release"), params=persistence.params_to_jax(model.state_dict()),
        config_json=cfg.to_json(), step=11, dtype="float32")
    dirs = port_app.setup_directories(str(tmp_path / "root"), cfg.name)
    loaded, table = port_app.load_variables(cfg, str(tmp_path / "release"), dirs, device="cpu")
    assert "loaded release weights step 11" in capsys.readouterr().out
    assert not loaded.training and table.shape == (15, 15)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    port_app.load_variables(cfg, None, dirs, device="cpu")
    assert "WARNING: no checkpoint found" in capsys.readouterr().out
