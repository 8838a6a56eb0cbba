"""``tools.export_weights`` and ``tools.sample_from_ckpt`` against the JAX package.

A checkpoint of the port (the tiny preset with RandomFourier time, so that the
model has constants, and an EMA shadow apart from the params) goes through
``export_weights``; the JAX package's ``load_release_weights`` reads the
release: every leaf bit-equal to the same f32 values cast by JAX (bf16 and
f32 releases), the config equal to the run's. The flax tiny model's forward on
those weights agrees with the port's within 1e-5 in f32. ``sample_from_ckpt``
reads the port's release, a release written by the JAX package and a port
checkpoint, and prints the JAX tool's keys.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch.config import tiny_test
from flowtrain_stochastic_interpolation_torch.models.persistence import (
    params_to_jax,
    variables_to_jax,
)
from flowtrain_stochastic_interpolation_torch.tools import export_weights, sample_from_ckpt
from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.models.persistence import (
    load_release_weights as jax_load_release,
    save_release_weights as jax_save_release,
)
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model

STEP = 7
FORWARD_TOL = 1e-5
# the JAX tool's printed keys (tools/sample_from_ckpt.py:134-141)
SAMPLE_KEYS = {"air_frac_top", "air_frac_bottom", "n_categories_used", "prominence_mean",
               "seconds_per_batch"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port checkpoint directory at step ``STEP`` and its state."""
    cfg = tiny_test()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, time_learned_emb=False))
    _, _, state = init_train_state(cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for v in state.ema_params.values():
            v.add_(0.01 * torch.randn(v.shape, generator=gen))
    state.step = STEP
    path = tmp_path_factory.mktemp("run") / "ckpt"
    CheckpointManager(str(path), cfg).save(STEP, state, metrics={"train_loss": 1.0})
    return path, cfg, state


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_jax_reads_the_export_bit_equal(tmp_path, checkpoint, dtype):
    path, cfg, state = checkpoint
    with contextlib.redirect_stdout(io.StringIO()):
        size = export_weights.main(["--ckpt", str(path), "--out", str(tmp_path), "--dtype", dtype,
                                    "--note", "test"])
    assert size == sum(p.stat().st_size for p in tmp_path.iterdir())
    tree, config, meta = jax_load_release(str(tmp_path))
    assert meta == {"step": STEP, "dtype": dtype, "note": "test"}
    assert config == jax_config.ExperimentConfig.from_dict(cfg.to_dict())
    expected = {"params": params_to_jax(state.params),
                "ema_params": params_to_jax(state.ema_params),
                "constants": params_to_jax(state.model_buffers())}
    assert expected["constants"]  # RandomFourier's frozen features
    for part, want_tree in expected.items():
        got = dict(_leaves(tree[part]))
        want = dict(_leaves(want_tree))
        assert set(got) == set(want), part
        for key, value in want.items():
            if dtype == "bfloat16" and part != "constants":  # JAX's cast, widened back
                value = np.asarray(jnp.asarray(value).astype(jnp.bfloat16).astype(jnp.float32))
            assert np.asarray(got[key]).dtype == np.float32
            np.testing.assert_array_equal(np.asarray(got[key]), value, err_msg=f"{part} {key}")


def test_flax_forward_on_the_export_matches_the_port(tmp_path, checkpoint):
    path, cfg, state = checkpoint
    with contextlib.redirect_stdout(io.StringIO()):
        export_weights.main(["--ckpt", str(path), "--out", str(tmp_path), "--dtype", "float32"])
    tree, config, _ = jax_load_release(str(tmp_path))
    flax_model = jax_build_model(config)
    variables = {"params": tree["params"], "constants": tree["constants"]}
    model, _, restored = init_train_state(cfg, device="cpu")
    CheckpointManager(str(path)).restore(restored)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, *cfg.data.shape, cfg.data.embedding_dim, generator=gen)
    t = torch.tensor([0.25, 0.75])
    with torch.no_grad():
        want = model.eval()(x, t).numpy()
    got = np.asarray(jax.jit(flax_model.apply)(variables, jnp.asarray(x.numpy()),
                                               jnp.asarray(t.numpy())))
    np.testing.assert_allclose(got, want, rtol=FORWARD_TOL, atol=FORWARD_TOL)


def _sample(ckpt, out, *argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = sample_from_ckpt.main(["--ckpt", str(ckpt), "--out", str(out), "--device",
                                         "cpu", "--n-samples", "2", "--batch-size", "2",
                                         "--n-frames", "2", *argv])
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == summary
    return summary


def test_sample_from_the_ports_release_a_jax_release_and_a_checkpoint(tmp_path, checkpoint):
    path, cfg, state = checkpoint
    port_release = tmp_path / "port"
    with contextlib.redirect_stdout(io.StringIO()):
        export_weights.main(["--ckpt", str(path), "--out", str(port_release)])
    jax_release = tmp_path / "jax"
    model, _, _ = init_train_state(cfg, device="cpu")
    variables = variables_to_jax(model)
    jcfg = jax_config.ExperimentConfig.from_dict(cfg.to_dict())
    jax_save_release(str(jax_release), params=variables["params"],
                     model_constants=variables["constants"], config_json=jcfg.to_json(), step=1)
    for source, argv in ((port_release, ["--ema"]), (jax_release, []), (path, ["--ema"]),
                         (port_release, ["--no-folded", "--method", "sde", "--no-prominence"])):
        summary = _sample(source, tmp_path / "out", *argv)
        assert set(summary) == SAMPLE_KEYS
        assert (summary["prominence_mean"] is None) == ("--no-prominence" in argv)
        assert np.load(tmp_path / "out" / "sample_1.npy").shape == cfg.data.shape
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_from_ckpt.main(["--ckpt", str(port_release), "--out", str(tmp_path / "x")])
