"""The port's conditional apps, the unconditional app's ``--adaptive``, and the
conditional ``InferenceCallback``, on the CPU at the 8³ tiny presets.

* ``apps.conditional --preset tiny --device cpu --steps 8``, then again on the
  same root directory: the second run resumes from step 8; checkpoints at 8
  and 16; ``metrics.csv`` has the loss and its flow and reconstruct parts.
* ``apps.inference_experiments`` at the tiny preset, all stages, with
  ``--method sde`` and ``--method heun``: the scenario files (int8), the
  ensemble's ``sol_*.npy`` (int8 in [-1, 13]) and the maps; the SDE ensemble
  is the same on a second populate; the scenarios are seeded.
* ``apps.unconditional --adaptive``: dopri5 at the config's 1e-6, a positive
  NFE of the form 1 + 6k.
* The callback on ``tiny_test(conditional=True)``: it runs, writes
  ``time_to_solve``, and decodes what JAX's ``make_sampler(conditional=True)``
  decodes with an all-zero ATb from the same x0 and weights
  (``params_from_jax``), exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import random_params

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.apps import conditional as cond_app
from flowtrain_stochastic_interpolation_torch.apps import inference_experiments as exp_app
from flowtrain_stochastic_interpolation_torch.apps import unconditional as uncond_app
from flowtrain_stochastic_interpolation_torch.inference import initial_noise
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.train.callbacks import InferenceCallback
from flowtrain_stochastic_interpolation_torch.train.checkpoint import find_steps
from flowtrain_stochastic_interpolation_torch.train.loop import build_model, init_train_state
from flowtrain_stochastic_interpolation_torch.utils.logging import MetricsWriter
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu import inference as jax_inference
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model

SHAPE, E = (8, 8, 8), 15
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several workers
    at once, and a full thread pool in each oversubscribes the cores (small
    operations then wait on spinning threads, a hundredfold slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_conditional_app_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--preset", "tiny", "--device", "cpu", "--steps", "8", "--root-dir", str(tmp_path)]
    first = cond_app.main(argv)
    out = capsys.readouterr().out
    assert first.state.step == 8 and "resumed" not in out
    assert "steps/s, final loss" in out and "(flow " in out and ", reconstruct " in out
    last = first.history[-1]
    assert np.isfinite([last["train_loss"], last["flow_loss"], last["reconstruct_loss"]]).all()
    second = cond_app.main(argv)
    assert "[train] resumed from step 8" in capsys.readouterr().out
    assert second.state.step == 16
    name = port_config.tiny_test(conditional=True).name
    assert find_steps(str(tmp_path / "saved_models" / name)) == [8, 16]
    header = (tmp_path / "metrics" / name / "metrics.csv").read_text().splitlines()[0]
    assert {"train_loss", "flow_loss", "reconstruct_loss", "grad_norm"} <= set(header.split(","))
    with pytest.raises(SystemExit):
        cond_app.parse_arguments(["--use-wandb"])
    assert cond_app.parse_arguments([]).device == "cuda"


@pytest.mark.parametrize("method", ["sde", "heun"])
def test_inference_experiments_all_stages_on_the_cpu(tmp_path, method, capsys):
    argv = ["--preset", "tiny", "--device", "cpu", "--n-scenarios", "2", "--n-samples", "3",
            "--batch-size", "2", "--method", method, "--save-dir", str(tmp_path)]
    out = exp_app.main(argv + ["--stage", "all"])
    printed = capsys.readouterr().out
    assert "WARNING: no checkpoint found" in printed and "voxel accuracy" in printed
    assert sorted(out["populate"]) == sorted(out["analyze"]) == ["scenario_0", "scenario_1"]
    frames, substeps = port_config.tiny_test().inference.n_frames, 1
    per_step = {"sde": 1, "heun": 2}[method]
    for folder in ("scenario_0", "scenario_1"):
        path = tmp_path / folder
        true, bores = np.load(path / "true_model.npy"), np.load(path / "boreholes.npy")
        assert true.dtype == bores.dtype == np.int8 and true.shape == SHAPE
        observed = bores != -1
        assert observed.any() and (bores[observed] == true[observed]).all()
        sols = [np.load(path / f"sol_{i}.npy") for i in range(3)]
        assert all(s.dtype == np.int8 and s.shape == SHAPE for s in sols)
        assert min(s.min() for s in sols) >= -1 and max(s.max() for s in sols) <= 13
        assert out["populate"][folder].nfe == (frames - 1) * substeps * per_step
        probs = np.load(path / "probability_tensor.npy")
        assert probs.shape == (*SHAPE, 15) and np.allclose(probs.sum(-1), 1.0)
        for name in ("entropy", "entropy_air_masked", "dike_probability"):
            assert np.load(path / f"{name}.npy").shape == SHAPE
        assert np.load(path / "most_probable.npy").dtype == np.int8
        assert 0.0 <= out["analyze"][folder] <= 1.0
    # the same seeds give the same scenarios and the same ensemble
    before = np.load(tmp_path / "scenario_1" / "sol_2.npy")
    exp_app.main(argv + ["--stage", "create-data"])
    exp_app.main(argv + ["--stage", "populate"])
    np.testing.assert_array_equal(np.load(tmp_path / "scenario_1" / "sol_2.npy"), before)
    # a .ckpt is read now (tests/test_torch_lightning.py); a missing one is an error
    with pytest.raises(FileNotFoundError, match="w.ckpt"):
        exp_app.main(argv + ["--stage", "populate", "--checkpoint-path", "w.ckpt"])


def test_unconditional_app_samples_with_dopri5(tmp_path):
    out = uncond_app.main(["--preset", "tiny", "--mode", "inference", "--adaptive",
                           "--n-samples", "2", "--batch-size", "2", "--infer-device", "cpu",
                           "--no-save-images", "--root-dir", str(tmp_path)])
    result = out["inference"]
    assert result.nfe > 0 and (result.nfe - 1) % 6 == 0
    cfg = port_config.tiny_test()
    assert cfg.inference.atol == cfg.inference.rtol == 1e-6
    assert len(list((tmp_path / "samples" / cfg.name).glob("decoded_s100_*.npy"))) == 2


def test_conditional_callback_decodes_what_jax_does_with_zero_observations(tmp_path):
    cfg = port_config.tiny_test(conditional=True)
    jmodel = jax_build_model(jax_config.ExperimentConfig.from_dict(cfg.to_dict()))
    x = jnp.zeros((1, *SHAPE, E))
    params = random_params(jmodel, x, jnp.zeros((1,)), 2, cfg.model.time_bandwidth,
                           atb=x)["params"]
    model, _, state = init_train_state(cfg, device=CPU)
    weights = params_from_jax(params, model)
    model.load_state_dict(weights)
    with torch.no_grad():
        for name, value in state.ema_params.items():
            value.copy_(weights[name])
    writer = MetricsWriter(str(tmp_path / "metrics"))
    callback = InferenceCallback(cfg, build_model(cfg, device=CPU), str(tmp_path / "images"),
                                 n_samples=2, n_frames=3, writer=writer)
    out = callback.run_inference(state, tag="t")
    writer.close()
    assert out["time_to_solve"] > 0 and out["decoded"].shape == (2, *SHAPE)
    header = (tmp_path / "metrics" / "metrics.csv").read_text().splitlines()[0]
    assert "time_to_solve" in header.split(",")

    x0 = initial_noise(torch.Generator().manual_seed(42), 2, SHAPE, E, torch.float32, CPU)
    sampler = jax_inference.make_sampler(
        jmodel, {"params": params}, jnp.asarray(state.constants["embedding"].numpy()),
        conditional=True, t0=cfg.inference.t0, tf=0.999, n_frames=3,
        substeps=cfg.inference.substeps, method=cfg.inference.method, with_prominence=True)
    ref = sampler(jnp.asarray(x0.numpy()), jnp.zeros(x0.shape))
    np.testing.assert_array_equal(out["decoded"], np.asarray(ref["decoded"]) - 1)
    np.testing.assert_allclose(out["prominence"], np.asarray(ref["prominence"]), atol=1e-5)
