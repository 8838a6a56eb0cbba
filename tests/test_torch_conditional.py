"""The port's conditional application against the JAX package's.

At ``tiny_test(conditional=True)`` (v3, 8³, f32, no dropout), on the same
numpy-drawn weights (``params_from_jax``):

* ``build_atb`` against the JAX one;
* ``conditional_loss`` and its three metrics against the JAX loss, on JAX's
  own mask, X1 noise, X0 and t (the port takes them as ``draws``);
* one conditional ``make_train_step`` micro-step, and ``make_eval_loss``;
* ``sample_conditional`` (Euler, 3 frames) against the JAX conditional
  ``make_sampler`` from the same x0 and ATb: the final states within 1e-4 and
  the decoded maps equal; batch b's noise is seeded with ``seed + b``;
* the ensemble functions on the JAX package's saved ensemble of scenario 0
  (``artifacts/cond_experiments_trained``): the probabilities (against the JAX
  function), the dike probability and the most probable model exactly, the
  entropies within 1e-4.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import random_params

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.data.synthetic import synthetic_geology_batch
from flowtrain_stochastic_interpolation_torch.inference import (
    build_atb,
    initial_noise,
    sample_conditional,
)
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.models.unet_cond import UNet3DCond
from flowtrain_stochastic_interpolation_torch.ops import ensemble
from flowtrain_stochastic_interpolation_torch.ops.masks import make_combined_mask
from flowtrain_stochastic_interpolation_torch.train.loop import build_model, init_train_state
from flowtrain_stochastic_interpolation_torch.train.objectives import conditional_loss
from flowtrain_stochastic_interpolation_torch.train.steps import make_eval_loss, make_train_step
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu import inference as jax_inference
from flowtrain_stochastic_interpolation_tpu.interpolants import (
    LinearInterpolant as JaxLinearInterpolant,
)
from flowtrain_stochastic_interpolation_tpu.ops import ensemble as jax_ensemble
from flowtrain_stochastic_interpolation_tpu.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_tpu.ops.masks import make_combined_mask as jax_mask
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model
from flowtrain_stochastic_interpolation_tpu.train.objectives import _draw_common as jax_draws
from flowtrain_stochastic_interpolation_tpu.train.objectives import (
    conditional_loss as jax_conditional_loss,
)

SCENARIO = Path(__file__).resolve().parents[1] / "artifacts/cond_experiments_trained/scenario_0"
SHAPE, E = (8, 8, 8), 15


def _tiny(**training):
    cfg = port_config.tiny_test(conditional=True)
    return dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, **training))


def _models(cfg, seed=0):
    """The JAX model with numpy-drawn params, and the port's model holding them."""
    jmodel = jax_build_model(jax_config.ExperimentConfig.from_dict(cfg.to_dict()))
    x = jnp.zeros((1, *SHAPE, E))
    params = random_params(jmodel, x, jnp.zeros((1,)), seed, cfg.model.time_bandwidth,
                           atb=x)["params"]
    port = build_model(cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, port))
    return jmodel, params, port


def _table():
    return simplex_embedding(15, E)


def _true_and_mask(seed=0, batch=1):
    true = synthetic_geology_batch(torch.Generator().manual_seed(seed), batch, SHAPE)
    return true, make_combined_mask(torch.Generator().manual_seed(seed + 1), true)


def test_build_atb_matches_jax():
    true, mask = _true_and_mask()
    got = build_atb(true[0], mask[0], torch.from_numpy(_table()))
    want = jax_inference.build_atb(jnp.asarray(true[0].numpy()), jnp.asarray(mask[0].numpy()),
                                   jnp.asarray(_table()))
    assert got.shape == (*SHAPE, E)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got[~mask[0]], torch.zeros_like(got[~mask[0]]))


def test_conditional_loss_and_metrics_match_jax():
    cfg = _tiny()
    tc = cfg.training
    jmodel, params, port = _models(cfg)
    table = jnp.asarray(_table())
    batch = synthetic_geology_batch(torch.Generator().manual_seed(4), 2, SHAPE).numpy()
    key = jax.random.PRNGKey(5)

    def apply_fn(p, *args, deterministic=True, rngs=None):
        return jmodel.apply({"params": p}, *args, deterministic=deterministic, rngs=rngs)

    loss = jax.jit(lambda p: jax_conditional_loss(
        apply_fn, p, {"embedding": table}, jnp.asarray(batch), key,
        interpolant=JaxLinearInterpolant(one_sided=True), time_range=tc.time_range,
        x1_noise=tc.x1_noise, lambda_reconstruct=tc.lambda_reconstruct, train=False))
    want_loss, want = loss(params)
    k_mask, k_data, _ = jax.random.split(key, 3)
    mask = jax_mask(k_mask, jnp.asarray(batch))
    _, x1, x0, t = jax_draws(k_data, jnp.asarray(batch), table, tc.time_range, tc.x1_noise)
    draws = tuple(torch.from_numpy(np.array(a)) for a in (mask, x1, x0, t))

    got_loss, got = conditional_loss(
        port, torch.from_numpy(batch), torch.from_numpy(_table()), None,
        interpolant=LinearInterpolant(one_sided=True), time_range=tc.time_range,
        x1_noise=tc.x1_noise, lambda_reconstruct=tc.lambda_reconstruct, draws=draws)
    assert set(got) == set(want) == {"train_loss", "flow_loss", "reconstruct_loss"}
    assert got["train_loss"] is got_loss
    assert min(float(v) for v in want.values()) > 0.1  # both parts weigh in
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=0, atol=1e-5)


def test_conditional_train_step_moves_the_params():
    cfg = _tiny()
    model, tx, state = init_train_state(cfg, device="cpu")
    assert isinstance(model, UNet3DCond) and model.variant == "v3"
    step = make_train_step(model, tx, cfg)
    gen = torch.Generator().manual_seed(0)
    batch = synthetic_geology_batch(gen, 2, SHAPE)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state, metrics = step(state, batch, gen)
    assert set(metrics) == {"train_loss", "flow_loss", "reconstruct_loss", "grad_norm"}
    assert all(torch.isfinite(v) for v in metrics.values())
    torch.testing.assert_close(metrics["train_loss"],
                               metrics["flow_loss"] + metrics["reconstruct_loss"])
    moved = [k for k, v in state.params.items() if not torch.equal(before[k], v)]
    assert "init_conv_ATb.weight" in moved and "ups_1_atb_mix.time_mlp.weight" in moved
    assert len(moved) == len(before)
    metrics = make_eval_loss(model, cfg)(state, batch, gen)
    assert set(metrics) == {"train_loss", "flow_loss", "reconstruct_loss"} and model.training


def test_sample_conditional_matches_the_jax_sampler():
    cfg = _tiny()
    jmodel, params, port = _models(cfg, seed=1)
    true, mask = _true_and_mask(seed=2)
    atb = build_atb(true[0], mask[0], torch.from_numpy(_table()))
    kw = dict(t0=cfg.inference.t0, tf=cfg.inference.tf, n_frames=3, substeps=1, method="euler")
    result = sample_conditional(port, torch.from_numpy(_table()), atb, n_samples=3,
                                batch_size=2, seed=9, device="cpu", verbose=False,
                                keep_trajectory=True, **kw)
    assert result.decoded.shape == (3, *SHAPE) and result.nfe == 2
    assert len(result.seconds_per_batch) == 2
    x0 = [initial_noise(torch.Generator().manual_seed(9 + b), bs, SHAPE, E, torch.float32,
                        torch.device("cpu")) for b, bs in ((0, 2), (1, 1))]
    np.testing.assert_array_equal(result.trajectory[0], torch.cat(x0).numpy())

    sampler = jax_inference.make_sampler(jmodel, {"params": params}, jnp.asarray(_table()),
                                         conditional=True, keep_trajectory=True, **kw)
    x0 = torch.cat(x0).numpy()
    ref = sampler(jnp.asarray(x0), jnp.broadcast_to(jnp.asarray(atb.numpy()), x0.shape))
    np.testing.assert_allclose(result.trajectory[-1], np.asarray(ref["trajectory"][-1]),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(result.decoded, np.asarray(ref["decoded"]))


def test_ensemble_matches_the_saved_scenario():
    """The JAX package's ensemble of scenario 0: eight decoded solutions and the
    maps its analysis saved from them. Its 15.7 MB ``probability_tensor.npy``
    stays out of the tree's filtered copy (``.gitignore``); the probabilities
    are held to the JAX function on the same solutions, and their dike channel
    to the saved ``dike_probability.npy``, exactly."""
    solutions = np.stack([np.load(SCENARIO / f"sol_{i}.npy") for i in range(8)])
    saved = lambda name: np.load(SCENARIO / f"{name}.npy")
    probs = ensemble.vote_probabilities(torch.from_numpy(solutions), 15)
    jprobs = jax_ensemble.vote_probabilities(jnp.asarray(solutions), 15)
    assert probs.shape == (64, 64, 64, 15) and probs.dtype == torch.float32
    np.testing.assert_array_equal(probs.numpy(), np.asarray(jprobs))
    np.testing.assert_array_equal(ensemble.category_probability(probs, 13).numpy(),
                                  saved("dike_probability"))
    np.testing.assert_array_equal(ensemble.most_probable_model(probs).numpy(),
                                  saved("most_probable"))
    np.testing.assert_allclose(ensemble.entropy(probs).numpy(), saved("entropy"),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ensemble.air_masked_entropy(probs).numpy(),
                               saved("entropy_air_masked"), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ensemble.entropy(probs).numpy(),
                               np.asarray(jax_ensemble.entropy(jprobs)), rtol=0, atol=1e-6)
    assert (ensemble.air_masked_entropy(probs) == 0).any() and (probs[..., 14] > 0).any()


def test_conditional_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(_tiny())
    model = build_model(_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_conditional(model, torch.eye(E), torch.zeros(*SHAPE, E), n_samples=1,
                           batch_size=1, verbose=False)
