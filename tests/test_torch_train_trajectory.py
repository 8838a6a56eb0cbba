"""Training over many updates, the port against the JAX package.

``tests/test_torch_first_update.py`` holds one update; this file holds a run
of them. From the port's seeded initial weights (``params_to_jax`` hands them
to JAX) each package runs its own ``make_train_step``, step after step, each
step on a fresh batch and key. The JAX step draws from ``fold_in(key,
state.step)`` (JAX ``train/steps.py``), so the port is fed, at every step,
JAX's draws from that key: ``_draw_common(split(fold_in(key, state.step))[0],
...)``, and for the conditional loss also ``make_combined_mask`` from the
key's first third. Both run in f32 without dropout (the two packages' dropout
masks cannot be the same draws), on the einsum linear attention that each
takes on the CPU.

Cases: (a) the flagship recipe (``unconditional_64``) at full width, 16³ b1,
accumulation 1, 12 updates (30 in the ``slow`` case); (b) the same recipe at
``tiny_test`` widths with accumulation 2 and ``tiny_test``'s EMA (decay
0.99), 6 micro-steps; (c) the conditional recipe (``conditional_64`` widths,
``conditional_loss`` with its masks, AdamW and EMA), 16³ b1, accumulation 1,
6 updates. At every step the loss agrees within ``LOSS_REL_TOL`` and the
gradient norm within ``GRAD_NORM_REL_TOL``; after the last, every parameter
(and the EMA shadow) within ``PARAM_ABS_TOL``.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.models.persistence import (
    params_from_jax,
    params_to_jax,
)
from flowtrain_stochastic_interpolation_torch.train import objectives as port_objectives
from flowtrain_stochastic_interpolation_torch.train import state as port_state
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state
from flowtrain_stochastic_interpolation_torch.train.steps import make_train_step
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.data.synthetic import synthetic_geology_batch
from flowtrain_stochastic_interpolation_tpu.ops.masks import make_combined_mask as jax_mask
from flowtrain_stochastic_interpolation_tpu.train import state as jax_state
from flowtrain_stochastic_interpolation_tpu.train import steps as jax_steps
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model
from flowtrain_stochastic_interpolation_tpu.train.objectives import _draw_common as jax_draw_common

SIDE = 16
LOSS_REL_TOL = 1e-3
GRAD_NORM_REL_TOL = 2e-3
PARAM_ABS_TOL = 1e-3
# the conditional demo's learning rate (the JAX demo's, at b2 x 4): the recipe's 1e-3
# is set for an effective batch of 32, and at b1 x 1 it takes the loss from 6 to
# 16,000 in four updates, where the JAX package parts from itself (weights 1 ulp
# apart) by 1.1e-3 in the loss at the sixth
CONDITIONAL_LR = 2.5e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cut(cfg, accumulation: int = 1, model=None, ema=None):
    """``cfg`` at 16³ b1 and ``accumulation``, f32 and no dropout."""
    model = cfg.model if model is None else model
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(model, dtype="float32", dropout=0.0),
        data=dataclasses.replace(cfg.data, shape=(SIDE, SIDE, SIDE), batch_size=1),
        training=dataclasses.replace(cfg.training, accumulate_grad_batches=accumulation),
        ema=cfg.ema if ema is None else ema,
    )


def flagship():
    return _cut(port_config.unconditional_64())


def flagship_tiny_accumulated():
    tiny = port_config.tiny_test()
    return _cut(port_config.unconditional_64(), accumulation=2, model=tiny.model, ema=tiny.ema)


def conditional():
    cfg = _cut(port_config.conditional_64())
    return dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, learning_rate=CONDITIONAL_LR))


# compiled once per shape, as inside the JAX step (eager, each op is a small compile)
_jax_mask = jax.jit(jax_mask)
_jax_draw_common = jax.jit(jax_draw_common, static_argnums=(3, 4))


def _jax_draws(step_key, batch, table, cfg):
    """What the JAX loss draws from the step's key: the port's patched
    ``_draw_common`` result and the conditional mask (None without one)."""
    tc = cfg.training
    if cfg.model.conditional:
        k_mask, k_data, _ = jax.random.split(step_key, 3)
        mask = torch.from_numpy(np.array(_jax_mask(k_mask, batch)))
    else:
        k_data, _ = jax.random.split(step_key)
        mask = None
    drawn = _jax_draw_common(k_data, batch, table, tuple(tc.time_range), tc.x1_noise)
    return tuple(torch.from_numpy(np.array(a)) for a in drawn), mask


def _flat(params: dict, names) -> np.ndarray:
    return np.concatenate([np.asarray(params[k], dtype=np.float64).ravel() for k in names])


def run_trajectory(cfg, steps: int, seed: int = 0):
    """Both packages' losses and gradient norms at every step, and their final
    params and EMA shadows (port names, numpy)."""
    model, tx, state = init_train_state(cfg, device="cpu")
    start = {k: v.detach().numpy().copy() for k, v in state.params.items()}
    table = state.constants["embedding"].numpy()
    jcfg = jax_config.ExperimentConfig.from_dict(cfg.to_dict())
    jtx = jax_state.make_optimizer(jcfg.training, updates_per_epoch=tx.transition_steps)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))
    # the train step donates its state: the table it holds is a copy
    jstate = jax_state.init_state(jparams, {"embedding": jnp.array(table)}, jtx, jcfg.ema)
    jstep = jax_steps.make_train_step(jax_build_model(jcfg), jtx, jcfg)
    step_fn = make_train_step(model, tx, cfg)
    jtable = jnp.asarray(table)

    port, ref = {"loss": [], "grad_norm": []}, {"loss": [], "grad_norm": []}
    for i in range(steps):
        batch = synthetic_geology_batch(jax.random.PRNGKey(1000 * seed + 2 * i), 1,
                                        cfg.data.shape)
        key = jax.random.PRNGKey(1000 * seed + 2 * i + 1)
        # the JAX step's key: fold_in(key, state.step), not fold_in(key, 0)
        drawn, mask = _jax_draws(jax.random.fold_in(key, int(jstate.step)), batch, jtable, cfg)
        jstate, jmetrics = jstep(jstate, batch, key)
        with mock.patch.object(port_objectives, "_draw_common", lambda *a: drawn), \
                mock.patch.object(port_objectives, "make_combined_mask", lambda *a: mask):
            state, metrics = step_fn(state, torch.from_numpy(np.array(batch)), torch.Generator())
        for out, m in ((port, metrics), (ref, jmetrics)):
            out["loss"].append(float(m["train_loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
    assert state.step == int(jstate.step) == steps

    names = sorted(state.params)
    port["params"] = _flat({k: v.detach().numpy() for k, v in state.params.items()}, names)
    ref["params"] = _flat(params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)),
                          names)
    port["start"] = _flat(start, names)
    if state.ema_params is not None:
        port["ema"] = _flat({k: v.numpy() for k, v in state.ema_params.items()}, names)
        ref["ema"] = _flat(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                  jstate.ema_params)), names)
    return port, ref, state


def check_trajectory(port, ref, label: str) -> None:
    loss_rel = np.abs(np.subtract(port["loss"], ref["loss"])) / np.abs(ref["loss"])
    norm_rel = (np.abs(np.subtract(port["grad_norm"], ref["grad_norm"]))
                / np.abs(ref["grad_norm"]))
    moved = np.abs(ref["params"] - port["start"]).max()
    param_diff = np.abs(port["params"] - ref["params"]).max()
    print(f"{label}: losses {np.round(port['loss'], 5).tolist()} (JAX "
          f"{np.round(ref['loss'], 5).tolist()}); worst relative loss {loss_rel.max():.2e}, "
          f"grad norm {norm_rel.max():.2e}; params moved up to {moved:.3e}, apart up to "
          f"{param_diff:.3e}")
    np.testing.assert_array_less(loss_rel, LOSS_REL_TOL)
    np.testing.assert_array_less(norm_rel, GRAD_NORM_REL_TOL)
    assert param_diff <= PARAM_ABS_TOL
    assert moved > 10 * param_diff  # the updates moved the weights far more than that
    if "ema" in ref:
        ema_diff = np.abs(port["ema"] - ref["ema"]).max()
        print(f"{label}: EMA shadow moved up to {np.abs(ref['ema'] - port['start']).max():.3e}, "
              f"apart up to {ema_diff:.3e}")
        assert ema_diff <= PARAM_ABS_TOL


def test_flagship_trajectory_matches_jax_over_12_updates():
    port, ref, state = run_trajectory(flagship(), steps=12)
    assert state.opt_state.updates == 12
    check_trajectory(port, ref, "flagship, 12 updates")


@pytest.mark.slow
def test_flagship_trajectory_matches_jax_over_30_updates():
    port, ref, state = run_trajectory(flagship(), steps=30)
    assert state.opt_state.updates == 30
    check_trajectory(port, ref, "flagship, 30 updates")


def test_accumulated_trajectory_with_ema_matches_jax():
    cfg = flagship_tiny_accumulated()
    port, ref, state = run_trajectory(cfg, steps=6)
    assert state.opt_state.updates == 3 and state.ema_params is not None
    check_trajectory(port, ref, "tiny widths, accumulation 2, EMA")


def test_conditional_trajectory_matches_jax():
    port, ref, state = run_trajectory(conditional(), steps=6)
    assert state.opt_state.updates == 6 and state.ema_params is not None
    check_trajectory(port, ref, "conditional, 6 updates")


def test_ema_shadow_at_rest_does_not_drift_as_jax():
    """A shadow equal to its weights stays put over many updates, as under the
    JAX step's compiled update; rounding ``d·s`` first moved the conditional
    recipe's LearnedFourier frequencies (about ±2400) by an ulp a step."""
    weights = (np.random.default_rng(0).standard_normal(4096) * 1000).astype(np.float32)
    port_ema = port_config.EMAConfig(enabled=True, decay=0.9995)
    update = jax.jit(lambda step, s, p: jax_state.ema_update(
        jax_config.EMAConfig(enabled=True, decay=0.9995), step, s, p))
    ours, theirs = {"w": torch.from_numpy(weights.copy())}, {"w": jnp.asarray(weights)}
    for step in range(200):
        ours = port_state.ema_update(port_ema, step, ours, {"w": torch.from_numpy(weights)})
        theirs = update(jnp.asarray(step), theirs, {"w": jnp.asarray(weights)})
    np.testing.assert_array_equal(np.asarray(theirs["w"]), weights)
    np.testing.assert_array_equal(ours["w"].numpy(), weights)
