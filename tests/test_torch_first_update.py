"""The flagship recipe's first update, the port against the JAX package.

One micro-step of ``unconditional_64``'s recipe (Adam at 2e-4, clip 1.0) at
the flagship's width, cut to 16³ x b1 and accumulation 1, from the port's
seeded initial weights (``params_to_jax`` hands them to JAX), through each
package's own ``make_train_step``. The port is fed the draws of the JAX step
(``fold_in(key, 0)``, then the JAX ``_draw_common``), and both run in f32
without dropout (the two packages' dropout masks cannot be the same draws),
on the einsum linear attention that each takes on the CPU.

The loss before the update, the gradient norm, every parameter's change and
the loss after the update (``make_eval_loss`` on the same draws) agree; and
the update raises the loss on both sides, so a loss that rises after the
recipe's first update is the recipe's, not the port's.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.models.persistence import (
    params_from_jax,
    params_to_jax,
)
from flowtrain_stochastic_interpolation_torch.train import objectives as port_objectives
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state
from flowtrain_stochastic_interpolation_torch.train.steps import make_eval_loss, make_train_step
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.data.synthetic import synthetic_geology_batch
from flowtrain_stochastic_interpolation_tpu.train import state as jax_state
from flowtrain_stochastic_interpolation_tpu.train import steps as jax_steps
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model
from flowtrain_stochastic_interpolation_tpu.train.objectives import _draw_common as jax_draw_common

SIDE = 16


def _recipe():
    cfg = port_config.unconditional_64()
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, dtype="float32", dropout=0.0),
        data=dataclasses.replace(cfg.data, shape=(SIDE, SIDE, SIDE), batch_size=1),
        training=dataclasses.replace(cfg.training, accumulate_grad_batches=1),
    )


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_flagship_first_update_matches_jax_at_16_cubed():
    cfg = _recipe()
    jcfg = jax_config.ExperimentConfig.from_dict(cfg.to_dict())
    model, tx, state = init_train_state(cfg, device="cpu")
    before = {k: v.detach().clone() for k, v in state.params.items()}
    table = state.constants["embedding"].numpy()

    # JAX: its own train step and eval loss from the same weights
    jmodel = jax_build_model(jcfg)
    jtable = jnp.asarray(table)
    jtx = jax_state.make_optimizer(jcfg.training, updates_per_epoch=tx.transition_steps)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))
    # the train step donates its state: the table it holds is a copy
    jstate = jax_state.init_state(jparams, {"embedding": jnp.array(table)}, jtx, jcfg.ema)
    key = jax.random.PRNGKey(5)
    batch = synthetic_geology_batch(jax.random.PRNGKey(6), 1, cfg.data.shape)
    jstate, jmetrics = jax_steps.make_train_step(jmodel, jtx, jcfg)(jstate, batch, key)
    step_key = jax.random.fold_in(key, 0)
    jafter = jax_steps.make_eval_loss(jmodel, jcfg)(jstate, batch, step_key)

    # the port on the JAX step's draws
    k_data, _ = jax.random.split(step_key)
    _, x1, x0, t = jax_draw_common(k_data, batch, jtable, cfg.training.time_range,
                                   cfg.training.x1_noise)
    draws = tuple(torch.from_numpy(np.array(a)) for a in (x1, x0, t))
    tbatch = torch.from_numpy(np.array(batch))
    with mock.patch.object(port_objectives, "_draw_common", lambda *a: (None, *draws)):
        state, metrics = make_train_step(model, tx, cfg)(state, tbatch, torch.Generator())
        after = make_eval_loss(model, cfg)(state, tbatch, torch.Generator())

    loss_before, jloss_before = float(metrics["train_loss"]), float(jmetrics["train_loss"])
    loss_after, jloss_after = float(after["train_loss"]), float(jafter["train_loss"])
    print(f"loss before {loss_before:.6f} (JAX {jloss_before:.6f}), after the update "
          f"{loss_after:.6f} (JAX {jloss_after:.6f}); grad_norm {float(metrics['grad_norm']):.6f} "
          f"(JAX {float(jmetrics['grad_norm']):.6f})")
    np.testing.assert_allclose(loss_before, jloss_before, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-4)

    jnew = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert set(jnew) == set(before)
    got = np.concatenate([(state.params[k].detach() - before[k]).numpy().ravel() for k in sorted(before)])
    want = np.concatenate([(jnew[k] - before[k]).numpy().ravel() for k in sorted(before)])
    lr = cfg.training.learning_rate
    flipped = float(np.mean(np.abs(got - want) > lr))
    print(f"update: cosine {_cosine(got, want):.6f}, {flipped:.2e} of the values differ by more "
          f"than the learning rate, mean |change| {np.abs(got).mean():.3e} (JAX "
          f"{np.abs(want).mean():.3e})")
    assert _cosine(got, want) > 0.999
    np.testing.assert_allclose(loss_after, jloss_after, rtol=1e-4)
    assert loss_after > loss_before and jloss_after > jloss_before
