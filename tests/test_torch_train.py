"""The port's training slice against the JAX package's.

* ``LinearInterpolant`` against golden values and the JAX ``flow_objective``;
* ``unconditional_loss`` and the gradient of every parameter against
  ``jax.value_and_grad`` of the JAX loss, on the same weights
  (``params_from_jax``) and the same draws (the JAX ``_draw_common``): the tiny
  preset in f32 without dropout, at 8³ (einsum attention everywhere) and at
  12³ with full attention at stage 0 (1,728 tokens, so both sides take their
  flash path, the JAX one in interpret mode). Both compute f32 math in another
  order: the loss within 1e-5 relative, each gradient within 1e-4 in
  relative L2;
* the optimiser against the optax chain (clip → Adam/AdamW → staircase LR,
  ``MultiSteps`` accumulation) fed the same gradients: params within 1e-6;
* ``ema_update`` against the JAX one; dropout; the synthetic data; and two
  tiny micro-steps of the train step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_unet import random_params

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.data.synthetic import (
    synthetic_geology_batch,
    synthetic_geology_stages,
)
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant, bcast_time
from flowtrain_stochastic_interpolation_torch.models.layers import ResnetBlock
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.train import state as port_state
from flowtrain_stochastic_interpolation_torch.train.loop import build_model, init_train_state
from flowtrain_stochastic_interpolation_torch.train.objectives import unconditional_loss
from flowtrain_stochastic_interpolation_torch.train.steps import make_eval_loss, make_train_step
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.interpolants import (
    LinearInterpolant as JaxLinearInterpolant,
)
from flowtrain_stochastic_interpolation_tpu.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_tpu.train import state as jax_state
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model
from flowtrain_stochastic_interpolation_tpu.train.objectives import (
    _draw_common as jax_draw_common,
    unconditional_loss as jax_unconditional_loss,
)


def _tiny(side=8, **model):
    cfg = port_config.tiny_test()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model),
        data=dataclasses.replace(cfg.data, shape=(side, side, side)),
    )


def _jax_twin(cfg):
    return jax_config.ExperimentConfig.from_dict(cfg.to_dict())


# ---------------------------------------------------------------------------
# Interpolant
# ---------------------------------------------------------------------------
def test_linear_interpolant_golden_values():
    t = torch.tensor([0.25])
    two = LinearInterpolant()
    one = LinearInterpolant(one_sided=True)
    for it in (two, one):
        torch.testing.assert_close(it.alpha(t), torch.tensor([0.75]))
        torch.testing.assert_close(it.beta(t), torch.tensor([0.25]))
        torch.testing.assert_close(it.alpha_dot(t), torch.tensor([-1.0]))
        torch.testing.assert_close(it.beta_dot(t), torch.tensor([1.0]))
    torch.testing.assert_close(two.gamma(t), torch.tensor([np.sqrt(2.0 * 0.25 * 0.75)],
                                                          dtype=torch.float32))
    torch.testing.assert_close(two.gamma_dot(t), torch.tensor(
        [0.5 * 2.0 * 0.5 / np.sqrt(2.0 * 0.25 * 0.75)], dtype=torch.float32))
    assert torch.count_nonzero(one.gamma(t)) == 0 and torch.count_nonzero(one.gamma_dot(t)) == 0
    with pytest.raises(ValueError, match="Z must be provided"):
        two.get_xt(t, torch.zeros(1, 2), torch.zeros(1, 2))


@pytest.mark.parametrize("one_sided", [True, False])
def test_objectives_match_jax(one_sided):
    rng = np.random.default_rng(0)
    t = rng.uniform(0.05, 0.95, 3).astype(np.float32)
    x0, x1, z = (rng.standard_normal((3, 4, 4, 4, 5)).astype(np.float32) for _ in range(3))
    ours = LinearInterpolant(one_sided=one_sided)
    theirs = JaxLinearInterpolant(one_sided=one_sided)
    tt, tx0, tx1, tz = map(torch.from_numpy, (t, x0, x1, z))
    jt, jx0, jx1, jz = map(jnp.asarray, (t, x0, x1, z))
    zz = (None, None) if one_sided else (tz, jz)
    pairs = [
        (ours.flow_objective(tt, tx0, tx1, zz[0]), theirs.flow_objective(jt, jx0, jx1, zz[1])),
        (ours.denoising_objective(tt, tx0, tx1, zz[0]),
         theirs.denoising_objective(jt, jx0, jx1, zz[1])),
        ((ours.get_vt(tt, tx0, tx1),), (theirs.get_vt(jt, jx0, jx1),)),
        ((ours.get_st(tt, tz),), (theirs.get_st(jt, jz),)),
        ((ours.get_bt_from_score(tt, tx0, tx1),), (theirs.get_bt_from_score(jt, jx0, jx1),)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert bcast_time(torch.tensor([1.0, 2.0]), torch.zeros(2, 3, 3)).shape == (2, 1, 1)


# ---------------------------------------------------------------------------
# unconditional_loss and its gradients against JAX
# ---------------------------------------------------------------------------
CASES = {
    "8cubed_default_attention": dict(side=8),
    "12cubed_full_attention_flash": dict(side=12, full_attn=(True, True), attn_dim_head=8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_unconditional_loss_and_gradients_match_jax(case):
    options = dict(CASES[case])
    side = options.pop("side")
    cfg = _tiny(side, **options)
    tc = cfg.training
    jmodel = jax_build_model(_jax_twin(cfg))
    e = cfg.data.embedding_dim
    params = random_params(jmodel, jnp.zeros((1, side, side, side, e)), jnp.zeros((1,)), 3,
                           cfg.model.time_bandwidth)["params"]
    table = jnp.asarray(simplex_embedding(cfg.data.num_categories, e))
    batch = np.random.default_rng(4).integers(-1, 14, (2, side, side, side)).astype(np.int32)
    key = jax.random.PRNGKey(5)

    def apply_fn(p, x, t, deterministic=True, rngs=None):
        return jmodel.apply({"params": p}, x, t, deterministic=deterministic, rngs=rngs)

    def loss(p):
        return jax_unconditional_loss(apply_fn, p, {"embedding": table}, jnp.asarray(batch), key,
                                      interpolant=JaxLinearInterpolant(one_sided=True),
                                      time_range=tc.time_range, x1_noise=tc.x1_noise,
                                      train=False)[0]

    with pltpu.force_tpu_interpret_mode():
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(params)
    k_data, _ = jax.random.split(key)
    _, x1, x0, t = jax_draw_common(k_data, jnp.asarray(batch), table, tc.time_range, tc.x1_noise)

    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, model))
    model.eval()
    draws = tuple(torch.from_numpy(np.array(a)) for a in (x1, x0, t))
    got_loss, metrics = unconditional_loss(
        model, torch.from_numpy(batch), torch.from_numpy(np.array(table)), None,
        interpolant=LinearInterpolant(one_sided=True), time_range=tc.time_range,
        x1_noise=tc.x1_noise, draws=draws)
    got_loss.backward()
    assert metrics["train_loss"] is got_loss
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)

    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        p = got[name]
        err = (torch.linalg.vector_norm(p.grad - g) / torch.linalg.vector_norm(g)).item()
        assert err <= 1e-4, (name, err)


# ---------------------------------------------------------------------------
# The optimiser against optax
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_optimizer_matches_optax_chain(optimizer):
    k = 2
    tc = dataclasses.replace(port_config.tiny_test().training, learning_rate=0.05,
                             lr_decay=0.5, gradient_clip_val=1.0, accumulate_grad_batches=k,
                             optimizer=optimizer, weight_decay=0.1)
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (4,)}
    params0 = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    # three inner updates: one mean gradient above the clip, two below it
    scales = [3.0, 3.0, 0.05, 0.05, 0.1, 0.02]
    grads = [{n: (sc * rng.standard_normal(s)).astype(np.float32) for n, s in shapes.items()}
             for sc in scales]

    tx = jax_state.make_optimizer(_jax_twin(dataclasses.replace(
        port_config.tiny_test(), training=tc)).training, updates_per_epoch=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params0)
    jopt = tx.init(jparams)
    ours = port_state.make_optimizer(tc, updates_per_epoch=2)  # staircase steps after update 2
    tparams = [torch.from_numpy(params0[n].copy()) for n in shapes]
    topt = ours.init(tparams)
    pre_clip = []
    for i, g in enumerate(grads):
        updates, jopt = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = ours.update([torch.from_numpy(g[n]) for n in shapes], topt, tparams)
        assert applied == (i % k == k - 1)
        for n, t in zip(shapes, tparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[n]), rtol=1e-6, atol=1e-6)
        if i % k == k - 1:
            mean = [(grads[i - 1][n] + g[n]) / 2 for n in shapes]
            pre_clip.append(np.sqrt(sum((m.astype(np.float64) ** 2).sum() for m in mean)))
    assert pre_clip[0] > 1.0 > max(pre_clip[1:])
    assert topt.updates == 3
    assert ours.lr(0) == ours.lr(1) == 0.05 and ours.lr(2) == 0.025


@pytest.mark.parametrize("start,every", [(0, 1), (2, 1), (0, 2), (3, 2)])
def test_ema_update_matches_jax(start, every):
    ema = port_config.EMAConfig(enabled=True, decay=0.9, start_step=start, update_every=every)
    jema = jax_config.EMAConfig(enabled=True, decay=0.9, start_step=start, update_every=every)
    rng = np.random.default_rng(1)
    shadow = rng.standard_normal(5).astype(np.float32)
    ours = {"p": torch.from_numpy(shadow.copy())}
    theirs = {"p": jnp.asarray(shadow)}
    for step in range(6):
        p = rng.standard_normal(5).astype(np.float32)
        ours = port_state.ema_update(ema, step, ours, {"p": torch.from_numpy(p)})
        theirs = jax_state.ema_update(jema, jnp.asarray(step), theirs, {"p": jnp.asarray(p)})
        np.testing.assert_allclose(ours["p"].numpy(), np.asarray(theirs["p"]), rtol=1e-6, atol=1e-7)
    off = dataclasses.replace(ema, enabled=False)
    assert port_state.ema_update(off, 0, ours, ours) is None


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------
def _seeded(module, seed=0):
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return module


def test_dropout_masks_block1_only_in_training():
    p = 0.3
    block = _seeded(ResnetBlock(6, 6, 16, dropout=p))
    x = torch.randn(2, 8, 8, 8, 6, generator=torch.Generator().manual_seed(1))
    t = torch.randn(2, 16, generator=torch.Generator().manual_seed(2))
    seen = {}
    hooks = [getattr(block, n).register_forward_hook(
        lambda mod, args, out, n=n: seen.__setitem__((n, mod.training), (args[0], out)))
        for n in ("block1", "block2")]
    block.eval()
    eval_out = block(x, t)
    block.train()
    train_out = block(x, t, torch.Generator().manual_seed(7))
    for h in hooks:
        h.remove()
    kept = seen[("block1", True)][1]
    clean = seen[("block1", False)][1]
    zero = kept == 0
    assert abs(zero.float().mean().item() - p) < 0.03
    torch.testing.assert_close(kept[~zero], clean[~zero] / (1 - p))
    # block2 draws nothing: on the same input it gives the same output
    torch.testing.assert_close(block.block2(seen[("block2", True)][0]), seen[("block2", True)][1])
    assert not torch.equal(train_out, eval_out)
    again = block(x, t, torch.Generator().manual_seed(7))
    torch.testing.assert_close(again, train_out, rtol=0, atol=0)


def test_dropout_is_off_in_eval_and_the_model_matches_one_without_it():
    with_drop = build_model(_tiny(dropout=0.5), device="cpu")
    without = build_model(_tiny(dropout=0.0), device="cpu")
    _seeded(with_drop)
    without.load_state_dict(with_drop.state_dict())
    x = torch.randn(2, 8, 8, 8, 15, generator=torch.Generator().manual_seed(3))
    t = torch.tensor([0.2, 0.7])
    with_drop.eval()
    without.eval()
    torch.testing.assert_close(with_drop(x, t), without(x, t), rtol=0, atol=0)
    with_drop.train()
    a = with_drop(x, t, torch.Generator().manual_seed(4))
    b = with_drop(x, t, torch.Generator().manual_seed(4))
    c = with_drop(x, t, torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_remat_blocks_is_not_ported():
    """remat_blocks is ported now: with dropout on and gradients on, its forward
    is the plain model's on the same generator (its gradients:
    tests/test_torch_memory_forms.py)."""
    remat = build_model(_tiny(remat_blocks=True, dropout=0.5), device="cpu")
    plain = build_model(_tiny(dropout=0.5), device="cpu")
    _seeded(plain)
    remat.load_state_dict(plain.state_dict())
    remat.train()
    plain.train()
    x = torch.randn(2, 8, 8, 8, 15, generator=torch.Generator().manual_seed(3))
    t = torch.tensor([0.2, 0.7])
    torch.testing.assert_close(remat(x, t, torch.Generator().manual_seed(4)),
                               plain(x, t, torch.Generator().manual_seed(4)), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Synthetic data
# ---------------------------------------------------------------------------
def test_synthetic_geology_batch_conventions():
    shape = (16, 16, 24)
    batch = synthetic_geology_batch(torch.Generator().manual_seed(0), 3, shape)
    assert batch.shape == (3, *shape) and batch.dtype == torch.int32
    assert batch.min() == -1 and batch.max() <= 13 and batch.min() >= -1
    air = batch == -1
    # air only above the surface: once a column is air it stays air going up in z
    assert torch.equal(torch.cummax(air.int(), dim=-1).values.bool(), air)
    assert air[..., 0].sum() == 0 and air[..., -1].all()
    assert not torch.equal(batch[0], batch[1]) and not torch.equal(batch[1], batch[2])
    again = synthetic_geology_batch(torch.Generator().manual_seed(0), 3, shape)
    assert torch.equal(batch, again)
    stages = synthetic_geology_stages(torch.Generator().manual_seed(1), shape)
    assert list(stages) == ["strata", "tilt", "fold", "dike", "topography"]
    assert (stages["strata"] >= 0).all() and (stages["topography"] == -1).any()


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
def test_train_step_updates_params_only_at_the_accumulation_boundary():
    cfg = _tiny()
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training,
                                                                accumulate_grad_batches=2))
    model, tx, state = init_train_state(cfg, device="cpu")
    step = make_train_step(model, tx, cfg)
    gen = torch.Generator().manual_seed(0)
    batch = synthetic_geology_batch(gen, 2, cfg.data.shape)
    shadow0 = {k: v.clone() for k, v in state.ema_params.items()}
    changed = []
    for _ in range(4):
        before = {k: v.detach().clone() for k, v in state.params.items()}
        state, metrics = step(state, batch, gen)
        assert set(metrics) == {"train_loss", "grad_norm"}
        assert all(torch.isfinite(v) for v in metrics.values())
        changed.append(any(not torch.equal(before[k], v) for k, v in state.params.items()))
    assert changed == [False, True, False, True]
    assert state.step == 4 and tx.lr(state.opt_state.updates) == cfg.training.learning_rate
    assert any(not torch.equal(shadow0[k], v) for k, v in state.ema_params.items())
    assert all(p.grad is None for p in model.parameters())
    metrics = make_eval_loss(model, cfg)(state, batch, gen)
    assert torch.isfinite(metrics["train_loss"]) and model.training


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(_tiny())
