"""Data-parallel and spatially sharded training of the port on 8 gloo ranks,
against one-process references on the same tensors.

The ranks (``tests/torch_parallel_cases.py::train_cases``, spawned once, one
torch thread each) hold the tiny configuration's seeded weights
(``init_train_state``). Ranks 0 and 1 run the data-parallel micro-step
(``train.steps``: the JAX default step's objective over the *global* batch)
and ``make_shard_map_train_step`` (the mean of the per-rank objectives) on
fed draws, then two data-parallel steps on their own draws; all 8 form a
2 × 4 (data × spatial) mesh for the spatial loss and gradient, unconditional
and conditional, and two conditional spatial train steps.

The references: the one-process step on the whole batch and the same draws;
the mean of the per-half objectives; the unsharded global objective on the
spatial draws rebuilt shard by shard from ``spatial_draws`` (as
``tests/test_shard_map.py`` rebuilds JAX's). Tolerances, f32 rounding: losses
1e-5 relative, gradients 2e-4 of each leaf's largest entry (the JAX spatial
test's rtol); replicas bitwise equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch.config import tiny_test
from flowtrain_stochastic_interpolation_torch.data.synthetic import synthetic_geology_batch
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant
from flowtrain_stochastic_interpolation_torch.ops.embedding import embed
from flowtrain_stochastic_interpolation_torch.ops.masks import make_combined_mask
from flowtrain_stochastic_interpolation_torch.parallel.launch import spawn
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state
from flowtrain_stochastic_interpolation_torch.train.shard_map_step import spatial_draws
from flowtrain_stochastic_interpolation_torch.train.steps import _loss

import torch_parallel_cases as cases

N_DATA, N_SPATIAL = 2, 4
SPATIAL_SHAPE = (16, 8, 8)  # X = 16 over 4 shards: X_loc = 4, the 7³ conv's halo 3
SPATIAL_SEED = 7
REL = 2e-4


def config(conditional, shape=(8, 8, 8), batch=4):
    cfg = tiny_test(conditional=conditional)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, shape=shape,
                                                             batch_size=batch))


def draws_for(cfg, batch, seed):
    """Seeded draws in the objectives' ``draws`` form."""
    g = torch.Generator().manual_seed(seed)
    e = cfg.data.embedding_dim
    x1 = embed(batch, torch.eye(e)) + 1e-3 * torch.randn(batch.shape + (e,), generator=g)
    x0 = torch.randn(x1.shape, generator=g)
    t = torch.rand(batch.shape[0], generator=g)
    if cfg.model.conditional:
        return (make_combined_mask(g, batch), x1, x0, t)
    return (x1, x0, t)


@pytest.fixture(scope="module")
def setup():
    uncond, cond = config(False), config(True)
    batch = synthetic_geology_batch(torch.Generator().manual_seed(0), 4, (8, 8, 8))
    draws = {"uncond": draws_for(uncond, batch, 1), "cond": draws_for(cond, batch, 2)}
    spatial = config(False, SPATIAL_SHAPE, N_DATA), config(True, SPATIAL_SHAPE, N_DATA)
    labels = synthetic_geology_batch(torch.Generator().manual_seed(3), N_DATA, SPATIAL_SHAPE)
    mask = make_combined_mask(torch.Generator().manual_seed(4), labels)
    ranks = spawn(cases.train_cases, N_DATA * N_SPATIAL,
                  ((uncond, batch, draws["uncond"]), (cond, batch, draws["cond"]),
                   (*spatial, labels, mask)), threads=1, deadline_s=400)
    return dict(configs={"uncond": uncond, "cond": cond}, batch=batch, draws=draws,
                spatial={"uncond": spatial[0], "cond": spatial[1]}, labels=labels, mask=mask,
                ranks=ranks)


def grads_close(got, model, rel=REL):
    for g, (key, p) in zip(got, model.named_parameters()):
        want = p.grad.numpy()
        np.testing.assert_allclose(g.numpy(), want, atol=rel * np.abs(want).max(), rtol=0,
                                   err_msg=key)


def one_process(cfg, batch, draws, parts=1):
    """``(losses, model)``: the objective of each of ``parts`` blocks of the batch
    (on its block of the draws), their gradients summed into the model's."""
    model, _, state = init_train_state(cfg, device="cpu")
    model.train()
    losses = []
    size = batch.shape[0] // parts
    for i in range(parts):
        block = slice(i * size, (i + 1) * size)
        loss, _ = _loss(cfg)(model, batch[block], state.constants["embedding"],
                             torch.Generator().manual_seed(5),
                             draws=tuple(d[block] for d in draws))
        loss.backward()
        losses.append(float(loss.detach()))
    return losses, model


@pytest.mark.parametrize("name", ["uncond", "cond"])
def test_data_parallel_step_is_the_global_objective(setup, name):
    (loss,), model = one_process(setup["configs"][name], setup["batch"], setup["draws"][name])
    for rank in setup["ranks"][:2]:
        got = rank[f"dp_{name}"]
        assert float(got["metrics"]["train_loss"]) == pytest.approx(loss, rel=1e-5)
        grads_close(got["grads"], model)
    # both ranks hold the same summed gradients
    a, b = (r[f"dp_{name}"]["grads"] for r in setup["ranks"][:2])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_shard_map_step_is_the_mean_of_per_rank_objectives(setup):
    cfg = setup["configs"]["uncond"]
    losses, model = one_process(cfg, setup["batch"], setup["draws"]["uncond"], parts=N_DATA)
    for p in model.parameters():
        p.grad /= N_DATA
    norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()]))
    for rank in setup["ranks"][:2]:
        got = rank["shard_map"]
        assert float(got["metrics"]["train_loss"]) == pytest.approx(np.mean(losses), rel=1e-5)
        assert float(got["metrics"]["grad_norm"]) == pytest.approx(float(norm), rel=1e-5)
        grads_close(got["grads"], model)


def global_spatial_loss(cfg, labels, mask):
    """The unsharded objective on the spatial draws rebuilt shard by shard, and
    the model holding its gradient."""
    model, _, state = init_train_state(cfg, device="cpu")
    model.train()
    table, tc = state.constants["embedding"], cfg.training
    x_loc, b_loc = labels.shape[1] // N_SPATIAL, labels.shape[0] // N_DATA
    rows, ts = [], []
    for di in range(N_DATA):
        cols = [spatial_draws(SPATIAL_SEED, labels[di * b_loc:(di + 1) * b_loc,
                                                   si * x_loc:(si + 1) * x_loc],
                              table, tc.time_range, tc.x1_noise, di, si)
                for si in range(N_SPATIAL)]
        rows.append([torch.cat([c[i] for c in cols], dim=1) for i in range(3)])
        ts.append(cols[0][3])
    x1_clean, x1, x0 = (torch.cat([r[i] for r in rows], dim=0) for i in range(3))
    t = torch.cat(ts)
    xt, vt = LinearInterpolant(one_sided=True).flow_objective(t, x0, x1)
    if not cfg.model.conditional:
        loss = (model(xt, t) - vt).square().sum() / vt.square().sum()
    else:
        v_hat = model(xt, x1_clean * mask[..., None], t)
        n = x1.numel()
        flow = ((v_hat - vt).square().sum() / n) / (vt.square().sum() / n + 1e-6)
        b_hat = xt + (1.0 - t.reshape(-1, 1, 1, 1, 1)) * v_hat
        mask_f = mask[..., None].float()
        masked = ((b_hat - x1_clean).square() * mask_f).sum() / (
            mask_f.sum().clamp_min(1.0) * x1.shape[-1])
        loss = flow + tc.lambda_reconstruct * t.mean() * masked / (x1.square().mean() + 1e-6)
    loss.backward()
    return float(loss.detach()), model


@pytest.mark.parametrize("name", ["uncond", "cond"])
def test_spatial_loss_and_gradient_are_the_global_objective(setup, name):
    loss, model = global_spatial_loss(setup["spatial"][name], setup["labels"], setup["mask"])
    for rank in setup["ranks"]:
        got = rank[f"spatial_{name}"]
        assert float(got["loss"]) == pytest.approx(loss, rel=1e-5)
        grads_close(got["grads"], model)


def test_replicas_stay_bitwise_equal(setup):
    ranks = setup["ranks"]
    for key, members in (("dp_replica", ranks[:2]), ("spatial_replica", ranks)):
        first = members[0][key]
        for rank in members[1:]:
            for part in ("params", "ema"):
                assert all(torch.equal(rank[key][part][k], first[part][k]) for k in first[part])
    # and the steps moved the weights
    _, _, state = init_train_state(setup["configs"]["uncond"], device="cpu")
    assert any(not torch.equal(ranks[0]["dp_replica"]["params"][k], v.detach())
               for k, v in state.params.items())
    assert np.isfinite(float(ranks[0]["spatial_replica"]["loss"]))
