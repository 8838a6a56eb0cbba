"""The 128³ memory forms of the port against the JAX package and the plain step (CPU).

* The chunked folded backward against JAX's
  ``_folded_vjp_bwd_closed_form_chunked`` and the port's one-shot f32 closed
  form, called directly with a small ``target_rows`` so that several row
  blocks run on a few thousand rows; ``"autodiff"`` against ``closed_form``
  and JAX's autodiff; the dispatch at 2^20 rows.
* On the tiny preset with dropout on (p = 0.5), the gradients of one loss
  under ``remat_blocks``, under ``remat`` with ``"dots"`` and ``"nothing"``,
  and (conditional) with ``remat_save_atb``, each equal to the plain step's on
  the same generator: the generator trap, since ``torch.utils.checkpoint``
  restores only the global random state. Also the folded attention's
  ``autograd.Function`` under a selective checkpoint.
* The bf16 objective's loss against JAX's on the same draws.

Tolerances: f32 streams against JAX 1e-6 relative to each output's largest
value (sums in another order); bf16 outputs to one bf16 rounding (2^-8
relative) plus 1e-3 of the largest value, since both round f32 results once;
the rematerialised gradients exactly (the recompute repeats the forward op
for op); the bf16 objective's loss 1e-4 relative with a stand-in model that
both sides compute alike (JAX op by op; the f32 means sum in another order),
and one bf16 rounding (2^-8) with the tiny UNet at ``dtype="float32"``, whose
first convs see the bf16 volumes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant
from flowtrain_stochastic_interpolation_torch.models import remat
from flowtrain_stochastic_interpolation_torch.models.persistence import params_from_jax
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_torch.train import objectives
from flowtrain_stochastic_interpolation_torch.train import steps
from flowtrain_stochastic_interpolation_torch.train.loop import build_model
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.interpolants import (
    LinearInterpolant as JaxLinearInterpolant,
)
from flowtrain_stochastic_interpolation_tpu.ops import linear_attention as jax_la
from flowtrain_stochastic_interpolation_tpu.train import objectives as jax_objectives
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model as jax_build_model

from test_torch_unet import random_params

HEADS, HD = 4, 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _folded_inputs(seed: int, batch: int, n: int):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((batch, n, HD)).astype(np.float32) for _ in range(4))
    mem_k, mem_v = (rng.standard_normal((4, HD)).astype(np.float32) for _ in range(2))
    return (q, 2.0 * k, v, mem_k, mem_v), dout


def _close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    peak = np.abs(want).max()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * peak)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0**-8, atol=1e-3 * peak)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chunked_backward_matches_jax_and_the_one_shot_form(dtype):
    inputs, dout = _folded_inputs(0, 2, 4096)
    tensors = [torch.from_numpy(a).to(dtype) for a in inputs]
    tdout = torch.from_numpy(dout).to(dtype)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jres = tuple(jnp.asarray(t.float().numpy()).astype(jdtype) for t in tensors)
    jdout = jnp.asarray(tdout.float().numpy()).astype(jdtype)
    want = jax_la._folded_vjp_bwd_closed_form_chunked(HEADS, 1024, jres, jdout,
                                                      target_rows=1024)
    got = la.folded_backward_chunked(*tensors, tdout, HEADS, target_rows=1024)
    one_shot = la.folded_backward_closed_form(*tensors, tdout, HEADS)
    for g, w, o, t in zip(got, want, one_shot, tensors):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, np.asarray(w.astype(jnp.float32)), dtype)
        _close(g, o.float().numpy(), dtype)
    # 4096 rows at 1000 per block: halved to 500 (< 512), so the one-shot f32 form
    small = la.folded_backward_chunked(*tensors, tdout, HEADS, target_rows=1000)
    for a, b in zip(small, one_shot):
        assert torch.equal(a, b)


def test_autodiff_backward_matches_closed_form_and_jax():
    inputs, dout = _folded_inputs(1, 2, 300)
    tensors = [torch.from_numpy(a) for a in inputs]
    tdout = torch.from_numpy(dout)
    got = la.folded_backward_autodiff(*tensors, tdout, HEADS)
    closed = la.folded_backward_closed_form(*tensors, tdout, HEADS)
    want = jax_la._folded_vjp_bwd(HEADS, 1024, "autodiff", tuple(map(jnp.asarray, inputs)),
                                  jnp.asarray(dout))
    for g, c, w in zip(got, closed, want):
        _close(g, c.numpy(), torch.float32)
        _close(g, np.asarray(w), torch.float32)
    # through linear_attention_folded (the plain K1 + K2 forward on the CPU)
    leaves = [t.clone().requires_grad_() for t in tensors]
    la.linear_attention_folded(*leaves, heads=HEADS, backward="autodiff").backward(tdout)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


def test_backward_dispatch_takes_the_chunked_form_from_2_to_the_20_rows():
    big = la.CHUNKED_BWD_MIN_ROWS
    for backward in (None, "closed_form_bf16", "closed_form", "chunked"):
        assert la.backward_form(backward, big) == "chunked"
        assert la.backward_form(backward, 2 * big) == "chunked"
    assert la.backward_form(None, big - 1) == "closed_form_bf16"
    assert la.backward_form("closed_form", big - 1) == "closed_form"
    assert la.backward_form("chunked", 300) == "chunked"
    assert la.backward_form("autodiff", 2 * big) == "autodiff"
    assert la.CHUNK_ROWS == 1 << 17


# ---------------------------------------------------------------------------
# Rematerialisation: the gradients of the plain step, dropout included
# ---------------------------------------------------------------------------
def _cfg(conditional=False, **training):
    cfg = port_config.tiny_test(conditional=conditional)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=0.5),
        training=dataclasses.replace(cfg.training, **training))


def _grads(cfg, weights=None, count_blocks=False, gen_seed=2):
    """The loss and the gradients of one micro-step's loss of ``cfg`` on fixed
    batch and generator seeds, in training mode; the model's weights."""
    model = build_model(cfg, device="cpu")
    if weights is None:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(weights)
    calls = []
    if count_blocks:
        # a pre-hook: the recompute may stop inside the block once it has what
        # the backward needs
        model.downs_0_block1.register_forward_pre_hook(lambda *a: calls.append(1))
    model.train()
    e = cfg.data.embedding_dim
    table = torch.from_numpy(simplex_embedding(cfg.data.num_categories, e))
    batch = torch.randint(-1, 14, (2, 8, 8, 8), generator=torch.Generator().manual_seed(1))
    loss, _ = steps._loss(cfg)(steps.rematerialised(model, cfg), batch, table,
                               torch.Generator().manual_seed(gen_seed))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, \
        model.state_dict(), len(calls)


# (model options, training options, the first block's forwards in one step)
FORMS = {
    "remat_blocks": (dict(remat_blocks=True), {}, 2),
    "remat_dots": ({}, dict(remat=True, remat_policy="dots"), 2),
    "remat_nothing": ({}, dict(remat=True, remat_policy="nothing"), 2),
    # nested: the whole forward's recompute, then the block's own
    "remat_nothing_blocks": (dict(remat_blocks=True), dict(remat=True, remat_policy="nothing"),
                             3),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_remat_gradients_equal_the_plain_step_with_dropout_on(form):
    model_opts, training, forwards = FORMS[form]
    plain = _cfg()
    loss0, grads0, weights, calls0 = _grads(plain, count_blocks=True)
    cfg = _cfg(**training)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model_opts))
    loss, grads, _, calls = _grads(cfg, weights, count_blocks=True)
    assert calls0 == 1 and calls == forwards  # the forward and its recomputes
    assert torch.equal(loss, loss0)
    for name, g in grads0.items():
        assert g is not None and torch.equal(grads[name], g), name
    # the generator decides the masks: another seed gives other gradients
    other = _grads(plain, weights, gen_seed=3)[1]
    assert any(not torch.equal(other[n], g) for n, g in grads0.items())


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_conditional_remat_with_saved_towers_equals_the_plain_step(policy):
    plain = _cfg(conditional=True)
    loss0, grads0, weights, _ = _grads(plain)
    cfg = _cfg(conditional=True, remat=True, remat_policy=policy, remat_save_atb=True)
    loss, grads, _, _ = _grads(cfg, weights)
    assert torch.equal(loss, loss0)
    for name, g in grads0.items():
        assert torch.equal(grads[name], g), name


def test_the_policies_save_what_they_name():
    """A selective checkpoint keeps the Dense products under "dots" and the
    towers' convolutions and resize under save_atb: their ops are not run again
    in the recompute."""
    seen = []

    class Spy(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    lin = torch.nn.Linear(8, 8)
    conv = torch.nn.Conv3d(3, 3, 3, padding=1)
    x = torch.randn(4, 8, requires_grad=True)
    vol = torch.randn(1, 3, 4, 4, 4, requires_grad=True)

    def fn(a, b, _):
        with remat.named_region("atb_tower"):
            tower = conv(torch.nn.functional.interpolate(b, scale_factor=2.0, mode="trilinear",
                                                         align_corners=True))
        return (lin(a).tanh().sum() + tower.tanh().sum())

    for policy, save_atb, rerun in (("nothing", False, {"addmm", "convolution"}),
                                    ("dots", False, {"convolution"}),
                                    ("dots", True, set())):
        out = remat.checkpoint(fn, x, vol, remat_policy=policy, save_atb=save_atb)
        seen.clear()
        with Spy():
            out.backward()
        names = {f.overloadpacket.__name__ for f in seen}
        assert {"addmm", "convolution"} & names == rerun, (policy, save_atb, names)
    with pytest.raises(ValueError, match="remat_policy"):
        remat.checkpoint(fn, x, vol, remat_policy="everything")


def test_folded_attention_under_a_selective_checkpoint():
    inputs, dout = _folded_inputs(2, 1, 600)
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    la.linear_attention_folded(*leaves, heads=HEADS).backward(torch.from_numpy(dout))
    want = [t.grad for t in leaves]
    again = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = remat.checkpoint(lambda *a: la.linear_attention_folded(*a[:5], heads=HEADS), *again,
                           remat_policy="dots")
    out.backward(torch.from_numpy(dout))
    for t, w in zip(again, want):
        assert torch.equal(t.grad, w)


# ---------------------------------------------------------------------------
# The bf16 objective
# ---------------------------------------------------------------------------
def _stand_in(conditional: bool, xp):
    """A model that both sides compute alike (f32 arithmetic on the stored
    volumes), so that the loss compares the objectives alone."""
    def velocity(xt, *rest):
        t = rest[-1].reshape(-1, 1, 1, 1, 1)
        out = xt.astype(xp.float32) * (0.5 + t) if xp is jnp else xt.float() * (0.5 + t)
        if conditional:
            atb = rest[0]
            out = out + 0.25 * (atb.astype(xp.float32) if xp is jnp else atb.float())
        return out
    return velocity


@pytest.mark.parametrize("model", ["stand_in", "tiny_f32"])
@pytest.mark.parametrize("conditional", [False, True], ids=["unconditional", "conditional"])
def test_bf16_objective_loss_matches_jax(monkeypatch, conditional, model):
    """The stand-in model isolates the objective: against JAX op by op, 1e-4
    relative, the f32 means over 15,360 elements summed in another order
    (compiled, XLA fuses ``alpha·x0 + beta·x1`` and rounds once where each op
    rounds to bf16 here). The tiny UNet at ``dtype="float32"`` (flax's
    ``dtype=None``: bf16 volumes reach its first convs and the ATb towers in
    bf16, its Dense layers promote) against compiled JAX, to one bf16
    rounding, 2^-8 relative: its first convs round in bf16 on both sides, in
    other orders (and XLA keeps some of it in f32)."""
    cfg = port_config.tiny_test(conditional=conditional)
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, objective_dtype="bfloat16"))
    tc, e = cfg.training, cfg.data.embedding_dim
    table = jnp.asarray(simplex_embedding(cfg.data.num_categories, e))
    batch = np.random.default_rng(4).integers(-1, 14, (2, 8, 8, 8)).astype(np.int32)
    key = jax.random.PRNGKey(5)
    if model == "stand_in":
        params, jvelocity = {}, _stand_in(conditional, jnp)
        port_model = lambda *args: _stand_in(conditional, torch)(*args[:-1])  # noqa: E731
        apply_fn = lambda p, *args, deterministic=True, rngs=None: jvelocity(*args)  # noqa: E731
        rtol = 1e-4
    else:
        jmodel = jax_build_model(jax_config.ExperimentConfig.from_dict(cfg.to_dict()))
        x = jnp.zeros((1, 8, 8, 8, e))
        params = random_params(jmodel, x, jnp.zeros((1,)), 3, cfg.model.time_bandwidth,
                               atb=x if conditional else None)["params"]
        port_model = build_model(cfg, device="cpu")
        port_model.load_state_dict(params_from_jax(params, port_model))
        port_model.eval()

        def apply_fn(p, *args, deterministic=True, rngs=None):
            return jmodel.apply({"params": p}, *args, deterministic=deterministic, rngs=rngs)
        rtol = 2.0**-8

    kw = dict(interpolant=JaxLinearInterpolant(one_sided=True), time_range=tc.time_range,
              x1_noise=tc.x1_noise, train=False, objective_dtype=jnp.bfloat16)
    jloss = (jax_objectives.conditional_loss if conditional else jax_objectives.unconditional_loss)
    if conditional:
        kw["lambda_reconstruct"] = tc.lambda_reconstruct
    # JAX's own draws, in bf16 (T in f32), compiled (the same values as op by op)
    if conditional:
        k_mask, k_data, _ = jax.random.split(key, 3)
        jmask = jax.jit(jax_objectives.make_combined_mask)(k_mask, jnp.asarray(batch))
        mask = np.array(jmask)
        monkeypatch.setattr(jax_objectives, "make_combined_mask", lambda *a: jmask)
    else:
        k_data, _ = jax.random.split(key)
    jdraws = jax.jit(lambda k: jax_objectives._draw_common(
        k, jnp.asarray(batch), table, tc.time_range, tc.x1_noise, dtype=jnp.bfloat16))(k_data)
    _, x1, x0, t = jdraws
    assert x1.dtype == x0.dtype == jnp.bfloat16 and t.dtype == jnp.float32
    monkeypatch.setattr(jax_objectives, "_draw_common", lambda *a, **k: jdraws)
    run = lambda p: jloss(apply_fn, p, {"embedding": table}, jnp.asarray(batch), key,  # noqa: E731
                          **kw)[0]
    if model == "stand_in":  # op by op: XLA's fusions keep bf16 products in f32
        with jax.disable_jit():
            want = float(run(params))
    else:
        want = float(jax.jit(run)(params))
    draws = tuple(torch.tensor(np.asarray(a.astype(jnp.float32))) for a in (x1, x0, t))
    draws = (draws[0].bfloat16(), draws[1].bfloat16(), draws[2])
    if conditional:
        draws = (torch.from_numpy(mask),) + draws
    loss_fn = objectives.conditional_loss if conditional else objectives.unconditional_loss
    extra = dict(lambda_reconstruct=tc.lambda_reconstruct) if conditional else {}
    with torch.no_grad():
        got, _ = loss_fn(port_model, torch.from_numpy(batch),
                         torch.from_numpy(np.asarray(table)), None,
                         interpolant=LinearInterpolant(one_sided=True),
                         time_range=tc.time_range, x1_noise=tc.x1_noise, draws=draws,
                         objective_dtype=torch.bfloat16, **extra)
    np.testing.assert_allclose(got.item(), want, rtol=rtol)
    # the port's own draws: bf16 volumes, f32 times
    _, px1, px0, pt = objectives._draw_common(torch.Generator().manual_seed(0),
                                              torch.from_numpy(batch),
                                              torch.from_numpy(np.asarray(table)),
                                              tc.time_range, tc.x1_noise, torch.bfloat16)
    assert px1.dtype == px0.dtype == torch.bfloat16 and pt.dtype == torch.float32
