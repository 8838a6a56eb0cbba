"""The port's sharded training and sampling against the JAX package's sharded
functions, on the same weights, inputs and draws.

JAX runs ``make_spatial_loss_and_grad``, ``make_spatial_train_step`` and
``make_spatial_sampler`` (``train/shard_map_step.py``, ``inference.py``) under
``shard_map`` on 4 of the 8 CPU devices; the port runs its counterparts on 4
gloo ranks (``tests/torch_parallel_cases.py::spatial_jax_cases``, spawned once
and run while JAX compiles). The weights are the port's seeded ones
(``init_train_state``), handed to JAX by ``params_to_jax``. The RNG streams
differ, so the port is fed JAX's draws: ``spatial_draws`` of every ``(data,
spatial)`` block from ``fold_in(key, state.step)`` (JAX folds the step in
before it draws), and JAX's ``make_combined_mask`` of the global labels.

Cases, ``tiny_test`` at 16 x 8 x 8 and batch 2 (X_loc = 4 on 1 x 4, the 7³
init conv's halo 3; 8 on 2 x 2), every model and every mesh seen by both step
functions:
- ``make_spatial_loss_and_grad``: unconditional on 1 x 4, conditional on 2 x 2;
- ``make_spatial_train_step``, two steps: unconditional on 2 x 2, conditional
  on 1 x 4;
- ``make_spatial_sampler`` at the preset's inference settings (Euler over 4
  frames), unconditional and conditional (the ATb of JAX's mask), on 1 x 4.

Tolerances, f32 rounding of two implementations that sum in other orders:
``LOSS_REL_TOL`` for every loss and metric (the gradient norm among them);
``GRAD_REL_TOL`` of each leaf's largest entry for the gradients (the JAX
spatial test's 2e-4); the total update of the parameters and of the EMA shadow
over two Adam steps within ``UPDATE_REL_TOL`` relative L2 (an Adam step moves
a weight by about the learning rate whatever its gradient's size, so an entry
whose gradient is at f32 noise may move another way: elementwise, 1 entry of
the tiny model's 3456 ``downs_1_downsample`` weights parted by 1.1e-4); the
decode equal and the prominence within ``PROMINENCE_ABS_TOL``.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from flowtrain_stochastic_interpolation_torch import config as port_config
from flowtrain_stochastic_interpolation_torch.models.persistence import (
    params_from_jax,
    params_to_jax,
)
from flowtrain_stochastic_interpolation_torch.data.synthetic import (
    synthetic_geology_batch as port_synthetic,
)
from flowtrain_stochastic_interpolation_torch.parallel.launch import spawn
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state
from flowtrain_stochastic_interpolation_tpu import config as jax_config
from flowtrain_stochastic_interpolation_tpu.inference import make_spatial_sampler
from flowtrain_stochastic_interpolation_tpu.ops.masks import make_combined_mask
from flowtrain_stochastic_interpolation_tpu.parallel import create_mesh
from flowtrain_stochastic_interpolation_tpu.train import state as jax_state
from flowtrain_stochastic_interpolation_tpu.train.loop import build_model
from flowtrain_stochastic_interpolation_tpu.train.shard_map_step import (
    make_spatial_loss_and_grad,
    make_spatial_train_step,
    spatial_draws,
)

import torch_parallel_cases as cases

SHAPE, BATCH = (16, 8, 8), 2
STEPS = 2
LOSS_REL_TOL = 1e-5
GRAD_REL_TOL = 2e-4
UPDATE_REL_TOL = 1e-3
PROMINENCE_ABS_TOL = 1e-5

# (name, kind, conditional, (n_data, n_spatial))
CASES = (("loss_uncond", "loss", False, (1, 4)), ("loss_cond", "loss", True, (2, 2)),
         ("steps_uncond", "steps", False, (2, 2)), ("steps_cond", "steps", True, (1, 4)))
SAMPLERS = (("sample_uncond", False), ("sample_cond", True))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(conditional: bool):
    cfg = port_config.tiny_test(conditional=conditional)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, shape=SHAPE,
                                                             batch_size=BATCH))


def jax_side(cfg):
    """The port's seeded weights as a JAX train state, the JAX config, and the
    port's optimiser's schedule length."""
    model, tx, state = init_train_state(cfg, device="cpu")
    jcfg = jax_config.ExperimentConfig.from_dict(cfg.to_dict())
    jtx = jax_state.make_optimizer(jcfg.training, updates_per_epoch=tx.transition_steps)
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))
    table = jnp.asarray(state.constants["embedding"].numpy())
    return jax_state.init_state(params, {"embedding": table}, jtx, jcfg.ema), jcfg, jtx


# compiled once per shape (eager, each op is a small compile)
_jax_draws = jax.jit(spatial_draws, static_argnums=(3, 4))
_jax_mask = jax.jit(make_combined_mask)


def fed_draws(cfg, jstate, labels, key, mesh_shape, steps: int) -> dict:
    """What JAX's per-device body draws, by ``(step, di, si)``: ``spatial_draws`` of
    each block from ``fold_in(key, step)``, as torch tensors."""
    n_data, n_spatial = mesh_shape
    b_loc, x_loc = labels.shape[0] // n_data, labels.shape[1] // n_spatial
    tc = cfg.training
    table = jstate.constants["embedding"]
    out = {}
    for step in range(steps):
        k = jax.random.fold_in(key, step)
        for di in range(n_data):
            for si in range(n_spatial):
                block = labels[di * b_loc:(di + 1) * b_loc, si * x_loc:(si + 1) * x_loc]
                drawn = _jax_draws(k, block, table, tuple(tc.time_range), tc.x1_noise, di, si)
                out[(step, di, si)] = tuple(torch.from_numpy(np.array(a)) for a in drawn)
    return out


def placed(mesh, jstate, arrays):
    state = jax.device_put(jstate, NamedSharding(mesh, P()))
    return state, [jax.device_put(a, NamedSharding(mesh, P("data", "spatial"))) for a in arrays]


@pytest.fixture(scope="module")
def setup():
    # every case's labels: two synthetic volumes (the port's generator), one sample a data
    # rank on 2 x 2, both on each rank's slab on 1 x 4
    labels = port_synthetic(torch.Generator().manual_seed(10), BATCH, SHAPE)
    jlabels = jnp.asarray(labels.numpy())
    inputs, masks = {}, {}
    for i, (name, kind, conditional, mesh_shape) in enumerate(CASES):
        jstate, jcfg, jtx = jax_side(config(conditional))
        mask = _jax_mask(jax.random.PRNGKey(20 + i), jlabels) if conditional else None
        inputs[name] = dict(kind=kind, jstate=jstate, jcfg=jcfg, jtx=jtx, labels=jlabels,
                            mask=mask, key=jax.random.PRNGKey(30 + i), mesh_shape=mesh_shape)
    rng = np.random.default_rng(40)
    for name, conditional in SAMPLERS:
        jstate, jcfg, _ = jax_side(config(conditional))
        x0 = rng.standard_normal((BATCH, *SHAPE, jcfg.data.embedding_dim)).astype(np.float32)
        atb = None
        if conditional:  # the observations of the volumes under JAX's mask
            mask = np.array(_jax_mask(jax.random.PRNGKey(50), jlabels))
            table = np.asarray(jstate.constants["embedding"])
            atb = (table[labels.numpy()] * mask[..., None]).astype(np.float32)
        inputs[name] = dict(jstate=jstate, jcfg=jcfg, x0=x0, atb=atb)

    # JAX compiles its six programs in threads of their own (XLA compiles without the
    # interpreter's lock) while this thread draws the port's feed and the ranks run
    with ThreadPoolExecutor(len(CASES) + len(SAMPLERS) + 1) as pool:
        jobs = {name: pool.submit(run_jax, **inputs[name]) for name, _, _, _ in CASES}
        jobs.update({name: pool.submit(run_jax_sampler, **inputs[name])
                     for name, _ in SAMPLERS})
        spatial = []
        for name, kind, conditional, mesh_shape in CASES:
            case = inputs[name]
            draws = fed_draws(case["jcfg"], case["jstate"], jlabels, case["key"], mesh_shape,
                              1 if kind == "loss" else STEPS)
            mask = None if case["mask"] is None else torch.from_numpy(np.array(case["mask"]))
            spatial.append((name, kind, config(conditional), mesh_shape, labels, mask, draws))
        samplers = [(name, config(conditional), torch.from_numpy(inputs[name]["x0"]),
                     None if inputs[name]["atb"] is None else torch.from_numpy(inputs[name]["atb"]))
                    for name, conditional in SAMPLERS]
        ranks = pool.submit(spawn, cases.spatial_jax_cases, cases.SPATIAL, (spatial, samplers),
                            threads=1, deadline_s=300)
        ref = {name: job.result() for name, job in jobs.items()}
        return dict(ranks=ranks.result(), ref=ref)


def run_jax(kind, jstate, jcfg, jtx, labels, mask, key, mesh_shape):
    mesh = create_mesh(n_data=mesh_shape[0], n_spatial=mesh_shape[1])
    model = build_model(jcfg, spatial_axis="spatial")
    state, arrays = placed(mesh, jstate, [labels] + ([] if mask is None else [mask]))
    if kind == "loss":
        loss, metrics, grads = make_spatial_loss_and_grad(model, jcfg, mesh)(state, *arrays, key)
        return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": params_from_jax(jax.tree_util.tree_map(np.asarray, grads))}
    step = make_spatial_train_step(model, jtx, jcfg, mesh)
    history = []
    for _ in range(STEPS):
        state, metrics = step(state, *arrays, key)
        history.append({k: float(v) for k, v in metrics.items()})
    tree = lambda t: params_from_jax(jax.tree_util.tree_map(np.asarray, t))
    return {"history": history, "params": tree(state.params), "ema": tree(state.ema_params),
            "step": int(state.step)}


def run_jax_sampler(jstate, jcfg, x0, atb):
    mesh = create_mesh(n_data=1, n_spatial=cases.SPATIAL)
    ic = jcfg.inference
    sampler = make_spatial_sampler(build_model(jcfg, spatial_axis="spatial"),
                                   {"params": jstate.params}, jstate.constants["embedding"], mesh,
                                   conditional=jcfg.model.conditional, t0=ic.t0, tf=ic.tf,
                                   n_frames=ic.n_frames, substeps=ic.substeps, method=ic.method,
                                   with_prominence=True)
    vol = NamedSharding(mesh, P("data", "spatial"))
    args = [jax.device_put(jnp.asarray(a), vol) for a in (x0, atb) if a is not None]
    return {k: np.asarray(v) for k, v in sampler(*args).items()}


def rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def grads_close(got, want: dict, names) -> None:
    for g, key in zip(got, names):
        w = want[key]
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_REL_TOL * np.abs(w).max(), rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["loss_uncond", "loss_cond"])
def test_spatial_loss_and_grad_matches_jax(setup, name):
    ref = setup["ref"][name]
    names = list(init_train_state(config(name == "loss_cond"), device="cpu")[2].params)
    assert set(names) == set(ref["grads"])
    for rank in setup["ranks"]:
        got = rank[name]
        assert rel(float(got["loss"]), ref["loss"]) <= LOSS_REL_TOL
        assert set(got["metrics"]) == set(ref["metrics"])
        for key, value in ref["metrics"].items():
            assert rel(float(got["metrics"][key]), value) <= LOSS_REL_TOL, key
        grads_close(got["grads"], ref["grads"], names)


@pytest.mark.parametrize("name", ["steps_uncond", "steps_cond"])
def test_spatial_train_step_matches_jax_over_two_steps(setup, name):
    ref = setup["ref"][name]
    start = {k: v.detach().numpy() for k, v in
             init_train_state(config(name == "steps_cond"), device="cpu")[2].params.items()}
    names = sorted(start)
    first = setup["ranks"][0][name]
    for rank in setup["ranks"]:
        got = rank[name]
        assert got["step"] == ref["step"] == STEPS
        for got_m, ref_m in zip(got["history"], ref["history"]):
            assert set(got_m) == set(ref_m)
            for key, value in ref_m.items():
                assert rel(float(got_m[key]), value) <= LOSS_REL_TOL, key
        for part in ("params", "ema"):  # replicas bitwise equal
            assert all(torch.equal(got[part][k], first[part][k]) for k in first[part])
    for part in ("params", "ema"):  # the total updates of the two packages
        got = np.concatenate([(first[part][k].numpy() - start[k]).ravel() for k in names])
        want = np.concatenate([(ref[part][k] - start[k]).ravel() for k in names])
        assert np.linalg.norm(got - want) <= UPDATE_REL_TOL * np.linalg.norm(want), part


@pytest.mark.parametrize("name", ["sample_uncond", "sample_cond"])
def test_spatial_sampler_matches_jax(setup, name):
    ref = setup["ref"][name]
    got = {k: torch.cat([r[name][k] for r in setup["ranks"]], dim=1).numpy()
           for k in ("decoded", "prominence")}
    np.testing.assert_array_equal(got["decoded"], ref["decoded"])
    np.testing.assert_allclose(got["prominence"], ref["prominence"], atol=PROMINENCE_ABS_TOL,
                               rtol=0)
