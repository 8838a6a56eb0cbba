"""The ranks' side of the port's parallel tests (not a test file).

Each function here runs in one rank of a gloo process group that
``parallel.launch.spawn`` started, imports only torch and the port (the
ranks never import JAX), and returns its results as CPU tensors; the test
files compare them, in the parent process, with the JAX package and with
the port's unsharded modules.

Every input is made from a seed with numpy, the same on every rank, and each
rank takes its block: tokens and X along axis 1, the batch along axis 0.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist

from flowtrain_stochastic_interpolation_torch.inference import make_spatial_sampler
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_torch.models.unet_cond import UNet3DCond
from flowtrain_stochastic_interpolation_torch.parallel import create_mesh, shard_batch
from flowtrain_stochastic_interpolation_torch.parallel.mesh import Mesh
from flowtrain_stochastic_interpolation_torch.parallel.spatial import (
    halo_conv3d,
    halo_exchange,
    ring_attention,
    sharded_linear_attention,
    sharded_resize3d,
)
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state, train
from flowtrain_stochastic_interpolation_torch.train.shard_map_step import (
    make_shard_map_train_step,
    make_spatial_loss_and_grad,
    make_spatial_train_step,
)
from flowtrain_stochastic_interpolation_torch.train.steps import (
    make_data_parallel_loss_and_grads,
    make_train_step,
)

SPATIAL = 4
CONV_X = (2, 16, 8, 8, 5)        # the JAX spatial tests' conv input
WIDE_X = (2, 4, 6, 6, 5)         # X_loc = 1 on 4 ranks: every halo wider than the slab
ATTN = (2, 32, 2, 4)             # [B, N, H, D]: 8 tokens a shard
N_MEM = 4
UNET_KW = dict(dim=8, dim_mults=(1, 2), data_channels=6, dropout=0.0, time_resolution=16,
               time_bandwidth=10.0, time_learned_emb=True, attn_dim_head=4, attn_heads=2,
               flash_attn=False)
UNET_X = (2, 16, 8, 8, 6)


def normal(seed: int, shape, scale: float = 1.0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
                            * np.float32(scale))


def block(x: torch.Tensor, rank: int, n: int, axis: int = 1) -> torch.Tensor:
    size = x.shape[axis] // n
    return x.narrow(axis, rank * size, size).contiguous()


def conv_inputs(k: int):
    x = normal(0, CONV_X)
    w = normal(10 + k, (6, 5, k, k, k), 0.1)       # torch's [out, in, k, k, k]
    b = normal(20 + k, (6,))
    cot = normal(30 + k, CONV_X[:4] + (6,))
    return x, w, b, cot


def wide_conv_inputs(k: int):
    """``conv_inputs`` on a volume of X = 4: one plane a rank on 4 ranks."""
    x = normal(4, WIDE_X)
    w = normal(14 + k, (6, 5, k, k, k), 0.1)
    b = normal(24 + k, (6,))
    cot = normal(34 + k, WIDE_X[:4] + (6,))
    return x, w, b, cot


def attention_inputs():
    q, k, v = (normal(40 + i, ATTN) for i in range(3))
    mk, mv = (normal(50 + i, (ATTN[0], N_MEM, ATTN[2], ATTN[3])) for i in range(2))
    return q, k, v, mk, mv, normal(60, ATTN)


def _grad_leaves(*tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def primitives(rank: int) -> dict:
    """halo_conv3d (3³, 7³), sharded_resize3d (×2, ×0.5), ring_attention and
    sharded_linear_attention with memory K/V, forward and gradients; then the
    5³ and 7³ convs and a halo of 6 with one X plane a rank; 4 spatial ranks."""
    torch.manual_seed(0)
    group = dist.group.WORLD
    out = {}
    for k in (3, 7):
        x, w, b, cot = conv_inputs(k)
        xs, ws, bs = _grad_leaves(block(x, rank, SPATIAL), w, b)
        y = halo_conv3d(xs, ws, bs, group)
        (y * block(cot, rank, SPATIAL)).sum().backward()
        out[f"conv{k}"] = y.detach()
        out[f"conv{k}_grads"] = [xs.grad, ws.grad, bs.grad]
    x = normal(1, (2, 16, 8, 8, 3))
    for scale in (2.0, 0.5):
        xs, = _grad_leaves(block(x, rank, SPATIAL))
        y = sharded_resize3d(xs, scale, group)
        cot = normal(2, (2, int(16 * scale), int(8 * scale), int(8 * scale), 3))
        (y * block(cot, rank, SPATIAL)).sum().backward()
        out[f"resize{scale}"] = y.detach()
        out[f"resize{scale}_grad"] = xs.grad
    q, k, v, mk, mv, cot = attention_inputs()
    for name, fn in (("ring", ring_attention), ("linear", sharded_linear_attention)):
        leaves = _grad_leaves(*(block(t, rank, SPATIAL) for t in (q, k, v)), mk, mv)
        y = fn(*leaves[:3], group, mem_k=leaves[3], mem_v=leaves[4])
        (y * block(cot, rank, SPATIAL)).sum().backward()
        out[name] = y.detach()
        out[f"{name}_grads"] = [t.grad for t in leaves]
    # halos wider than the slab: X_loc = 1, the 5³ and 7³ convs reach over 2 and 3 ranks
    for k in (5, 7):
        x, w, b, cot = wide_conv_inputs(k)
        xs, ws, bs = _grad_leaves(block(x, rank, SPATIAL), w, b)
        y = halo_conv3d(xs, ws, bs, group)
        (y * block(cot, rank, SPATIAL)).sum().backward()
        out[f"wide{k}"] = y.detach()
        out[f"wide{k}_grads"] = [xs.grad, ws.grad, bs.grad]
    out["wide_halo"] = halo_exchange(block(normal(3, WIDE_X), rank, SPATIAL), group, 6)
    return out


def _sharded_unet(conditional: bool, group, weights):
    kw = dict(UNET_KW, device="cpu", spatial_group=group)
    model = UNet3DCond(**kw, variant="v3") if conditional else UNet(**kw)
    model.load_state_dict(weights)
    return model


def unet_forward_backward(rank: int, weights: dict, cond_weights: dict, x: torch.Tensor,
                          atb: torch.Tensor, t: torch.Tensor, cot: torch.Tensor,
                          table: torch.Tensor, x0: torch.Tensor) -> dict:
    """The sharded UNet and UNet3DCond v3 (4 spatial ranks): forward, the
    gradient of ``sum(out · cot)`` (this rank's part), and the spatial sampler."""
    torch.manual_seed(0)
    mesh = create_mesh(1, SPATIAL)
    out = {}
    for name, w in (("unet", weights), ("cond", cond_weights)):
        model = _sharded_unet(name == "cond", mesh.spatial_group, w)
        args = (block(x, rank, SPATIAL),) + ((block(atb, rank, SPATIAL),) if name == "cond"
                                             else ()) + (t,)
        y = model(*args)
        (y * block(cot, rank, SPATIAL)).sum().backward()
        out[name] = y.detach()
        out[f"{name}_grads"] = {k: p.grad for k, p in model.named_parameters()}
        sampler = make_spatial_sampler(model, table, mesh, conditional=name == "cond",
                                       n_frames=3, substeps=1, with_prominence=True)
        res = sampler(*((block(x0, rank, SPATIAL),) + args[1:-1]))
        out[f"{name}_sample"] = {"decoded": res["decoded"], "prominence": res["prominence"]}
    return out


def _sub_mesh(ranks) -> Mesh:
    """A data-parallel mesh over the global ``ranks`` (every rank must call this);
    None on the ranks outside it."""
    group = dist.new_group(list(ranks))
    me = dist.get_rank()
    if me not in ranks:
        return None
    return Mesh(len(ranks), 1, list(ranks).index(me), 0, group, group, None)


def _params(state) -> dict:
    return {k: v.detach().clone() for k, v in state.params.items()}


def train_cases(rank: int, uncond: tuple, cond: tuple, spatial: tuple) -> dict:
    """8 ranks. Ranks 0 and 1: the data-parallel micro-step (global objective) and
    make_shard_map_train_step on fed draws, then 2 data-parallel steps on each
    rank's own draws; all 8 as a 2 x 4 mesh: the spatial loss and gradient,
    unconditional and conditional, then 2 conditional spatial train steps.
    ``uncond`` and ``cond`` are ``(config, batch, draws)``, ``spatial`` is
    ``(config, cond_config, labels, mask)``; the weights are each config's seeded
    ones (``init_train_state``)."""
    torch.manual_seed(0)
    out = {}
    mesh = _sub_mesh([0, 1])
    if mesh is not None:
        for name, (config, batch, draws) in (("uncond", uncond), ("cond", cond)):
            model, tx, state = init_train_state(config, device="cpu", mesh=mesh)
            local = shard_batch(batch, mesh)
            local_draws = tuple(shard_batch(d, mesh) for d in draws)
            gen = torch.Generator().manual_seed(5)
            metrics, grads = make_data_parallel_loss_and_grads(model, config, mesh)(
                state, local, gen, local_draws)
            out[f"dp_{name}"] = {"metrics": metrics, "grads": grads}
        config, batch, draws = uncond
        model, tx, state = init_train_state(config, device="cpu", mesh=mesh)
        local = shard_batch(batch, mesh)
        step = make_shard_map_train_step(model, tx, config, mesh)
        seen = []  # the gradients that the step hands the optimiser
        update = tx.update
        tx.update = lambda grads, *a: (seen.append([g.clone() for g in grads]), update(grads, *a))[1]
        state, metrics = step(state, local, torch.Generator().manual_seed(5),
                              tuple(shard_batch(d, mesh) for d in draws))
        out["shard_map"] = {"metrics": metrics, "grads": seen[0]}
        model, tx, state = init_train_state(config, device="cpu", mesh=mesh)
        step = make_train_step(model, tx, config, mesh)
        for s in range(2):
            state, _ = step(state, local, torch.Generator().manual_seed(100 + 10 * s + mesh.di))
        out["dp_replica"] = {"params": _params(state), "ema": dict(state.ema_params)}
    mesh = create_mesh(2, 4)
    config, cond_config, labels, mask = spatial
    local_labels, local_mask = shard_batch(labels, mesh), shard_batch(mask, mesh)
    for name, cfg, m in (("uncond", config, None), ("cond", cond_config, local_mask)):
        model, tx, state = init_train_state(cfg, device="cpu", mesh=mesh)
        loss, metrics, grads = make_spatial_loss_and_grad(model, cfg, mesh)(
            state, local_labels, m, 7)
        out[f"spatial_{name}"] = {"loss": loss, "metrics": metrics, "grads": grads}
    model, tx, state = init_train_state(cond_config, device="cpu", mesh=mesh)
    step = make_spatial_train_step(model, tx, cond_config, mesh)
    for _ in range(2):
        state, metrics = step(state, local_labels, local_mask, 9)
    out["spatial_replica"] = {"params": _params(state), "ema": dict(state.ema_params),
                              "loss": metrics["train_loss"]}
    return out


def _fed_draws(draws: dict, current: dict):
    """A stand-in for ``shard_map_step.spatial_draws`` that hands back the draws
    fed for ``(current["step"], di, si)``."""
    def fed(seed, labels, table, time_range, x1_noise, di, si, dtype=None):
        return draws[(current["step"], di, si)]
    return fed


def spatial_jax_cases(rank: int, spatial: list, samplers: list) -> dict:
    """4 ranks. ``spatial``: ``(name, kind, config, (n_data, n_spatial), labels, mask,
    draws)`` cases, ``kind`` "loss" (``make_spatial_loss_and_grad``, one call) or
    "steps" (``make_spatial_train_step``, one call per step of ``draws``, whose keys
    are ``(step, di, si)``), the spatial draws fed in place of the port's own.
    ``samplers``: ``(name, config, x0, atb)``, through ``make_spatial_sampler`` on a
    1 x 4 mesh at the config's inference settings, with prominence. The weights are each
    config's seeded ones (``init_train_state``)."""
    from unittest import mock

    from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding
    from flowtrain_stochastic_interpolation_torch.train import shard_map_step
    from flowtrain_stochastic_interpolation_torch.train.loop import init_model_variables

    torch.manual_seed(0)
    out = {}
    for name, kind, cfg, (n_data, n_spatial), labels, mask, draws in spatial:
        mesh = create_mesh(n_data, n_spatial)
        model, tx, state = init_train_state(cfg, device="cpu", mesh=mesh)
        local_labels = shard_batch(labels, mesh)
        local_mask = None if mask is None else shard_batch(mask, mesh)
        current = {"step": 0}
        with mock.patch.object(shard_map_step, "spatial_draws", _fed_draws(draws, current)):
            if kind == "loss":
                loss, metrics, grads = shard_map_step.make_spatial_loss_and_grad(
                    model, cfg, mesh)(state, local_labels, local_mask, 0)
                out[name] = {"loss": loss, "metrics": metrics, "grads": grads}
                continue
            step = shard_map_step.make_spatial_train_step(model, tx, cfg, mesh)
            history = []
            for s in range(len({k[0] for k in draws})):
                current["step"] = s
                state, metrics = step(state, local_labels, local_mask, 0)
                history.append({k: v.clone() for k, v in metrics.items()})
        out[name] = {"history": history, "params": _params(state),
                     "ema": dict(state.ema_params), "step": state.step}
    mesh = create_mesh(1, SPATIAL)
    for name, cfg, x0, atb in samplers:
        model = init_model_variables(cfg, device="cpu", spatial_group=mesh.spatial_group)
        table = torch.from_numpy(simplex_embedding(cfg.data.num_categories,
                                                   cfg.data.embedding_dim))
        ic = cfg.inference
        sampler = make_spatial_sampler(model, table, mesh, conditional=cfg.model.conditional,
                                       t0=ic.t0, tf=ic.tf, n_frames=ic.n_frames,
                                       substeps=ic.substeps, method=ic.method,
                                       with_prominence=True)
        args = (x0,) + (() if atb is None else (atb,))
        res = sampler(*(shard_batch(a, mesh) for a in args))
        out[name] = {"decoded": res["decoded"], "prominence": res["prominence"]}
    return out


def train_run(rank: int, config, root: str, steps: tuple) -> list:
    """``train()`` on every rank of the group (data parallel) once per entry of
    ``steps``, each run resuming from the checkpoints under ``root``: per run,
    where it started, its end state, and the saves this rank made."""
    from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager

    saves = []
    save = CheckpointManager.save
    CheckpointManager.save = lambda self, step, *a, **kw: (saves.append(step),
                                                          save(self, step, *a, **kw))[1]
    runs = []
    for n in steps:
        saves.clear()
        result = train(copy.deepcopy(config), num_steps=n, checkpoint_dir=root, device="cpu")
        runs.append({"params": _params(result.state), "step": result.state.step,
                     "start": result.state.step - n, "saves": list(saves),
                     "history": [h["train_loss"] for h in result.history]})
    return runs


def loaded_modules(rank: int, prefixes: tuple) -> list:
    """The modules under ``prefixes`` that a rank has loaded once it has imported
    ``chip_smoke`` (whose phase 12 ranks run in such processes) and the port's
    parallel modules."""
    import sys

    import chip_smoke  # noqa: F401
    from flowtrain_stochastic_interpolation_torch.parallel import launch, spatial  # noqa: F401

    return sorted(n for n in sys.modules if n.split(".")[0] in prefixes)
