"""Probes behind ``tests/test_torch_train_trajectory.py`` and
``tests/test_torch_synthetic_stats.py``: how far apart two training runs or two
generators may be before it means a fault. Not a test file (pytest does not
collect it); run from the repository root on the CPU:

    python tests/torch_trajectory_probe.py forced --case flagship --seed 1 --steps 30
    python tests/torch_trajectory_probe.py jax-self --case conditional --lr 1e-3 --steps 6
    python tests/torch_trajectory_probe.py synthetic --seeds 40

* ``forced``: at every step the port is given the JAX step's weights (teacher
  forcing) and takes one step on the JAX step's draws: the per-step relative
  difference of the loss and the gradient norm with the parameters equal;
* ``jax-self``: the JAX package against itself, from weights one ulp apart
  (each value moved to its neighbour in f32, up or down at random): the
  per-step relative differences that f32 rounding alone leaves;
* ``synthetic``: the change shares along z and x of each generator stage, over
  ``--seeds`` seeds of 256 volumes at 32³ a package: their means and spreads.

The cases are the trajectory test's (``flagship``, ``conditional``); ``--lr``
replaces the case's learning rate.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_train_trajectory as trajectory  # noqa: E402
from flowtrain_stochastic_interpolation_torch.data import synthetic as port_synthetic  # noqa: E402
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant  # noqa: E402
from flowtrain_stochastic_interpolation_torch.models.persistence import (  # noqa: E402
    params_from_jax,
    params_to_jax,
)
from flowtrain_stochastic_interpolation_torch.train import objectives  # noqa: E402
from flowtrain_stochastic_interpolation_tpu.data import synthetic as jax_synthetic  # noqa: E402

STAGES = ("strata", "tilt", "fold", "dike", "topography")


def _case(name: str, lr):
    cfg = {"flagship": trajectory.flagship, "conditional": trajectory.conditional}[name]()
    if lr is not None:
        cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training,
                                                                    learning_rate=lr))
    return cfg


def _jax_run(cfg, params, table, tx_steps: int):
    jcfg = trajectory.jax_config.ExperimentConfig.from_dict(cfg.to_dict())
    jtx = trajectory.jax_state.make_optimizer(jcfg.training, updates_per_epoch=tx_steps)
    state = trajectory.jax_state.init_state(params, {"embedding": jnp.array(table)}, jtx,
                                            jcfg.ema)
    return state, trajectory.jax_steps.make_train_step(trajectory.jax_build_model(jcfg), jtx,
                                                       jcfg)


def _step_data(cfg, seed: int, i: int):
    batch = trajectory.synthetic_geology_batch(jax.random.PRNGKey(1000 * seed + 2 * i), 1,
                                               cfg.data.shape)
    return batch, jax.random.PRNGKey(1000 * seed + 2 * i + 1)


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def forced(cfg, seed: int, steps: int) -> None:
    model, tx, state = trajectory.init_train_state(cfg, device="cpu")
    table = state.constants["embedding"].numpy()
    jstate, jstep = _jax_run(cfg, jax.tree_util.tree_map(jnp.asarray,
                                                         params_to_jax(model.state_dict())),
                             table, tx.transition_steps)
    tc = cfg.training
    kwargs = dict(interpolant=LinearInterpolant(one_sided=True), time_range=tc.time_range,
                  x1_noise=tc.x1_noise)
    if cfg.model.conditional:
        kwargs["lambda_reconstruct"] = tc.lambda_reconstruct
    loss_fn = objectives.conditional_loss if cfg.model.conditional else objectives.unconditional_loss
    for i in range(steps):
        batch, key = _step_data(cfg, seed, i)
        drawn, mask = trajectory._jax_draws(jax.random.fold_in(key, int(jstate.step)), batch,
                                            jnp.asarray(table), cfg)
        weights = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), model)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[name])
        model.train()
        model.zero_grad(set_to_none=True)
        draws = (mask, *drawn[1:]) if cfg.model.conditional else drawn[1:]
        loss, _ = loss_fn(model, torch.from_numpy(np.array(batch)), torch.from_numpy(table),
                          torch.Generator(), draws=draws, **kwargs)
        loss.backward()
        norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.parameters())))
        loss = loss.detach()
        jstate, metrics = jstep(jstate, batch, key)
        print(f"step {i}: loss {float(metrics['train_loss']):.6g}, relative difference "
              f"{_rel(float(loss), float(metrics['train_loss'])):.2e}; grad norm "
              f"{_rel(norm, float(metrics['grad_norm'])):.2e}", flush=True)


def jax_self(cfg, seed: int, steps: int) -> None:
    model, tx, state = trajectory.init_train_state(cfg, device="cpu")
    table = state.constants["embedding"].numpy()
    base = params_to_jax(model.state_dict())
    rng = np.random.default_rng(0)

    def one_ulp(a):
        away = (np.inf * np.sign(rng.standard_normal(a.shape))).astype(np.float32)
        return np.nextafter(a, away)

    runs = []
    for params in (base, jax.tree_util.tree_map(one_ulp, base)):
        jstate, jstep = _jax_run(cfg, jax.tree_util.tree_map(jnp.asarray, params), table,
                                 tx.transition_steps)
        out = []
        for i in range(steps):
            batch, key = _step_data(cfg, seed, i)
            jstate, metrics = jstep(jstate, batch, key)
            out.append((float(metrics["train_loss"]), float(metrics["grad_norm"])))
        runs.append(np.array(out))
    rel = np.abs(runs[0] - runs[1]) / np.abs(runs[0])
    for i, (loss, norm) in enumerate(rel):
        print(f"step {i}: loss {runs[0][i, 0]:.6g}, relative difference {loss:.2e}; grad norm "
              f"{norm:.2e}", flush=True)
    print(f"worst: loss {rel[:, 0].max():.2e}, grad norm {rel[:, 1].max():.2e}")


def synthetic(seeds: int) -> None:
    shape, n = (32, 32, 32), 256
    stages = jax.jit(jax.vmap(lambda k: jax_synthetic.synthetic_geology_stages(k, shape)))
    shares = {"port": [], "JAX": []}
    for seed in range(seeds):
        ours = port_synthetic._stages(torch.Generator().manual_seed(100 + seed), n, shape, 15)
        theirs = stages(jax.random.split(jax.random.PRNGKey(100 + seed), n))
        for side, st in (("port", {k: v.numpy() for k, v in ours.items()}),
                         ("JAX", {k: np.asarray(v) for k, v in theirs.items()})):
            shares[side].append([[(st[k][..., 1:] != st[k][..., :-1]).mean(),
                                  (st[k][:, 1:] != st[k][:, :-1]).mean()] for k in STAGES])
    port, theirs = np.array(shares["port"]), np.array(shares["JAX"])
    for i, stage in enumerate(STAGES):
        cells = [f"{axis}: port {port[:, i, j].mean():.4f} ± {port[:, i, j].std():.4f}, JAX "
                 f"{theirs[:, i, j].mean():.4f} ± {theirs[:, i, j].std():.4f}"
                 for j, axis in enumerate(("z", "x"))]
        print(f"{stage} ({seeds} seeds of {n}): " + "; ".join(cells))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("probe", choices=["forced", "jax-self", "synthetic"])
    p.add_argument("--case", default="flagship", choices=["flagship", "conditional"])
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--seeds", type=int, default=40)
    args = p.parse_args()
    torch.set_num_threads(4)
    if args.probe == "synthetic":
        synthetic(args.seeds)
    elif args.probe == "forced":
        forced(_case(args.case, args.lr), args.seed, args.steps)
    else:
        jax_self(_case(args.case, args.lr), args.seed, args.steps)


if __name__ == "__main__":
    main()
