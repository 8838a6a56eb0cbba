"""Flagship training demonstration on the card: train, checkpoint, sample.

Port of the root ``tools/train_demo.py``. It runs N train steps of the 64³
recipe, logs the loss curve to ``metrics.csv``, checkpoints, then samples
from the trained weights (the EMA shadow where there is one):

* by default the unconditional recipe (batch 4, accumulation 1);
* ``--conditional``: the conditional recipe with borehole and surface masks,
  AdamW and EMA, ending in an ensemble of 4 sampled for a held-out scenario
  (truth seed 999, mask seed 998, noise seed 42) and its observed-voxel
  accuracy;
* ``--shape N``: train at N³. The UNet is fully convolutional, so with
  ``--init-from`` this fine-tunes 64³-trained weights at another size. (The
  JAX tool initialises at 64³ above 64 to keep its one-off ``model.init``
  forward cheap; the port's initialisation runs no forward.)
* ``--init-from DIR``: warm-start the params (and the EMA shadow) from a
  release directory (its EMA first) or a checkpoint directory of the port;
  the optimiser and the step start fresh.

    python -m flowtrain_stochastic_interpolation_torch.tools.train_demo \\
        [--conditional] [--steps 600] [--batch-size B] [--accum K] [--lr LR] \\
        [--out DIR] [--resume] [--shape N] [--init-from DIR] [--device cpu]

Every step draws a fresh synthetic batch from a generator seeded with
``(7, step)`` and the objective's noise from one seeded with ``(7, 1,
step)`` (``utils.rng``), so a resumed run draws what an uninterrupted one
does. A rerun at or past ``--steps`` only samples. ``--n-frames`` cuts the
sampler's frames (the JAX tool's 16, or the conditional config's 8).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.config import (
    ExperimentConfig,
    conditional_64,
    tiny_test,
    unconditional_64,
)
from flowtrain_stochastic_interpolation_torch.data.synthetic import synthetic_geology_batch
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.inference import (
    build_atb,
    sample_conditional,
    sample_unconditional,
)
from flowtrain_stochastic_interpolation_torch.models.persistence import (
    is_release_weights_dir,
    load_release_weights,
    state_dict_from_release,
)
from flowtrain_stochastic_interpolation_torch.ops.masks import make_combined_mask
from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state
from flowtrain_stochastic_interpolation_torch.train.state import TrainState
from flowtrain_stochastic_interpolation_torch.train.steps import make_train_step
from flowtrain_stochastic_interpolation_torch.utils.logging import MetricsWriter
from flowtrain_stochastic_interpolation_torch.utils.plotting import plot_2d_slices
from flowtrain_stochastic_interpolation_torch.utils.rng import generator

ROOT = Path(__file__).resolve().parents[2]
DEMO_SEED = 7      # the JAX tool's PRNGKey(7)
NOISE_STREAM = 1   # the objective's draws: (DEMO_SEED, NOISE_STREAM, step)
LOG_EVERY = 10
# the conditional demo's held-out scenario, drawn on the host so that it is the
# same scenario on every device (tools/analyze_cond_demo.py redraws the mask)
TRUTH_SEED, MASK_SEED, ENSEMBLE_SEED = 999, 998, 42


def parse_arguments(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--conditional", action="store_true")
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--lr", type=float, default=None,
                   help="override the learning rate (the conditional recipe's 1e-3 targets "
                        "effective batch 32; the JAX demo ran 2.5e-4 at b2 x accum 4)")
    p.add_argument("--out", default=None)
    p.add_argument("--resume", action="store_true",
                   help="restore from <out>/ckpt and continue up to --steps")
    p.add_argument("--shape", type=int, default=None,
                   help="cubic volume edge length (default: the preset's)")
    p.add_argument("--init-from", default=None,
                   help="warm-start params/EMA from a release dir or a checkpoint dir; "
                        "fresh optimizer state, step counter reset to 0")
    p.add_argument("--remat", action="store_true",
                   help="rematerialise the forward in the backward")
    p.add_argument("--remat-policy", default=None, choices=["dots", "nothing"])
    p.add_argument("--objective-dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--attn-vjp", default=None,
                   choices=["closed_form", "closed_form_bf16", "chunked", "autodiff"],
                   help="the folded linear attention's backward (ModelConfig.attn_folded_vjp)")
    p.add_argument("--remat-blocks", action="store_true",
                   help="an activation checkpoint around each block (ModelConfig.remat_blocks)")
    p.add_argument("--no-ema", action="store_true", help="drop the EMA shadow")
    p.add_argument("--preset", default="flagship", choices=["flagship", "tiny"],
                   help="tiny = the 8³ smoke config (a CPU drive of the tool)")
    p.add_argument("--n-frames", type=int, default=None,
                   help="the sampler's frames (default: 16, or the conditional config's)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.batch_size is None:
        args.batch_size = 2 if args.conditional else 4
    if args.out is None:
        args.out = str(ROOT / "artifacts" / "torch"
                       / ("train_demo_cond" if args.conditional else "train_demo"))
    return args


def demo_config(args: argparse.Namespace) -> ExperimentConfig:
    """The preset with the command line's overrides (the JAX tool's rules)."""
    if args.preset == "tiny":
        config = tiny_test(conditional=args.conditional)
    else:
        config = conditional_64() if args.conditional else unconditional_64()
    training = {"accumulate_grad_batches": args.accum}
    if args.lr is not None:
        training["learning_rate"] = args.lr
    if args.remat:
        training["remat"] = True
    if args.remat_policy is not None:
        training["remat_policy"] = args.remat_policy
    if args.objective_dtype is not None:
        training["objective_dtype"] = args.objective_dtype
    data = {"batch_size": args.batch_size}
    if args.shape is not None:
        data["shape"] = (args.shape,) * 3
    model = {}
    if args.attn_vjp is not None:
        model["attn_folded_vjp"] = args.attn_vjp
    if args.remat_blocks:
        model["remat_blocks"] = True
    return dataclasses.replace(
        config,
        model=dataclasses.replace(config.model, **model),
        data=dataclasses.replace(config.data, **data),
        training=dataclasses.replace(config.training, **training),
        ema=dataclasses.replace(config.ema, enabled=config.ema.enabled and not args.no_ema),
    )


@torch.no_grad()
def warm_start(model, state: TrainState, config: ExperimentConfig, path: str,
               device) -> Optional[int]:
    """Copy the weights of ``path`` into ``state`` (and ``model``, whose tensors
    they are): a release directory's EMA params where it has any, else its
    params; a checkpoint directory's params, restored into a template of the
    source run's own config (``config``'s where it has none), so that an
    optimiser state of another shape restores. The optimiser and the step of
    ``state`` stay fresh. The EMA shadow starts from the release's weights, or
    the checkpoint's shadow. Returns the source's step."""
    if is_release_weights_dir(path):
        tree, _, meta = load_release_weights(path)
        model.load_state_dict(state_dict_from_release(tree, model, use_ema=True))
        source_ema, step = None, meta.get("step")
    else:
        src = CheckpointManager(path, None)
        template = init_train_state(src.load_config() or config, device=device)[2]
        restored = src.restore(template)
        torch._foreach_copy_([state.params[k] for k in state.params],
                             [restored.params[k] for k in state.params])
        for k, v in restored.model_buffers().items():
            state.constants["model." + k].copy_(v)
        source_ema, step = restored.ema_params, restored.step
    if state.ema_params is not None:
        source = source_ema if source_ema is not None else state.params
        torch._foreach_copy_([state.ema_params[k] for k in state.ema_params],
                             [source[k] for k in state.ema_params])
    return step


def run_loop(train_step, state: TrainState, batch_for: Callable[[int], torch.Tensor],
             noise_for: Callable[[int], torch.Generator], *, steps: int,
             writer: MetricsWriter, conditional: bool) -> Tuple[TrainState, List[float]]:
    """Micro-steps from ``state.step`` up to ``steps``: step ``s`` trains on
    ``batch_for(s)`` with the draws of ``noise_for(s)``. A row of ``writer``
    every ``LOG_EVERY`` steps and at the last, with the conditional loss's
    parts. Returns the state and the logged losses."""
    losses = []
    t_start = time.perf_counter()
    for step in range(state.step, steps):
        state, metrics = train_step(state, batch_for(step), noise_for(step))
        if step % LOG_EVERY == 0 or step == steps - 1:
            loss = float(metrics["train_loss"])  # waits for the step
            losses.append(loss)
            row = {"train_loss": loss, "grad_norm": float(metrics["grad_norm"])}
            if conditional:
                row["flow_loss"] = float(metrics["flow_loss"])
                row["reconstruct_loss"] = float(metrics["reconstruct_loss"])
            writer.write(step, row)
            if step % 100 == 0:
                print(f"step {step}: loss {loss:.4f} "
                      f"({time.perf_counter() - t_start:.0f}s elapsed)", flush=True)
    return state, losses


def held_out_scenario(shape: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The conditional demo's truth ``[X, Y, Z]`` (seed 999) and its observation
    mask, drawn on the host."""
    true = synthetic_geology_batch(torch.Generator().manual_seed(TRUTH_SEED), 1, shape)[0]
    return true, observation_mask(true)


def observation_mask(true: torch.Tensor) -> torch.Tensor:
    """The combined borehole and surface mask of ``true [X, Y, Z]`` (a CPU
    tensor) from a host generator seeded with 998."""
    return make_combined_mask(torch.Generator().manual_seed(MASK_SEED), true[None])[0]


def _sample_conditional(model, table, config, out: str, n_frames: int, dev) -> tuple:
    true, mask = held_out_scenario(config.data.shape)
    atb = build_atb(true.to(dev), mask.to(dev), table)
    ic = config.inference
    result = sample_conditional(
        model, table, atb, n_samples=4, batch_size=4, seed=ENSEMBLE_SEED, device=dev,
        t0=ic.t0, tf=ic.tf, n_frames=n_frames, substeps=ic.substeps, method="rk4",
        verbose=False)
    dec = result.decoded - 1
    np.save(os.path.join(out, "true_model.npy"), true.numpy().astype(np.int8))
    for i in range(dec.shape[0]):
        np.save(os.path.join(out, f"sol_{i}.npy"), dec[i].astype(np.int8))
    m, t = mask.numpy(), true.numpy()
    obs_acc = float(((dec == t[None]) * m[None]).sum() / max(m.sum() * dec.shape[0], 1))
    return result, {"observed_voxel_accuracy": round(obs_acc, 3),
                    "ensemble_agreement": round(float((dec[0] == dec[1]).mean()), 3)}


def _sample_unconditional(model, table, config, out: str, n_frames: int, dev) -> tuple:
    big = config.data.shape[0] > 64
    result = sample_unconditional(
        model, table, n_samples=2 if big else 8, batch_size=1 if big else 8,
        data_shape=config.data.shape, embedding_dim=config.data.embedding_dim, seed=100,
        device=dev, t0=0.001, tf=1.0, n_frames=n_frames, substeps=2, method="rk4",
        with_prominence=True, verbose=False,
        # above 64³ a bf16 state and a host loop over the frames, as the JAX tool
        state_dtype=torch.bfloat16 if big else torch.float32, frame_dispatch=big)
    dec = result.decoded - 1
    for i in range(min(4, dec.shape[0])):
        np.save(os.path.join(out, f"sample_{i}.npy"), dec[i].astype(np.int8))
    return result, {"air_frac_top": round(float((dec[..., -8:] == -1).mean()), 3),
                    "air_frac_bottom": round(float((dec[..., :8] == -1).mean()), 3),
                    "prominence_mean": round(float(result.prominence.mean()), 4)}


def save_slices(volume: np.ndarray, path: str) -> None:
    """The slices picture of ``volume``; skipped with a printed line where
    matplotlib is absent (the card's machine has none)."""
    try:
        plot_2d_slices(volume, save_path=path)
    except ImportError as exc:
        print(f"picture skipped ({exc})")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_arguments(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    config = demo_config(args)

    model, tx, state = init_train_state(config, device=dev)
    if args.init_from:
        src_step = warm_start(model, state, config, args.init_from, dev)
        print(f"warm-started from {args.init_from} (step {src_step})", flush=True)
    train_step = make_train_step(model, tx, config)
    writer = MetricsWriter(args.out)
    mgr = CheckpointManager(os.path.join(args.out, "ckpt"), config)
    if args.resume and mgr.latest_step() is not None:
        state = mgr.restore(state)
        print(f"resumed from step {state.step}", flush=True)

    def batch_for(step: int) -> torch.Tensor:
        return synthetic_geology_batch(generator(dev, DEMO_SEED, step), args.batch_size,
                                       config.data.shape)

    t_start = time.perf_counter()
    state, losses = run_loop(
        train_step, state, batch_for, lambda step: generator(dev, DEMO_SEED, NOISE_STREAM, step),
        steps=args.steps, writer=writer, conditional=args.conditional)
    writer.close()
    elapsed = time.perf_counter() - t_start
    if losses:  # nothing to save on a rerun at or past --steps (sampling only)
        mgr.save(args.steps, state, metrics={"train_loss": losses[-1]})

    # sample from the trained weights: the EMA shadow where there is one
    if state.ema_params is not None:
        model.load_state_dict(state.model_state_dict(use_ema=True))
    table = state.constants["embedding"]
    summary = {
        "conditional": args.conditional,
        "steps": args.steps,
        "batch": args.batch_size,
        "accum": args.accum,
        "elapsed_s": round(elapsed, 1),
        "loss_first": round(losses[0], 4) if losses else None,
        "loss_last": round(float(np.mean(losses[-5:])), 4) if losses else None,
    }
    sample = _sample_conditional if args.conditional else _sample_unconditional
    n_frames = args.n_frames or (config.inference.n_frames if args.conditional else 16)
    result, stats = sample(model, table, config, args.out, n_frames, dev)
    summary.update(stats)
    save_slices(result.decoded[0] - 1, os.path.join(args.out, "sample_0_slices.png"))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
