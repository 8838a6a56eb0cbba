"""Unconditional 64³ geological generation: the train and inference CLI.

    python -m flowtrain_stochastic_interpolation_torch.apps.unconditional \
        --mode inference --checkpoint-path artifacts/weights/uncond_demo_64

Port of ``apps/unconditional.py`` with its flags (``--mode train/inference/
both``, ``--n-samples``, ``--batch-size``, ``--seed``, ``--steps``,
``--checkpoint-path``, ``--save-images``, ``--save-trajectories``,
``--root-dir``, ``--preset``, ``--pretrain-smoke``) and outputs:
``samples/<name>/decoded_s{seed}_{i}.npy`` as int8 with air = -1, the
``samples/min`` line, metrics, images and checkpoints under ``--root-dir``.

``--train-devices`` and ``--infer-device`` take ``cuda`` (the default) or
``cpu``; without a card, ``cuda`` raises. Weights resolve from an explicit
``--checkpoint-path`` (a release directory such as
``artifacts/weights/uncond_demo_64``, or a checkpoint directory of this
port), then the run's own checkpoint directory, then a seeded fresh init
with a warning. Not ported: the Lightning ``.ckpt`` conversion and the
download of the published weights, and ``--adaptive`` (dopri5); asking for
them raises. Importing this module runs nothing.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.config import tiny_test, unconditional_64
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.inference import SampleResult, sample_unconditional
from flowtrain_stochastic_interpolation_torch.models.persistence import (
    is_release_weights_dir,
    load_release_weights,
    state_dict_from_release,
)
from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_torch.train.callbacks import InferenceCallback
from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager
from flowtrain_stochastic_interpolation_torch.train.loop import (
    build_model,
    init_train_state,
    train,
)
from flowtrain_stochastic_interpolation_torch.utils.logging import MetricsWriter

DEVICES = ("cuda", "cpu")


def setup_directories(root_dir: str, name: str) -> dict:
    dirs = {
        "checkpoint_dir": os.path.join(root_dir, "saved_models", name),
        "photo_dir": os.path.join(root_dir, "images", name),
        "samples_dir": os.path.join(root_dir, "samples", name),
        "metrics_dir": os.path.join(root_dir, "metrics", name),
    }
    for p in dirs.values():
        os.makedirs(p, exist_ok=True)
    return dirs


def load_variables(config, checkpoint_path: Optional[str], dirs: dict, use_ema: bool = True,
                   device=None):
    """``(model, table)``: the model in eval mode holding weights resolved from
    a release directory | a checkpoint directory of the port | a fresh init."""
    dev = resolve_device(device)
    if checkpoint_path and checkpoint_path.endswith(".ckpt"):
        raise NotImplementedError(
            "the Lightning .ckpt conversion is not ported (ROADMAP Queue 1 item 14); "
            "pass a release directory or a checkpoint directory of this port"
        )
    ckpt_dir = checkpoint_path or dirs["checkpoint_dir"]
    if is_release_weights_dir(ckpt_dir):
        tree, _, meta = load_release_weights(ckpt_dir)
        model = build_model(config, device=dev)
        model.load_state_dict(state_dict_from_release(tree, model, use_ema=use_ema))
        table = torch.from_numpy(
            simplex_embedding(config.data.num_categories, config.data.embedding_dim)).to(dev)
        print(f"loaded release weights step {meta.get('step')} from {ckpt_dir}")
        return model.eval(), table

    mgr = CheckpointManager(ckpt_dir, None)
    model, _, state = init_train_state(config, device=dev)
    if mgr.latest_step() is not None:
        state = mgr.restore(state)
        print(f"loaded checkpoint step {mgr.latest_step()} from {ckpt_dir}")
        if use_ema and state.ema_params is not None:
            model.load_state_dict(state.ema_params)
    else:
        print("WARNING: no checkpoint found — using random init")
    return model.eval(), state.constants["embedding"]


def run_inference(args, config, dirs) -> SampleResult:
    if args.adaptive:
        raise NotImplementedError("the adaptive dopri5 sampler is not ported "
                                  "(ROADMAP Queue 1 item 6)")
    dev = resolve_device(args.infer_device)
    model, table = load_variables(config, args.checkpoint_path, dirs, device=dev)
    ic = config.inference
    result = sample_unconditional(
        model, table,
        n_samples=args.n_samples,
        batch_size=args.batch_size,
        data_shape=config.data.shape,
        embedding_dim=config.data.embedding_dim,
        seed=args.seed,
        device=dev,
        t0=ic.t0, tf=ic.tf, n_frames=ic.n_frames,
        substeps=ic.substeps, method=ic.method,
        keep_trajectory=args.save_trajectories, with_prominence=True,
    )
    for i in range(result.decoded.shape[0]):
        # decoded rows are 0-based; -1 recovers the GeoGen air=-1 convention
        np.save(
            os.path.join(dirs["samples_dir"], f"decoded_s{args.seed}_{i}.npy"),
            result.decoded[i].astype(np.int8) - 1,
        )
        if result.trajectory is not None:
            np.save(
                os.path.join(dirs["samples_dir"], f"fullsol_s{args.seed}_{i}.npy"),
                result.trajectory[:, i],
            )
    if args.save_images:
        from flowtrain_stochastic_interpolation_torch.utils.plotting import plot_2d_slices

        for i in range(min(result.decoded.shape[0], 4)):
            plot_2d_slices(
                result.decoded[i] - 1,
                save_path=os.path.join(dirs["photo_dir"], f"cat_slices_{i}.png"),
            )
    total = sum(result.seconds_per_batch)
    print(f"Generated {args.n_samples} samples in {total:.2f}s "
          f"({args.n_samples / total * 60:.1f} samples/min)")
    return result


def parse_arguments(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(
        description="Train or sample the unconditional 3D geology model",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--mode", choices=["train", "inference", "both"], default="inference")
    p.add_argument("--n-samples", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--steps", type=int, default=None, help="cap training steps")
    p.add_argument("--checkpoint-path", type=str, default=None,
                   help="release-weights directory or checkpoint directory of this port")
    p.add_argument("--adaptive", action="store_true",
                   help="the adaptive dopri5 sampler (not ported: raises)")
    p.add_argument("--save-images", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--save-trajectories", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--root-dir", type=str, default=os.path.dirname(os.path.abspath(__file__)))
    p.add_argument("--preset", choices=["flagship", "tiny"], default="flagship",
                   help="tiny = 8^3 smoke config for CPU runs")
    p.add_argument("--train-devices", choices=DEVICES, default="cuda",
                   help="the device of --mode train and both (one card; no mesh)")
    p.add_argument("--infer-device", choices=DEVICES, default="cuda",
                   help="the device of --mode inference and both")
    p.add_argument("--pretrain-smoke", action=argparse.BooleanOptionalAction, default=True,
                   help="render one data batch and run one sampling pass before training")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns ``{"train": TrainResult or None, "inference":
    SampleResult or None}``."""
    args = parse_arguments(argv)
    config = unconditional_64() if args.preset == "flagship" else tiny_test()
    dirs = setup_directories(args.root_dir, config.name)
    print(f"mode={args.mode} train device={args.train_devices} "
          f"inference device={args.infer_device}")
    out = {"train": None, "inference": None}

    if args.mode in ("train", "both"):
        dev = resolve_device(args.train_devices)
        writer = MetricsWriter(dirs["metrics_dir"])
        callback = InferenceCallback(
            config, build_model(config, device=dev), dirs["photo_dir"],
            every_n_epochs=config.training.inference_every_epochs,
            writer=writer,
        )
        result = train(
            config, num_steps=args.steps, checkpoint_dir=dirs["checkpoint_dir"],
            writer=writer, callback=callback, pretrain_smoke=args.pretrain_smoke, device=dev,
        )
        writer.close()
        print(f"training: {result.steps_per_sec:.3f} steps/s, "
              f"final loss {result.history[-1]['train_loss']:.4f}")
        out["train"] = result

    if args.mode in ("inference", "both"):
        out["inference"] = run_inference(args, config, dirs)
    return out


if __name__ == "__main__":
    main()
