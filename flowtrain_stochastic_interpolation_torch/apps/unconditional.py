"""Unconditional 64³ geological generation: the train and inference CLI.

    python -m flowtrain_stochastic_interpolation_torch.apps.unconditional \
        --mode inference --checkpoint-path artifacts/weights/uncond_demo_64

Port of ``apps/unconditional.py`` with its flags (``--mode train/inference/
both``, ``--n-samples``, ``--batch-size``, ``--seed``, ``--steps``,
``--checkpoint-path``, ``--save-images``, ``--save-trajectories``,
``--root-dir``, ``--preset``, ``--pretrain-smoke``) and outputs:
``samples/<name>/decoded_s{seed}_{i}.npy`` as int8 with air = -1, the
``samples/min`` line, metrics, images and checkpoints under ``--root-dir``.

``--infer-device`` takes ``cuda`` (the default) or ``cpu``; without a card,
``cuda`` raises. ``--train-devices`` takes those two, ``auto`` (every visible
card) or a comma list of card indices, as the JAX app's ``resolve_devices``:
more than one card trains data-parallel, one NCCL rank per card
(:func:`parallel.launch.run_on_devices`); under torchrun or SLURM the ranks
join that job instead. Weights resolve from an explicit
``--checkpoint-path`` (a reference Lightning ``.ckpt``, a release directory
such as ``artifacts/weights/uncond_demo_64``, or a checkpoint directory of
this port), then the run's own checkpoint directory, then a seeded fresh init
with a warning. ``--adaptive`` samples with dopri5 at the config's ``atol``
and ``rtol``. Not ported: the download of the published weights. Importing
this module runs nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.config import tiny_test, unconditional_64
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.inference import SampleResult, sample_unconditional
from flowtrain_stochastic_interpolation_torch.models.persistence import (
    LIGHTNING_MODEL_KEYS,
    convert_lightning_module,
    is_release_weights_dir,
    load_lightning_checkpoint,
    load_release_weights,
    params_from_jax,
    state_dict_from_release,
)
from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_torch.parallel.distributed import is_primary
from flowtrain_stochastic_interpolation_torch.parallel.launch import (
    resolve_devices,
    run_on_devices,
)
from flowtrain_stochastic_interpolation_torch.train.callbacks import InferenceCallback
from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager
from flowtrain_stochastic_interpolation_torch.train.loop import (
    TrainResult,
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


def load_weights(config, path: Optional[str], use_ema: bool = True, device=None):
    """``(model, table)``: the model in eval mode holding the weights of ``path``
    (a reference Lightning ``.ckpt``, a release directory or a checkpoint
    directory of the port), or a seeded fresh init with a warning where
    ``path`` is None or holds no checkpoint. The model is ``config``'s,
    conditional or not."""
    dev = resolve_device(device)
    if path and path.endswith(".ckpt"):
        return _load_lightning(config, path, use_ema, dev)
    if path and is_release_weights_dir(path):
        tree, _, meta = load_release_weights(path)
        model = build_model(config, device=dev)
        model.load_state_dict(state_dict_from_release(tree, model, use_ema=use_ema))
        table = torch.from_numpy(
            simplex_embedding(config.data.num_categories, config.data.embedding_dim)).to(dev)
        print(f"loaded release weights step {meta.get('step')} from {path}")
        return model.eval(), table

    model, _, state = init_train_state(config, device=dev)
    mgr = CheckpointManager(path, None) if path else None
    if mgr is not None and mgr.latest_step() is not None:
        state = mgr.restore(state)
        print(f"loaded checkpoint step {mgr.latest_step()} from {path}")
        if use_ema and state.ema_params is not None:
            model.load_state_dict(state.model_state_dict(use_ema=True))
    else:
        print("WARNING: no checkpoint found — using random init")
    return model.eval(), state.constants["embedding"]


def _load_lightning(config, path: str, use_ema: bool, dev):
    """The model of a reference ``.ckpt`` and its embedding table. The model is
    ``config``'s with the options that the checkpoint's hyper-parameters set
    for the conversion (the time embedding, ``full_attn``, ``attn_enabled``), so
    that a checkpoint trained with RandomFourier time gets its frozen features
    as buffers."""
    ckpt = load_lightning_checkpoint(path)
    converted = convert_lightning_module(ckpt, conditional=config.model.conditional,
                                         use_ema=use_ema)
    options = {k: ckpt["hparams"][k] for k in LIGHTNING_MODEL_KEYS if k in ckpt["hparams"]}
    if options.get("full_attn") is not None:
        options["full_attn"] = tuple(options["full_attn"])
    config = dataclasses.replace(config, model=dataclasses.replace(config.model, **options))
    model = build_model(config, device=dev)
    model.load_state_dict(params_from_jax(
        {"params": converted["params"], "constants": converted["constants"]}, model))
    table = torch.from_numpy(converted["embedding"]).to(dev)
    print(f"loaded Lightning checkpoint {path} (EMA {use_ema and bool(ckpt['ema_shadow'])}; "
          f"model options {options})")
    return model.eval(), table


def load_variables(config, checkpoint_path: Optional[str], dirs: dict, use_ema: bool = True,
                   device=None):
    """``(model, table)`` from ``--checkpoint-path``, else the run's own checkpoint
    directory (:func:`load_weights`)."""
    return load_weights(config, checkpoint_path or dirs["checkpoint_dir"], use_ema, device)


def run_inference(args, config, dirs) -> SampleResult:
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
        adaptive=args.adaptive, atol=ic.atol, rtol=ic.rtol,
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


def _train_job(dev: torch.device, args, config, dirs) -> TrainResult:
    """Training on ``dev``, as one rank of a job or alone; the primary rank owns
    the metrics, the callback and the checkpoints. A rank of several hands back
    its result without the state."""
    primary = is_primary()
    writer = MetricsWriter(dirs["metrics_dir"]) if primary else None
    callback = InferenceCallback(
        config, build_model(config, device=dev), dirs["photo_dir"],
        every_n_epochs=config.training.inference_every_epochs, writer=writer,
    ) if primary else None
    result = train(
        config, num_steps=args.steps, checkpoint_dir=dirs["checkpoint_dir"],
        writer=writer, callback=callback, pretrain_smoke=args.pretrain_smoke, device=dev,
    )
    if writer:
        writer.close()
    if torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
        result = dataclasses.replace(result, state=None)
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
                   help="reference .ckpt, release-weights directory or checkpoint "
                        "directory of this port")
    p.add_argument("--adaptive", action="store_true",
                   help="sample with adaptive dopri5 at the config's atol / rtol")
    p.add_argument("--save-images", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--save-trajectories", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--root-dir", type=str, default=os.path.dirname(os.path.abspath(__file__)))
    p.add_argument("--preset", choices=["flagship", "tiny"], default="flagship",
                   help="tiny = 8^3 smoke config for CPU runs")
    p.add_argument("--train-devices", default="cuda",
                   help="the devices of --mode train and both: cuda, cpu, auto (every "
                        "visible card, one rank each) or a comma list of card indices")
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
        result = run_on_devices(_train_job, resolve_devices(args.train_devices),
                                (args, config, dirs))
        print(f"training: {result.steps_per_sec:.3f} steps/s, "
              f"final loss {result.history[-1]['train_loss']:.4f}")
        out["train"] = result

    if args.mode in ("inference", "both"):
        out["inference"] = run_inference(args, config, dirs)
    return out


if __name__ == "__main__":
    main()
