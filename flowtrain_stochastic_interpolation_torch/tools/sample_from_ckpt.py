"""Generate samples from trained weights: a release directory or a checkpoint.

Port of the root ``tools/sample_from_ckpt.py``. The weights come from a
release directory (``weights.msgpack``; the port's ``tools/export_weights.py``
writes one, as the JAX package does) or a checkpoint directory of the port;
``--ema`` samples with the EMA shadow where there is one, ``--no-folded``
sets ``fused_folded_attn=False`` (the einsum linear attention in place of K1
and K2). Every sampler flag maps onto ``inference.sample_unconditional``
(``--donate-x0`` does nothing in eager PyTorch, as ``make_sampler`` says).
It writes ``sample_*.npy`` (the first four, int8, air = -1) and the slices
picture, and prints the JAX tool's JSON keys.

    python -m flowtrain_stochastic_interpolation_torch.tools.sample_from_ckpt \\
        --ckpt artifacts/weights/uncond_demo_64 --ema [--shape 128] \\
        [--batch-size 1 --state-dtype bfloat16 --frame-dispatch] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.inference import sample_unconditional
from flowtrain_stochastic_interpolation_torch.models.persistence import (
    is_release_weights_dir,
    load_release_weights,
    state_dict_from_release,
)
from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_torch.tools.train_demo import save_slices
from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager
from flowtrain_stochastic_interpolation_torch.train.loop import build_model, init_train_state

ROOT = Path(__file__).resolve().parents[2]


def parse_arguments(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", default=str(ROOT / "artifacts" / "torch" / "train_demo" / "ckpt"))
    p.add_argument("--out", default=str(ROOT / "artifacts" / "torch" / "train_demo"))
    p.add_argument("--n-samples", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--shape", type=int, default=None,
                   help="sampling resolution override (e.g. 128; any /16-divisible size)")
    p.add_argument("--ema", action="store_true", help="sample from EMA params")
    p.add_argument("--no-folded", action="store_true",
                   help="the einsum linear attention in place of the folded kernels")
    p.add_argument("--method", default="rk4",
                   choices=["euler", "heun", "midpoint", "rk4", "rk4_tableau", "sde"],
                   help="'sde' runs Euler-Maruyama with the score recovered from the velocity")
    p.add_argument("--sde-epsilon", type=float, default=0.5,
                   help="diffusion strength for --method sde")
    p.add_argument("--sde-eps-schedule", default="linear_decay",
                   choices=["constant", "linear_decay"])
    p.add_argument("--substeps", type=int, default=2)
    p.add_argument("--state-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="dtype of the integrated state")
    p.add_argument("--donate-x0", action="store_true",
                   help="kept for the JAX tool's command line; eager PyTorch donates nothing")
    p.add_argument("--frame-dispatch", action="store_true",
                   help="a host loop over the saved frames")
    p.add_argument("--no-prominence", action="store_true", help="skip the prominence map")
    p.add_argument("--n-frames", type=int, default=16, help="the sampler's frames")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def _without_folded(config):
    return dataclasses.replace(config, model=dataclasses.replace(config.model,
                                                                 fused_folded_attn=False))


def load(path: str, ema: bool, no_folded: bool, dev):
    """``(model, table, config)`` from a release directory or a checkpoint directory."""
    if is_release_weights_dir(path):
        tree, config, meta = load_release_weights(path)
        if config is None:
            raise FileNotFoundError(f"{path} (a release-weights dir) has no config.json")
        config = _without_folded(config) if no_folded else config
        model = build_model(config, device=dev)
        model.load_state_dict(state_dict_from_release(tree, model, use_ema=ema))
        table = torch.from_numpy(
            simplex_embedding(config.data.num_categories, config.data.embedding_dim)).to(dev)
        print(f"loaded release weights (step {meta.get('step')})")
        return model, table, config
    mgr = CheckpointManager(path, None)
    config = mgr.load_config()
    if config is None:
        raise FileNotFoundError(f"{path} (a checkpoint dir) has no config.json")
    config = _without_folded(config) if no_folded else config
    model, _, state = init_train_state(config, device=dev)
    state = mgr.restore(state)
    print(f"restored step {state.step}")
    if ema and state.ema_params is not None:
        model.load_state_dict(state.model_state_dict(use_ema=True))
    return model, state.constants["embedding"], config


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_arguments(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    model, table, config = load(args.ckpt, args.ema, args.no_folded, dev)
    shape = (args.shape,) * 3 if args.shape else tuple(config.data.shape)
    result = sample_unconditional(
        model, table, n_samples=args.n_samples, batch_size=args.batch_size, data_shape=shape,
        embedding_dim=config.data.embedding_dim, seed=100, device=dev, t0=0.001, tf=1.0,
        n_frames=args.n_frames, substeps=args.substeps, method=args.method,
        with_prominence=not args.no_prominence, verbose=True, donate_x0=args.donate_x0,
        frame_dispatch=args.frame_dispatch, sde_epsilon=args.sde_epsilon,
        sde_eps_schedule=args.sde_eps_schedule,
        state_dtype=torch.bfloat16 if args.state_dtype == "bfloat16" else torch.float32)
    dec = result.decoded - 1
    for i in range(min(4, dec.shape[0])):
        np.save(os.path.join(args.out, f"sample_{i}.npy"), dec[i].astype(np.int8))
    save_slices(dec[0], os.path.join(args.out, "sample_0_slices.png"))
    summary = {
        "air_frac_top": round(float((dec[..., -8:] == -1).mean()), 3),
        "air_frac_bottom": round(float((dec[..., :8] == -1).mean()), 3),
        "n_categories_used": int(len(np.unique(dec))),
        "prominence_mean": (round(float(result.prominence.mean()), 4)
                            if result.prominence is not None else None),
        "seconds_per_batch": [round(s, 2) for s in result.seconds_per_batch],
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
