"""The 2-D image toy: UNet2D flow matching on images, then a sample grid.

    python -m flowtrain_stochastic_interpolation_torch.apps.toy2d_images --device cpu --steps 60 --size 16

Port of ``apps/toy2d_images.py``: trains :class:`models.unet.UNet2D` (dim 16,
mults (1, 2, 4) at 32², (1, 2) at 16² and under, 2 heads, LearnedFourier time)
with Adam (2e-3) at batch 64 on the relative flow MSE of the one-sided linear
interpolant, on FashionMNIST where torchvision can read it at 32², else on
:func:`data.toy.synthetic_images`; then samples a grid of 16 by RK4 over 9
frames × 4 substeps from t = 1e-3 to 1 - 1e-3, and writes the data and sample
grids, the loss curve, ``samples.npy`` and ``metrics.json`` under ``--out``.
:func:`train_and_sample` does it all, and draws only with ``out``.
``--device`` is ``cuda`` (the default) or ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.apps.toy2d import (
    T_MAX,
    T_MIN,
    relative_flow_loss,
)
from flowtrain_stochastic_interpolation_torch.data.toy import get_fashion_mnist, synthetic_images
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant
from flowtrain_stochastic_interpolation_torch.models.unet import UNet2D
from flowtrain_stochastic_interpolation_torch.solvers import solve_ode_final
from flowtrain_stochastic_interpolation_torch.utils.rng import generator as folded_generator

GRID_FRAMES, GRID_SUBSTEPS = 9, 4


def build_model(dim: int, size: int, device=None) -> UNet2D:
    """The toy's UNet2D, seeded by the caller (``reset_parameters``)."""
    return UNet2D(dim=dim, dim_mults=(1, 2) if size <= 16 else (1, 2, 4), data_channels=1,
                  dropout=0.0, time_resolution=64, time_bandwidth=100.0,
                  time_learned_emb=True, attn_dim_head=max(8, dim // 2), attn_heads=2,
                  dtype=None, device=device)


def train_and_sample(steps: int = 800, size: int = 32, dim: int = 16, batch_size: int = 64,
                     lr: float = 2e-3, seed: int = 0, out: Optional[str] = None,
                     use_mnist: bool = True, n_grid: int = 16, verbose: bool = True,
                     device=None) -> dict:
    """``{"source", "loss_first", "loss_last", "train_seconds", "sample_minmax",
    "losses", "samples"}``: ``losses`` every 25 steps and the last, ``samples``
    the ``[n_grid, size, size, 1]`` grid (numpy)."""
    dev = resolve_device(device)
    interp = LinearInterpolant(one_sided=True)
    model = build_model(dim, size, dev)
    model.reset_parameters(folded_generator(dev, seed, 0))

    mnist = get_fashion_mnist() if (use_mnist and size == 32) else None
    if mnist is not None:
        data = torch.from_numpy(mnist).to(dev)

        def draw(gen, n):
            return data[torch.randint(0, data.shape[0], (n,), generator=gen, device=dev)]

        source = "fashion_mnist"
    else:
        draw = lambda gen, n: synthetic_images(gen, n, size)
        source = "synthetic_images"

    opt = torch.optim.Adam(model.parameters(), lr=lr)
    gen = folded_generator(dev, seed, 1)
    model.train()
    losses = []
    start = time.perf_counter()
    for i in range(steps):
        x1 = draw(gen, batch_size)
        x0 = torch.randn(x1.shape, generator=gen, device=dev)
        t = T_MIN + torch.rand((batch_size,), generator=gen, device=dev) * (T_MAX - T_MIN)
        loss = relative_flow_loss(model, interp, x0, x1, t)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 25 == 0 or i == steps - 1:
            losses.append((i, float(loss.detach())))
            if verbose:
                print(f"step {i}: loss {losses[-1][1]:.4f}", flush=True)
    train_s = time.perf_counter() - start
    model.eval()

    x0 = torch.randn((n_grid, size, size, 1), generator=folded_generator(dev, seed, 10_000),
                     device=dev)
    with torch.inference_mode():
        samples = solve_ode_final(model, x0, t0=T_MIN, tf=T_MAX, n_frames=GRID_FRAMES,
                                  substeps=GRID_SUBSTEPS, method="rk4").cpu().numpy()
    result = {
        "source": source,
        "loss_first": losses[0][1],
        "loss_last": losses[-1][1],
        "train_seconds": round(train_s, 1),
        "sample_minmax": [float(samples.min()), float(samples.max())],
    }
    if out:
        os.makedirs(out, exist_ok=True)
        data_grid = draw(folded_generator(dev, seed, 20_000), n_grid).cpu().numpy()
        _save_grid(data_grid, os.path.join(out, "data_grid.png"))
        _save_grid(samples, os.path.join(out, "sample_grid.png"))
        _save_losses(losses, os.path.join(out, "loss_curve.png"))
        np.save(os.path.join(out, "samples.npy"), samples.astype(np.float16))
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump(result, f, indent=2)
    return dict(result, losses=losses, samples=samples)


def _save_grid(imgs: np.ndarray, path: str, cols: int = 4) -> None:
    from flowtrain_stochastic_interpolation_torch.utils.plotting import _mpl

    plt = _mpl()
    n = imgs.shape[0]
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows))
    for i, ax in enumerate(np.atleast_1d(axes).ravel()):
        ax.axis("off")
        if i < n:
            ax.imshow(imgs[i, ..., 0], cmap="gray", vmin=-1, vmax=1)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _save_losses(losses, path: str) -> None:
    from flowtrain_stochastic_interpolation_torch.utils.plotting import _mpl

    plt = _mpl()
    xs, ys = zip(*losses)
    fig, ax = plt.subplots(figsize=(5, 3))
    ax.plot(xs, ys)
    ax.set_xlabel("step")
    ax.set_ylabel("relative flow MSE")
    ax.set_yscale("log")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description="2-D image toy: UNet2D flow matching")
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--no-mnist", action="store_true",
                   help="the synthetic images even where torchvision can read FashionMNIST")
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "toy2d_images"))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    result = train_and_sample(steps=args.steps, size=args.size, dim=args.dim,
                              batch_size=args.batch_size, lr=args.lr, out=args.out,
                              use_mnist=not args.no_mnist, device=args.device)
    print(json.dumps({k: v for k, v in result.items() if k not in ("losses", "samples")}))
    return result


if __name__ == "__main__":
    main()
