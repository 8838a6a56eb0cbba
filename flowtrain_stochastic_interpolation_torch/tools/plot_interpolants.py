"""The interpolant schedules as a 2 × 5 figure, for comparison by eye.

Port of the root ``tools/plot_interpolants.py``: alpha, beta and gamma (top
row) and their derivatives (bottom row) of the five interpolants of
:mod:`interpolants` (linear and trigonometric one-sided, encoder-decoder,
SBDM, mirror) on 100 times in [0, 1], computed on the card unless
``--device cpu``. The numbers are :func:`interpolant_curves`'; the picture
needs matplotlib, and is skipped with a printed line without it.

    python -m flowtrain_stochastic_interpolation_torch.tools.plot_interpolants \\
        [out.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.interpolants import (
    EncDecInterpolant,
    LinearInterpolant,
    MirrorInterpolant,
    SBDMInterpolant,
    TrigInterpolant,
)

ROOT = Path(__file__).resolve().parents[2]
ROWS = (("alpha", "beta", "gamma"), ("alpha_dot", "beta_dot", "gamma_dot"))


def interpolants() -> list:
    return [LinearInterpolant(one_sided=True), TrigInterpolant(one_sided=True),
            EncDecInterpolant(), SBDMInterpolant(), MirrorInterpolant()]


def interpolant_curves(device, n: int = 100) -> Dict[str, Dict[str, np.ndarray]]:
    """``{"t": {"t": times}, <class name>: {function name: values}}`` on ``n``
    times from 0 to 1 (f32, as ``jnp.linspace``)."""
    t = torch.linspace(0.0, 1.0, n, device=device)
    curves = {"t": {"t": t.cpu().numpy()}}
    for interp in interpolants():
        curves[type(interp).__name__] = {
            name: np.asarray(torch.as_tensor(getattr(interp, name)(t)).expand(n).cpu())
            for row in ROWS for name in row}
    return curves


def plot(curves: Dict[str, Dict[str, np.ndarray]], out_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = curves["t"]["t"]
    names = [name for name in curves if name != "t"]
    fig, axs = plt.subplots(2, len(names), figsize=(18, 7))
    for i, name in enumerate(names):
        for row, fns in enumerate(ROWS):
            for fn in fns:
                axs[row, i].plot(t, curves[name][fn], label=fn.split("_")[0])
            axs[row, i].legend(fontsize=7)
            axs[row, i].set_title(name, fontsize=9)
            axs[row, i].set_ylim(-4, 4)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, np.ndarray]]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out", nargs="?", default=str(ROOT / "artifacts" / "torch" / "interpolants.png"))
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    curves = interpolant_curves(resolve_device(args.device))
    try:
        plot(curves, args.out)
    except ImportError as exc:
        print(f"picture skipped ({exc})")
        return curves
    print(f"wrote {args.out}")
    return curves


if __name__ == "__main__":
    main()
