"""Build (and run) ``docs/inference_demo_torch.ipynb``, the port's inference demo.

Port of the root ``tools/build_notebook.py``, with the same sections on the
port: conditioning scenarios, model weights, conditional ensembles, vote
probabilities and entropy, the views. It runs the tiny preset, whose weights
the notebook quick-trains (the published checkpoints need a download), so it
executes anywhere in a couple of minutes; the flagship is the same code with
``conditional_64()`` and converted reference weights. ``--device`` is written
into the notebook's first cell (the card unless ``--device cpu``); executing
needs ``nbclient`` and a ``python3`` kernel, ``--skip-exec`` writes the cells
only.

    python -m flowtrain_stochastic_interpolation_torch.tools.build_notebook \\
        [--skip-exec] [--device cpu] [--out docs/inference_demo_torch.ipynb]
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from flowtrain_stochastic_interpolation_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "docs" / "inference_demo_torch.ipynb"
P = "flowtrain_stochastic_interpolation_torch"

CELLS: List[Tuple[str, str]] = [
    ("markdown", f"""
# Conditional inference demo — `{P}`

The PyTorch port's counterpart of `docs/inference_demo.ipynb` (itself the
executable equivalent of the reference's
`project/geodata-3d-conditional/inference_demo.ipynb`). It reconstructs 3D
geology from sparse borehole and surface observations with a conditional
stochastic-interpolation UNet, then analyses the ensemble: per-voxel category
probabilities, entropy (uncertainty), the most probable model.

| Reference cell | Here |
|---|---|
| 6 — generate conditioning data | §2 |
| 9 — download checkpoint + EMA load | §1 (reference weights from a local file; a quick-trained tiny stand-in here) |
| 12 — populate 9 samples/scenario | §3 |
| 21 — `vote_probabilities` ensemble | §4 |
| 23 — probability / voxel-grid views | §5 |

It runs the **tiny preset** (8³, about 2 minutes on a CPU) so that it executes
anywhere; the flagship 64³ flow is the same code with
`config = conditional_64()` and the reference's converted weights (§1).
"""),
    ("code", f"""
# §0 setup: the device is written here by tools/build_notebook.py --device
DEVICE = {{device!r}}

import os, sys
sys.path.insert(0, os.path.abspath(".."))  # the repo root when run from docs/

import numpy as np
import torch
import matplotlib.pyplot as plt

from {P}.config import tiny_test, conditional_64
from {P}.data.synthetic import synthetic_geology_batch
from {P}.inference import build_atb, sample_conditional
from {P}.ops.masks import make_combined_mask
from {P}.ops import ensemble
from {P}.train.loop import init_train_state
from {P}.train.steps import make_train_step
from {P}.utils.rng import generator

config = tiny_test(conditional=True)
config.data.shape, config.model.dim
"""),
    ("markdown", f"""
## §1 — model weights (reference cell 9)

The reference downloads `conditional-weights.ckpt` from its GitHub release
and applies the EMA shadow. The port reads such a file from a local path
(there is no download here):

```python
from {P}.models.persistence import (
    convert_lightning_module, load_lightning_checkpoint, params_from_jax)
from {P}.train.loop import build_model
ckpt = load_lightning_checkpoint("conditional-weights.ckpt")  # a local copy
tree = convert_lightning_module(ckpt, conditional=True, use_ema=True)
model = build_model(conditional_64(), device=DEVICE)
model.load_state_dict(params_from_jax(
    {{"params": tree["params"], "constants": tree["constants"]}}, model))
table = torch.from_numpy(tree["embedding"]).to(DEVICE)
```

(`apps.unconditional.load_weights(config, path)` does the same for any app.)
Without the file, we quick-train the tiny conditional model on the synthetic
generator for a few hundred steps: enough for the ensemble mechanics below to
be meaningful.
"""),
    ("code", """
# §1 — quick-train the tiny conditional model (stand-in for the reference weights)
TRAIN_STEPS = 300
model, tx, state = init_train_state(config, device=DEVICE)
train_step = make_train_step(model, tx, config)
losses = []
for step in range(TRAIN_STEPS):
    batch = synthetic_geology_batch(generator(DEVICE, 0, step), config.data.batch_size,
                                    config.data.shape)
    state, metrics = train_step(state, batch, generator(DEVICE, 1, step))
    if step % 20 == 0:
        losses.append((step, float(metrics["train_loss"])))
losses[:3], losses[-3:]
"""),
    ("code", """
# the EMA weights for inference (the reference applies the EMA at the end of training)
if state.ema_params is not None:
    model.load_state_dict(state.model_state_dict(use_ema=True))
table = state.constants["embedding"]
plt.figure(figsize=(4, 2.5))
plt.plot(*zip(*losses)); plt.xlabel("step"); plt.ylabel("train loss")
plt.title("tiny conditional training")
plt.tight_layout(); plt.show()
"""),
    ("markdown", """
## §2 — conditioning data (reference cell 6, `create_cond_data`)

A held-out "true" volume plays the subsurface; `make_combined_mask` builds
the observation operator A: jittered borehole columns ∪ the surface layer
(air voxels and one voxel below). `ATb = embed(true) * mask` is what the
network sees.
"""),
    ("code", """
n_scenarios = 2
true_models, masks, atbs = [], [], []
for s in range(n_scenarios):
    true = synthetic_geology_batch(generator(DEVICE, 1000 + s), 1, config.data.shape)[0]
    mask = make_combined_mask(generator(DEVICE, 2000 + s), true[None])[0]
    atbs.append(build_atb(true, mask, table))
    true_models.append(true.cpu().numpy()); masks.append(mask.cpu().numpy())
obs_frac = [m.mean() for m in masks]
print("observed voxel fraction per scenario:", [round(float(f), 3) for f in obs_frac])
"""),
    ("code", """
# a scenario: true model against the observations (z-slices)
s = 0
fig, axes = plt.subplots(2, 4, figsize=(10, 5))
zs = np.linspace(0, config.data.shape[2] - 1, 4).astype(int)
for j, z in enumerate(zs):
    axes[0, j].imshow(true_models[s][:, :, z], cmap="tab20", vmin=-1, vmax=13)
    axes[0, j].set_title(f"true z={z}"); axes[0, j].axis("off")
    obs = np.where(masks[s][:, :, z] > 0, true_models[s][:, :, z], np.nan)
    axes[1, j].imshow(obs, cmap="tab20", vmin=-1, vmax=13)
    axes[1, j].set_title(f"observed z={z}"); axes[1, j].axis("off")
plt.tight_layout(); plt.show()
"""),
    ("markdown", """
## §3 — populate conditional ensembles (reference cell 12)

For each scenario, draw an ensemble of reconstructions by integrating the
learned conditional velocity field from different noise seeds
(`seed = 42 + batch`, as the reference).
"""),
    ("code", """
n_samples = 6
solutions = []  # per scenario: [S, X, Y, Z] decoded categorical volumes
for s in range(n_scenarios):
    result = sample_conditional(
        model, table, atbs[s], n_samples=n_samples, batch_size=3, seed=42, device=DEVICE,
        t0=config.inference.t0, tf=config.inference.tf,
        n_frames=config.inference.n_frames, substeps=config.inference.substeps,
        method=config.inference.method, verbose=False,
    )
    solutions.append(result.decoded - 1)  # back to the air = -1 convention
solutions[0].shape
"""),
    ("markdown", """
## §4 — ensemble analysis (reference cell 21, `vote_probabilities`)

One-hot vote over the ensemble → per-voxel category probabilities → Shannon
entropy (uncertainty) and the most probable model.
"""),
    ("code", """
probs = [ensemble.vote_probabilities(torch.from_numpy(sol), config.data.num_categories)
         for sol in solutions]
ent = [ensemble.entropy(p).numpy() for p in probs]
mpm = [ensemble.most_probable_model(p).numpy() for p in probs]
obs_acc = [float(((mpm[s] == true_models[s]) * masks[s]).sum() / max(masks[s].sum(), 1))
           for s in range(n_scenarios)]
print("observed-voxel accuracy of most-probable model:", [round(a, 3) for a in obs_acc])
print("mean entropy:", [round(float(e.mean()), 3) for e in ent])
"""),
    ("markdown", """
## §5 — probability and uncertainty views (reference cell 23)

Reconstruction against truth, and where the ensemble is uncertain. (The
reference's interactive PyVista voxel grids live in the port's
`apps/paper_figures.py` and `apps/tensorprocessor.py`.)
"""),
    ("code", """
s = 0
z = config.data.shape[2] // 2
fig, axes = plt.subplots(1, 4, figsize=(12, 3))
for ax, (img, title, kw) in zip(axes, [
    (true_models[s][:, :, z], "true", dict(cmap="tab20", vmin=-1, vmax=13)),
    (mpm[s][:, :, z], "most probable", dict(cmap="tab20", vmin=-1, vmax=13)),
    (ent[s][:, :, z], "entropy", dict(cmap="magma")),
    (solutions[s][0][:, :, z], "sample 0", dict(cmap="tab20", vmin=-1, vmax=13)),
]):
    im = ax.imshow(img, **kw); ax.set_title(title); ax.axis("off")
plt.tight_layout(); plt.show()
"""),
    ("markdown", f"""
---
**Flagship path.** Replace the tiny preset with the published recipe:

```python
config = conditional_64()  # dim 48, mults (1,2,2,3,4), 64³
# the model and table of §1's reference-weights block, on DEVICE = "cuda"
```

Everything from §2 on is unchanged: the same `sample_conditional` call runs
the fixed-NFE RK4 sampler on the card, with the hand-written folded linear
attention kernels (`{P}/csrc/linear_attention.cu`). The port's times on the
card are in `PERF.md`.
"""),
]


def notebook(device: str):
    """The notebook's ``nbformat`` node, its first code cell naming ``device``."""
    import nbformat as nbf

    nb = nbf.v4.new_notebook()
    nb.cells = [nbf.v4.new_markdown_cell(text.strip()) if kind == "markdown"
                else nbf.v4.new_code_cell(text.replace("{device!r}", repr(device)).strip())
                for kind, text in CELLS]
    nb.metadata["kernelspec"] = {"display_name": "Python 3", "language": "python",
                                 "name": "python3"}
    return nb


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-exec", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    import nbformat as nbf

    nb = notebook(resolve_device(args.device).type)
    if not args.skip_exec:
        from nbclient import NotebookClient

        client = NotebookClient(nb, timeout=1200, kernel_name="python3",
                                resources={"metadata": {"path": os.path.dirname(args.out)}})
        client.execute()
        print("executed OK")
    with open(args.out, "w") as f:
        nbf.write(nb, f)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
