"""In-training sampling with prominence maps.

Port of ``flowtrain_stochastic_interpolation_tpu/train/callbacks.py``: every
``every_n_epochs`` epochs (at the epoch boundary), and once before training
through the loop's pre-train smoke, sample ``n_samples`` volumes from seeded
noise with the state's EMA weights (its params when EMA is off), decode them
(a conditional model samples with all-zero observations, as in JAX),
compute the prominence (top-1 minus top-2 softmax margin), save slice grids
and heatmaps, and record ``time_to_solve``.

The callback samples with its own ``model``, into which it copies the weights
for the call and whose own weights it puts back afterwards (the training
model itself may be passed: its weights then stay as they are when EMA is
off). Rendering is guarded: a picture that fails to render (no matplotlib,
say) is printed and passed over and never stops training.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch
from torch import nn

from flowtrain_stochastic_interpolation_torch.config import ExperimentConfig
from flowtrain_stochastic_interpolation_torch.inference import initial_noise, make_sampler
from flowtrain_stochastic_interpolation_torch.train.loop import steps_per_epoch
from flowtrain_stochastic_interpolation_torch.train.state import TrainState


@contextlib.contextmanager
@torch.no_grad()
def weights_applied(model: nn.Module, params: Dict[str, torch.Tensor]):
    """``model`` holding ``params`` (parameters and buffers, by name) inside the
    block, its own after it; nothing is copied where ``params`` are the model's
    own tensors."""
    own = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    moved = [name for name, p in params.items() if own[name] is not p]
    targets = [own[name] for name in moved]
    saved = [t.detach().clone() for t in targets]
    for target, value in zip(targets, (params[name] for name in moved)):
        target.copy_(value)
    try:
        yield model
    finally:
        for target, value in zip(targets, saved):
            target.copy_(value)


class InferenceCallback:
    def __init__(
        self,
        config: ExperimentConfig,
        model: nn.Module,
        save_dir: str,
        *,
        every_n_epochs: int = 5,
        n_samples: int = 4,
        n_frames: int = 32,
        tf: float = 0.999,
        seed: int = 42,
        use_ema: bool = True,
        writer=None,
    ):
        self.config = config
        self.model = model
        self.save_dir = save_dir
        self.every_n_epochs = every_n_epochs
        self.n_samples = n_samples
        self.n_frames = n_frames
        self.tf = tf
        self.seed = seed
        self.use_ema = use_ema
        self.writer = writer  # optional MetricsWriter for time_to_solve and images
        os.makedirs(save_dir, exist_ok=True)
        self._steps_per_epoch = steps_per_epoch(config)
        self._last_epoch_done = -1

    def __call__(self, step: int, state: TrainState, metrics: dict) -> None:
        epoch = step // self._steps_per_epoch
        if epoch == self._last_epoch_done or epoch % self.every_n_epochs:
            return
        if step % self._steps_per_epoch:  # only at epoch boundaries
            return
        self._last_epoch_done = epoch
        self.run_inference(state, tag=f"epoch{epoch:04d}")

    def run_inference(self, state: TrainState, tag: str = "manual") -> dict:
        cfg = self.config
        use_ema = self.use_ema and cfg.ema.enabled and state.ema_params is not None
        params = state.model_state_dict(use_ema)
        table = state.constants["embedding"]
        device = table.device
        conditional = cfg.model.conditional
        sampler = make_sampler(
            self.model, table, conditional=conditional, t0=cfg.inference.t0, tf=self.tf,
            n_frames=self.n_frames, substeps=cfg.inference.substeps,
            method=cfg.inference.method, with_prominence=True,
        )
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        x0 = initial_noise(gen, self.n_samples, cfg.data.shape, cfg.data.embedding_dim,
                           torch.float32, device)
        inputs = (x0, torch.zeros_like(x0)) if conditional else (x0,)
        t_start = time.perf_counter()
        with weights_applied(self.model, params):
            out = sampler(*inputs)
            decoded = out["decoded"].cpu().numpy() - 1  # waits for the device
        time_to_solve = time.perf_counter() - t_start
        prom = out["prominence"].cpu().numpy()

        step = state.step
        image_paths = []
        try:
            from flowtrain_stochastic_interpolation_torch.utils.plotting import (
                plot_2d_slices,
                plot_prominence_maps,
            )

            for i in range(min(self.n_samples, 2)):
                sample_png = os.path.join(self.save_dir, f"{tag}_sample{i}.png")
                prom_png = os.path.join(self.save_dir, f"{tag}_prominence{i}.png")
                plot_2d_slices(decoded[i], save_path=sample_png)
                plot_prominence_maps(prom[i], save_path=prom_png)
                image_paths += [(f"samples/{tag}_{i}", sample_png),
                                (f"prominence/{tag}_{i}", prom_png)]
        except Exception as exc:  # rendering must never stop training
            print(f"[InferenceCallback] rendering failed: {exc}")
        if self.writer is not None:
            self.writer.write(step, {"time_to_solve": time_to_solve})
            for name, path in image_paths:
                self.writer.log_image(step, name, path)
        print(f"[InferenceCallback] {tag}: {self.n_samples} samples in {time_to_solve:.2f}s")
        return {"time_to_solve": time_to_solve, "decoded": decoded, "prominence": prom}
