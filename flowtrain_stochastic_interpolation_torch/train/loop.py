"""The training loop: data feed, metrics, checkpoints, periodic sampling.

Port of ``flowtrain_stochastic_interpolation_tpu/train/loop.py``:
``build_model``, ``init_model_variables`` and ``init_train_state`` for the
unconditional UNet and the conditional one (``config.model.conditional``),
and ``train`` with the JAX loop's rules:

* resume from the latest checkpoint when ``config.resume``; the batch stream
  of the resumed epoch restarts at that epoch's first batch, as JAX's does;
* ``steps_per_epoch = max(epoch_size // batch_size, 1)`` micro-steps an epoch;
* metrics go to the history, the writer and the callback every
  ``log_every_n_steps``, at every epoch boundary and at the last step;
* a checkpoint every ``checkpoint_every_steps`` and one at the end;
* the objective's noise, times and dropout of micro-step ``s`` come from a
  generator seeded from ``(training.seed + 17, s)``, the counterpart of JAX's
  ``fold_in(key, state.step)``, so a resumed run draws what an uninterrupted
  run draws.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch

from flowtrain_stochastic_interpolation_torch.config import ExperimentConfig
from flowtrain_stochastic_interpolation_torch.data.synthetic import get_dataset
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_torch.models.unet_cond import UNet3DCond
from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_torch.train.state import (
    Optimizer,
    TrainState,
    init_state,
    make_optimizer,
)
from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager
from flowtrain_stochastic_interpolation_torch.train.steps import make_train_step
from flowtrain_stochastic_interpolation_torch.utils.logging import MetricsWriter
from flowtrain_stochastic_interpolation_torch.utils.rng import generator


def build_model(config: ExperimentConfig, device=None) -> UNet:
    """The configured UNet (a :class:`UNet3DCond` when ``config.model.conditional``),
    unseeded; its data channels are the embedding width."""
    mc = dataclasses.replace(config.model, data_channels=config.data.embedding_dim)
    return (UNet3DCond if mc.conditional else UNet).from_config(mc, device=device)


def init_model_variables(config: ExperimentConfig, seed: Optional[int] = None,
                         device=None) -> UNet:
    """The configured UNet with its parameters drawn from a generator on its
    device seeded with ``seed`` (``config.training.seed`` when None)."""
    model = build_model(config, device)
    param = next(model.parameters())
    gen = torch.Generator(device=param.device)
    gen.manual_seed(config.training.seed if seed is None else seed)
    model.reset_parameters(gen)
    return model


def init_train_state(config: ExperimentConfig,
                     device=None) -> Tuple[UNet, Optimizer, TrainState]:
    """``(model, tx, state)``: the seeded model, its optimiser and the train state."""
    model = init_model_variables(config, device=device)
    dev = next(model.parameters()).device
    table = torch.from_numpy(
        simplex_embedding(config.data.num_categories, config.data.embedding_dim)
    ).to(dev)
    updates_per_epoch = max(
        config.data.epoch_size // config.data.batch_size
        // config.training.accumulate_grad_batches, 1,
    )
    tx = make_optimizer(config.training, updates_per_epoch)
    state = init_state(model, {"embedding": table}, tx, config.ema)
    return model, tx, state


@dataclass
class TrainResult:
    state: TrainState
    history: list = field(default_factory=list)
    steps_per_sec: float = 0.0  # excludes the first micro-step (cuDNN's set-up)
    steps_per_sec_with_compile: float = 0.0


def steps_per_epoch(config: ExperimentConfig) -> int:
    return max(config.data.epoch_size // config.data.batch_size, 1)


def train(
    config: ExperimentConfig,
    *,
    num_steps: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    writer: Optional[MetricsWriter] = None,
    callback: Optional[Callable[[int, TrainState, Dict[str, float]], None]] = None,
    pretrain_smoke: bool = False,
    device=None,
) -> TrainResult:
    """Run ``num_steps`` micro-steps (or ``training.max_epochs`` epochs).

    Starts from :func:`init_train_state`, or from the latest checkpoint in
    ``checkpoint_dir`` when ``config.resume``. ``pretrain_smoke`` runs
    :func:`_pretrain_smoke` before the first step.
    """
    dev = resolve_device(device)
    model, tx, state = init_train_state(config, device=dev)

    mgr = None
    if checkpoint_dir:
        mgr = CheckpointManager(checkpoint_dir, config,
                                max_to_keep=config.training.keep_checkpoints)
        if config.resume and mgr.latest_step() is not None:
            state = mgr.restore(state)
            print(f"[train] resumed from step {state.step}")

    train_step = make_train_step(model, tx, config)
    dataset = get_dataset(config.data, seed=config.training.seed, device=dev)
    noise_seed = config.training.seed + 17

    batch_size = config.data.batch_size
    per_epoch = steps_per_epoch(config)
    total_steps = num_steps if num_steps is not None else per_epoch * config.training.max_epochs

    if pretrain_smoke:
        _pretrain_smoke(config, dataset, callback, state, checkpoint_dir)

    history = []
    start_step = state.step
    t_start = time.perf_counter()
    t_after_first = None
    step = start_step
    epoch = start_step // per_epoch
    batch_iter = dataset.batches(batch_size, epoch=epoch)
    while step < start_step + total_steps:
        try:
            batch = next(batch_iter)
        except StopIteration:
            epoch += 1
            batch_iter = dataset.batches(batch_size, epoch=epoch)
            continue
        state, metrics = train_step(state, batch, generator(dev, noise_seed, state.step))
        step += 1
        if t_after_first is None:
            float(metrics["train_loss"])  # waits for the first step
            t_after_first = time.perf_counter()

        # epoch boundaries reach the callback whatever log_every_n_steps is
        at_epoch_boundary = step % per_epoch == 0
        if (step % config.training.log_every_n_steps == 0 or at_epoch_boundary
                or step == start_step + total_steps):
            host_metrics = {k: float(v) for k, v in metrics.items()}
            host_metrics["step"] = step
            history.append(host_metrics)
            if writer:
                writer.write(step, host_metrics)
            if callback:
                callback(step, state, host_metrics)

        if mgr and step % config.training.checkpoint_every_steps == 0:
            mgr.save(step, state, metrics={"train_loss": float(metrics["train_loss"])})

    float(next(iter(state.params.values())).detach().reshape(-1)[0])  # waits for the last step
    t_end = time.perf_counter()
    if mgr:
        mgr.save(step, state, metrics={"train_loss": history[-1]["train_loss"] if history else 0.0})

    n_steps_run = step - start_step
    steady = (
        (n_steps_run - 1) / max(t_end - t_after_first, 1e-9)
        if (t_after_first is not None and n_steps_run > 1)
        else n_steps_run / max(t_end - t_start, 1e-9)
    )
    return TrainResult(
        state=state,
        history=history,
        steps_per_sec=steady,
        steps_per_sec_with_compile=n_steps_run / max(t_end - t_start, 1e-9),
    )


def _pretrain_smoke(config, dataset, callback, state, checkpoint_dir) -> None:
    """The checks before the first step: draw one batch and render its first
    volume's slices (``inspect_data.png``), then one sampling pass of the
    callback (tag ``pretrain``). A failed rendering is printed and passed
    over, as in the JAX loop; a failed sampling pass raises (the JAX loop
    prints it and goes on), since it is a fault of the device path, not of a
    picture."""
    out_dir = checkpoint_dir or "."
    batch = next(dataset.batches(min(config.data.batch_size, 2), epoch=0)).cpu().numpy()
    try:
        from flowtrain_stochastic_interpolation_torch.utils.plotting import plot_2d_slices

        os.makedirs(out_dir, exist_ok=True)
        plot_2d_slices(batch[0], save_path=os.path.join(out_dir, "inspect_data.png"))
        print(f"[train] pre-train data inspection saved ({out_dir}/inspect_data.png)")
    except Exception as exc:
        print(f"[train] pre-train data inspection failed: {exc}")
    if callback is not None and hasattr(callback, "run_inference"):
        callback.run_inference(state, tag="pretrain")
