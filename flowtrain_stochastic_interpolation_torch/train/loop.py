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
  run draws;
* a dataset made on the host (``host_side``: GeoGen, the native generator)
  is read through :func:`data.prefetch.prefetch` two batches ahead, each int32
  batch pinned and copied to the device without blocking; a device-side one
  (the synthetic generator) is read inline.

Data parallelism (a ``mesh`` of several data ranks, or a process group of
several ranks, :mod:`parallel`): every rank draws the global batch from the
same seed and trains on its block of it (:func:`parallel.mesh.shard_batch`),
so the global batch is the one-process batch; each rank draws its noise from
``(training.seed + 17, s, di)``; the step is the global objective's
(``train.steps``). The parameters start equal on every rank (rank 0's,
broadcast). The metrics CSV, the callback, the pre-train smoke and the
checkpoints are written by the primary rank only; a barrier follows each
save, and every rank reads the checkpoint on resume.

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
from flowtrain_stochastic_interpolation_torch.data.geogen import get_dataset
from flowtrain_stochastic_interpolation_torch.data.prefetch import prefetch
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_torch.models.unet_cond import UNet3DCond
from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_torch.parallel.collectives import broadcast
from flowtrain_stochastic_interpolation_torch.parallel.distributed import is_primary
from flowtrain_stochastic_interpolation_torch.parallel.mesh import Mesh, create_mesh, shard_batch
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


def build_model(config: ExperimentConfig, device=None, spatial_group=None) -> UNet:
    """The configured UNet (a :class:`UNet3DCond` when ``config.model.conditional``),
    unseeded, X-sharded over ``spatial_group`` when one is given; its data
    channels are the embedding width."""
    mc = dataclasses.replace(config.model, data_channels=config.data.embedding_dim)
    return (UNet3DCond if mc.conditional else UNet).from_config(
        mc, device=device, spatial_group=spatial_group)


def init_model_variables(config: ExperimentConfig, seed: Optional[int] = None,
                         device=None, spatial_group=None) -> UNet:
    """The configured UNet with its parameters drawn from a generator on its
    device seeded with ``seed`` (``config.training.seed`` when None); X-sharded
    over ``spatial_group`` when one is given (the same draws)."""
    model = build_model(config, device, spatial_group)
    param = next(model.parameters())
    gen = torch.Generator(device=param.device)
    gen.manual_seed(config.training.seed if seed is None else seed)
    model.reset_parameters(gen)
    return model


def init_train_state(config: ExperimentConfig, device=None,
                     mesh: Optional[Mesh] = None) -> Tuple[UNet, Optimizer, TrainState]:
    """``(model, tx, state)``: the seeded model, its optimiser and the train state.
    With a ``mesh`` of several ranks, the parameters and buffers are rank 0's on
    every rank (broadcast over the mesh's world group), and the model is
    X-sharded over the mesh's spatial group where it has one."""
    model = init_model_variables(config, device=device,
                                 spatial_group=None if mesh is None else mesh.spatial_group)
    if mesh is not None and mesh.size > 1:
        with torch.no_grad():
            tensors = list(model.parameters()) + list(model.buffers())
            flat = torch.cat([t.reshape(-1) for t in tensors])
            flat = broadcast(flat, 0, mesh.world_group)
            parts = torch.split(flat, [t.numel() for t in tensors])
            torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(parts, tensors)])
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


def device_batches(dataset, batch_size: int, epoch: int, device: torch.device):
    """The epoch's batches on ``device``. A host-side dataset's batches are made
    on a background thread two ahead of the consumer (JAX's ``prefetch(depth=2)``)
    and copied through pinned memory without blocking; a device-side
    dataset's are read inline, as in JAX."""
    if not getattr(dataset, "host_side", True):
        return dataset.batches(batch_size, epoch=epoch)

    def put_all():
        for b in dataset.batches(batch_size, epoch=epoch):
            b = torch.as_tensor(b)
            if device.type == "cuda":
                b = b.pin_memory()
            yield b.to(device, non_blocking=True)

    return prefetch(put_all(), depth=2)


def train(
    config: ExperimentConfig,
    *,
    num_steps: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    writer: Optional[MetricsWriter] = None,
    callback: Optional[Callable[[int, TrainState, Dict[str, float]], None]] = None,
    pretrain_smoke: bool = False,
    device=None,
    mesh: Optional[Mesh] = None,
) -> TrainResult:
    """Run ``num_steps`` micro-steps (or ``training.max_epochs`` epochs).

    Starts from :func:`init_train_state`, or from the latest checkpoint in
    ``checkpoint_dir`` when ``config.resume``. ``pretrain_smoke`` runs
    :func:`_pretrain_smoke` before the first step. ``mesh`` (the data-parallel
    mesh over every rank of the process group when None) must have no spatial
    axis.
    """
    dev = resolve_device(device)
    if mesh is None:
        mesh = create_mesh()
    primary = is_primary()
    model, tx, state = init_train_state(config, device=dev, mesh=mesh)

    mgr = None
    if checkpoint_dir:
        mgr = CheckpointManager(checkpoint_dir, config if primary else None,
                                max_to_keep=config.training.keep_checkpoints)
        if config.resume and mgr.latest_step() is not None:
            state = mgr.restore(state)
            if primary:
                print(f"[train] resumed from step {state.step}")

    def save(step: int, loss: float) -> None:
        if primary:
            mgr.save(step, state, metrics={"train_loss": loss})
        if mesh.world_group is not None:
            torch.distributed.barrier(mesh.world_group)

    train_step = make_train_step(model, tx, config, mesh)
    if not primary:
        writer = callback = None
        pretrain_smoke = False
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
    batch_iter = device_batches(dataset, batch_size, epoch, dev)
    # the rank's own noise under data parallelism; the one-process stream otherwise
    rank_seed = (mesh.di,) if mesh.n_data > 1 else ()
    while step < start_step + total_steps:
        try:
            batch = next(batch_iter)
        except StopIteration:
            epoch += 1
            batch_iter = device_batches(dataset, batch_size, epoch, dev)
            continue
        batch = shard_batch(batch, mesh)
        state, metrics = train_step(state, batch,
                                    generator(dev, noise_seed, state.step, *rank_seed))
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
            save(step, float(metrics["train_loss"]))

    float(next(iter(state.params.values())).detach().reshape(-1)[0])  # waits for the last step
    t_end = time.perf_counter()
    if mgr:
        save(step, history[-1]["train_loss"] if history else 0.0)

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
    # a tensor on the device, or (a host-side source) a numpy array
    batch = torch.as_tensor(next(dataset.batches(min(config.data.batch_size, 2), epoch=0)))
    batch = batch.cpu().numpy()
    try:
        from flowtrain_stochastic_interpolation_torch.utils.plotting import plot_2d_slices

        os.makedirs(out_dir, exist_ok=True)
        plot_2d_slices(batch[0], save_path=os.path.join(out_dir, "inspect_data.png"))
        print(f"[train] pre-train data inspection saved ({out_dir}/inspect_data.png)")
    except Exception as exc:
        print(f"[train] pre-train data inspection failed: {exc}")
    if callback is not None and hasattr(callback, "run_inference"):
        callback.run_inference(state, tag="pretrain")
