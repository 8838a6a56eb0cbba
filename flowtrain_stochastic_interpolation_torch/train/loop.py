"""Building the model and the train state from an :class:`config.ExperimentConfig`.

Port of ``build_model``, ``init_model_variables`` and ``init_train_state`` in
``flowtrain_stochastic_interpolation_tpu/train/loop.py``, for the
unconditional UNet and the conditional one (``config.model.conditional``).
The host loop itself (``train``: data feed, metrics, checkpoints, callbacks)
is not ported yet (ROADMAP Queue 1 item 7).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from flowtrain_stochastic_interpolation_torch.config import ExperimentConfig
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_torch.models.unet_cond import UNet3DCond
from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_torch.train.state import (
    Optimizer,
    TrainState,
    init_state,
    make_optimizer,
)


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
