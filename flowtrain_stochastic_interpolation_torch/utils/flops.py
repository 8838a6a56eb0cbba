"""Matrix-product and convolution FLOPs of a call, counted without a device.

Port of ``flowtrain_stochastic_interpolation_tpu/utils/flops.py``, whose
``count_conv_dot_flops`` sums the dot and convolution FLOPs of a jaxpr (the
JAX ``bench.py``'s MFU source). Here :func:`count_conv_dot_flops` runs the call
under ``torch.utils.flop_counter.FlopCounterMode``, which counts the ATen
matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``) and convolutions,
forward and backward, with JAX's conventions: ``2·M·N·K`` a product,
``2 · batch · out_spatial · Cout · Cin · prod(kernel)`` a convolution.
Elementwise work and reductions are not counted, on either side.

The count must be the same work whatever implements it, so the model runs on
PyTorch's ``meta`` device (:func:`forward_flops`, :func:`micro_step_flops`):
shapes only, no data, no card. There the linear attention takes the per-head
einsum route (K1 and K2 are ctypes launches the counter cannot see, and the
folded plain version multiplies the whole ``h·d × h·d`` block, ``heads`` × the
per-head work) and full attention the einsum route (K3 likewise): the
products of JAX's formulation on a CPU trace. One operation differs by
design: JAX writes the trilinear resize as one interpolation matmul per axis,
which its count includes; here it is ``F.interpolate``, two taps a voxel,
which is not a product and is not counted.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

META = torch.device("meta")


def count_conv_dot_flops(fn, *args, **kwargs) -> float:
    """The matmul and convolution FLOPs of one call ``fn(*args, **kwargs)``
    (forward, and backward where ``fn`` runs one)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def _meta_model(config):
    from flowtrain_stochastic_interpolation_torch.train.loop import build_model

    return build_model(config, device=META)


def forward_flops(config, batch: int, shape: Tuple[int, ...] = None) -> float:
    """One forward of ``config``'s (unconditional or conditional) UNet at ``batch``
    × ``shape`` (``config.data.shape`` when None), counted on ``meta``."""
    model = _meta_model(config).eval()
    x = torch.empty(batch, *(shape or config.data.shape), config.data.embedding_dim,
                    device=META)
    t = torch.empty(batch, device=META)
    args = (x, torch.empty_like(x), t) if config.model.conditional else (x, t)
    with torch.no_grad():
        return count_conv_dot_flops(model, *args)


def micro_step_flops(config) -> float:
    """One training micro-step of the unconditional ``config`` at its batch size
    (``config.data.batch_size``): the objective's forward in training mode and
    its backward, counted on ``meta``. The optimiser does no products."""
    from flowtrain_stochastic_interpolation_torch.train.steps import _loss

    if config.model.conditional:
        raise ValueError("micro_step_flops counts the unconditional objective")
    model = _meta_model(config).train()
    b = config.data.batch_size
    x = torch.empty(b, *config.data.shape, config.data.embedding_dim, device=META)
    draws = (x, torch.empty_like(x), torch.empty(b, device=META))

    def step():
        loss, _ = _loss(config)(model, None, None, None, draws=draws)
        loss.backward()

    return count_conv_dot_flops(step)
