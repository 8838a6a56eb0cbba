"""Sampling: noise -> fixed-step ODE integration -> categorical decode.

Port of the fixed-step part of ``flowtrain_stochastic_interpolation_tpu/
inference.py``: :func:`make_sampler`, :func:`sample_unconditional`, and for the
conditional model :func:`sample_conditional` and :func:`build_atb`. The
velocity is the UNet, ``model(x, t)``, or the conditional UNet,
``model(x, atb, t)``; the state may be bf16 (the model computes in its own
dtype and the velocity is cast to the state's); the final state is decoded by
cosine argmax; ``with_prominence`` adds its top-1 minus top-2 softmax margin.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.ops.embedding import (
    decode,
    decode_logits,
    embed,
    prominence,
)
from flowtrain_stochastic_interpolation_torch.solvers import (
    solve_ode,
    solve_ode_final,
    stages,
)


@dataclass
class SampleResult:
    decoded: np.ndarray                 # [N, X, Y, Z] int64 (0-based table rows)
    trajectory: Optional[np.ndarray]    # [n_frames, N, X, Y, Z, E] or None
    prominence: Optional[np.ndarray] = None  # [N, X, Y, Z] f32 or None
    seconds_per_batch: List[float] = field(default_factory=list)
    nfe: Optional[int] = None


def make_sampler(
    model: nn.Module,
    table: torch.Tensor,
    *,
    conditional: bool = False,
    t0: float = 0.001,
    tf: float = 1.0,
    n_frames: int = 16,
    substeps: int = 2,
    method: str = "rk4",
    keep_trajectory: bool = False,
    with_prominence: bool = False,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``sampler(x0) -> {"decoded", "nfe"[, "prominence"][, "trajectory"]}``
    for a UNet, or
    ``sampler(x0, atb)`` with ``conditional=True``, whose velocity is
    ``model(x, atb, t)``.

    ``x0`` is the initial state ``[B, X, Y, Z, E]`` on the model's device, in
    the state dtype, and ``atb`` the observations of the same shape. ``nfe`` is
    the number of velocity evaluations. The model runs in eval mode (no
    dropout, as the JAX sampler's ``deterministic=True``) and is handed back
    in the mode it had.
    """
    nfe = (n_frames - 1) * substeps * stages(method)

    @torch.inference_mode()
    def sampler(x0: torch.Tensor, atb: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if conditional != (atb is not None):
            raise TypeError("a conditional sampler takes (x0, atb), an unconditional one x0")
        velocity = model if atb is None else (lambda x, t: model(x, atb, t))
        kw = dict(t0=t0, tf=tf, n_frames=n_frames, substeps=substeps, method=method)
        was_training = model.training
        model.eval()
        try:
            if keep_trajectory:
                traj = solve_ode(velocity, x0, **kw)
                final = traj[-1]
            else:
                final = solve_ode_final(velocity, x0, **kw)
        finally:
            model.train(was_training)
        out = {"decoded": decode(final, table), "nfe": nfe}
        if with_prominence:
            out["prominence"] = prominence(decode_logits(final, table))
        if keep_trajectory:
            out["trajectory"] = traj
        return out

    return sampler


def _model_device(model: nn.Module, device) -> torch.device:
    """The entry point's device (``cuda`` unless named), which must hold ``model``."""
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"the model is on {param.device}, the sampler on {dev}")
    return dev


def initial_noise(generator: torch.Generator, batch: int, data_shape: Tuple[int, int, int],
                  embedding_dim: int, state_dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """One batch of N(0, 1) initial states ``[batch, *data_shape, E]``, drawn in f32."""
    x0 = torch.randn((batch, *data_shape, embedding_dim), generator=generator,
                     dtype=torch.float32, device=device)
    return x0.to(state_dtype)


def _run_batches(sampler, n_samples: int, batch_size: int,
                 inputs: Callable[[int, int], tuple], verbose: bool) -> SampleResult:
    """``sampler(*inputs(b, bs))`` for each batch ``b`` of ``bs`` samples, timed to
    the decoded maps' arrival on the host."""
    decoded, trajs, proms, times = [], [], [], []
    n_batches = (n_samples - 1) // batch_size + 1
    nfe = None
    for b in range(n_batches):
        args = inputs(b, min(batch_size, n_samples - b * batch_size))
        start = time.perf_counter()
        out = sampler(*args)
        batch_decoded = out["decoded"].cpu().numpy()  # waits for the device
        times.append(time.perf_counter() - start)
        if verbose:
            print(f"batch {b + 1}/{n_batches}: solved in {times[-1]:.2f}s")
        decoded.append(batch_decoded)
        if "trajectory" in out:
            trajs.append(out["trajectory"].float().cpu().numpy())
        if "prominence" in out:
            proms.append(out["prominence"].cpu().numpy())
        nfe = out["nfe"]

    return SampleResult(
        decoded=np.concatenate(decoded, axis=0),
        trajectory=np.concatenate(trajs, axis=1) if trajs else None,
        prominence=np.concatenate(proms, axis=0) if proms else None,
        seconds_per_batch=times,
        nfe=nfe,
    )


def sample_unconditional(
    model: nn.Module,
    table: torch.Tensor,
    *,
    n_samples: int,
    batch_size: int,
    data_shape: Tuple[int, int, int],
    embedding_dim: int,
    seed: int = 100,
    device=None,
    state_dtype: torch.dtype = torch.float32,
    verbose: bool = True,
    **sampler_kwargs,
) -> SampleResult:
    """Batched unconditional generation from seeded noise.

    ``device`` defaults to ``cuda`` and must hold ``model``; noise comes from
    one ``torch.Generator`` on that device seeded with ``seed``, drawn batch
    after batch (:func:`initial_noise`).
    """
    dev = _model_device(model, device)
    sampler = make_sampler(model, table.to(dev), **sampler_kwargs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _run_batches(sampler, n_samples, batch_size, lambda b, bs: (
        initial_noise(gen, bs, data_shape, embedding_dim, state_dtype, dev),), verbose)


def sample_conditional(
    model: nn.Module,
    table: torch.Tensor,
    atb: torch.Tensor,
    *,
    n_samples: int,
    batch_size: int,
    seed: int = 42,
    device=None,
    state_dtype: torch.dtype = torch.float32,
    verbose: bool = True,
    **sampler_kwargs,
) -> SampleResult:
    """An ensemble conditioned on one observation volume ``atb [X, Y, Z, E]``.

    ``atb`` is broadcast over each batch. Batch ``b`` draws its noise from a
    generator on ``device`` (``cuda`` unless named) seeded with ``seed + b``,
    the JAX package's ``seed + i`` convention (:func:`initial_noise`).
    ``sampler_kwargs`` go to :func:`make_sampler`.
    """
    dev = _model_device(model, device)
    sampler = make_sampler(model, table.to(dev), conditional=True, **sampler_kwargs)
    atb = atb.to(dev)
    data_shape, e = tuple(atb.shape[:-1]), atb.shape[-1]

    def inputs(b: int, bs: int):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + b)
        return (initial_noise(gen, bs, data_shape, e, state_dtype, dev),
                atb[None].expand(bs, *atb.shape))

    return _run_batches(sampler, n_samples, batch_size, inputs, verbose)


def build_atb(true_model: torch.Tensor, mask: torch.Tensor,
              table: torch.Tensor) -> torch.Tensor:
    """The observations of a categorical ``true_model [X, Y, Z]`` under ``mask``
    ``[X, Y, Z]``: ``embed(true) · mask``, ``[X, Y, Z, E]``."""
    return embed(true_model, table.to(true_model.device)) * mask[..., None]
