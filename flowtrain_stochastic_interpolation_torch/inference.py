"""Sampling: noise -> ODE or SDE integration -> categorical decode.

Port of ``flowtrain_stochastic_interpolation_tpu/inference.py``:
:func:`make_sampler` (the fixed-step solvers, adaptive dopri5, the velocity
SDE, and frame dispatch), :func:`sample_unconditional`, and for the
conditional model :func:`sample_conditional` and :func:`build_atb`. The
velocity is the UNet, ``model(x, t)``, or the conditional UNet,
``model(x, atb, t)``; the state may be bf16 (the model computes in its own
dtype and the ODE's velocity is cast to the state's); the final state is
decoded by cosine argmax; ``with_prominence`` adds its top-1 minus top-2
softmax margin. :func:`make_spatial_sampler` is the sampler of a model
whose X axis is sharded over the ranks of a mesh's spatial group: each rank
integrates and decodes its own slab.

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
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant
from flowtrain_stochastic_interpolation_torch.ops.embedding import (
    decode,
    decode_logits,
    embed,
    prominence,
)
from flowtrain_stochastic_interpolation_torch.solvers import (
    eps_schedule,
    frame_grid,
    make_frame_advancer,
    solve_ode,
    solve_ode_adaptive,
    solve_ode_final,
    solve_velocity_sde,
    stages,
)
from flowtrain_stochastic_interpolation_torch.utils.rng import generator as folded_generator

# the SDE noise of a batch comes from a generator seeded with fold_seed(..., 7919)
# (utils/rng.py) over the seeds of that batch's initial noise: the counterpart of
# the JAX package's fold_in(key, 7919)
SDE_NOISE_SALT = 7919


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
    adaptive: bool = False,
    atol: float = 1e-6,
    rtol: float = 1e-6,
    keep_trajectory: bool = False,
    with_prominence: bool = False,
    variables_as_arg: bool = False,
    donate_x0: bool = False,
    frame_dispatch: bool = False,
    sde_epsilon: float = 0.5,
    sde_eps_schedule: str = "linear_decay",
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``sampler(x0) -> {"decoded", "nfe"[, "prominence"][, "trajectory"]}``
    for a UNet, or ``sampler(x0, atb)`` with ``conditional=True``, whose velocity
    is ``model(x, atb, t)``.

    ``x0`` is the initial state ``[B, X, Y, Z, E]`` on the model's device, in
    the state dtype, and ``atb`` the observations of the same shape. ``nfe`` is
    the number of velocity evaluations. The model runs in eval mode (no
    dropout, as the JAX sampler's ``deterministic=True``) and is handed back
    in the mode it had; it is read at each call, so one sampler serves weights
    that change between calls.

    * ``method`` is a fixed-step solver (euler, heun, midpoint, rk4,
      rk4_tableau) or ``"sde"``: Euler–Maruyama of the velocity with the score
      of ``LinearInterpolant(one_sided=True)`` and
      ``eps_schedule(sde_eps_schedule, sde_epsilon)``, over the same frames and
      substeps, one evaluation a substep. Its sampler takes the noise's
      generator, ``sampler(x0[, atb], generator=...)``, and raises without one.
    * ``adaptive=True``: dopri5 at ``atol`` / ``rtol`` on the frame grid; its
      ``nfe`` is the solver's signed count (negative: truncated).
    * ``frame_dispatch=True``: the frame loop with each trajectory frame
      copied to the host before the next (``"trajectory"`` is then a CPU
      tensor); the final state is the plain path's bit for bit.
    * ``variables_as_arg`` and ``donate_x0`` serve XLA's compile and buffer
      donation in the JAX package. ``variables_as_arg=True`` raises here (the
      sampler already reads the model's current weights at each call);
      ``donate_x0`` does nothing (x0 is never written).

    The JAX package's rules hold: ``"sde"`` takes neither ``adaptive``,
    ``frame_dispatch`` nor ``variables_as_arg``, and ``frame_dispatch`` neither
    ``adaptive`` nor ``variables_as_arg``.
    """
    del donate_x0  # nothing to donate: eager PyTorch never writes x0
    sde = method == "sde"
    if sde:
        if adaptive or frame_dispatch or variables_as_arg:
            raise ValueError("method='sde' is incompatible with "
                             "adaptive/frame_dispatch/variables_as_arg")
        sde_interp = LinearInterpolant(one_sided=True)
        sde_eps_fn = eps_schedule(sde_eps_schedule, sde_epsilon)
    if frame_dispatch and (adaptive or variables_as_arg):
        raise ValueError("frame_dispatch is incompatible with adaptive/variables_as_arg")
    if variables_as_arg:
        raise ValueError("variables_as_arg is not ported: the sampler reads the weights "
                         "the model holds at each call")
    if sde:
        nfe = (n_frames - 1) * substeps
    elif not adaptive:
        nfe = (n_frames - 1) * substeps * stages(method)

    def integrate(velocity, x0, gen):
        """``(final state, trajectory or None, nfe)``."""
        if sde:
            if gen is None:
                raise ValueError("method='sde' samplers take a torch.Generator: "
                                 "sampler(x0[, atb], generator=...)")
            out = solve_velocity_sde(velocity, sde_interp, x0, gen, epsilon=sde_eps_fn,
                                     t0=t0, tf=tf, n_frames=n_frames, substeps=substeps,
                                     keep_trajectory=keep_trajectory)
            return (out[-1], out, nfe) if keep_trajectory else (out, None, nfe)
        if adaptive:
            traj, n = solve_ode_adaptive(velocity, x0, t0=t0, tf=tf, n_frames=n_frames,
                                         atol=atol, rtol=rtol)
            return traj[-1], traj, n
        if frame_dispatch:
            advance = make_frame_advancer(velocity, substeps=substeps, method=method)
            frame_ts, h = frame_grid(x0.dtype, t0, tf, n_frames, substeps)
            x = x0
            frames = [x0.cpu()] if keep_trajectory else None
            for t_start in frame_ts[:-1]:
                x = advance(x, float(t_start), h)
                if keep_trajectory:
                    frames.append(x.cpu())  # waits for the frame
            return x, (torch.stack(frames, dim=0) if keep_trajectory else None), nfe
        kw = dict(t0=t0, tf=tf, n_frames=n_frames, substeps=substeps, method=method)
        if keep_trajectory:
            traj = solve_ode(velocity, x0, **kw)
            return traj[-1], traj, nfe
        return solve_ode_final(velocity, x0, **kw), None, nfe

    @torch.inference_mode()
    def sampler(x0: torch.Tensor, atb: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if conditional != (atb is not None):
            raise TypeError("a conditional sampler takes (x0, atb), an unconditional one x0")
        velocity = model if atb is None else (lambda x, t: model(x, atb, t))
        was_training = model.training
        model.eval()
        try:
            final, traj, n = integrate(velocity, x0, generator)
        finally:
            model.train(was_training)
        out = {"decoded": decode(final, table), "nfe": n}
        if with_prominence:
            out["prominence"] = prominence(decode_logits(final, table))
        if keep_trajectory:
            out["trajectory"] = traj
        return out

    return sampler


def make_spatial_sampler(
    model: nn.Module,
    table: torch.Tensor,
    mesh,
    *,
    conditional: bool = False,
    t0: float = 0.001,
    tf: float = 1.0,
    n_frames: int = 16,
    substeps: int = 2,
    method: str = "rk4",
    with_prominence: bool = False,
    variables_as_arg: bool = False,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The sampler of a volume too large for one card, its X axis sharded over
    ``mesh``'s spatial group (a :class:`parallel.mesh.Mesh` with a spatial axis).

    ``model`` must be built with that group (``spatial_group=mesh.spatial_group``:
    halo convs, ring attention, the collective linear attention). Each rank
    calls ``sampler(x0[, atb])`` with its own slab ``[B_loc, X_loc, Y, Z, E]``
    (``parallel.mesh.shard_batch``) and gets ``{"decoded", "nfe"[,
    "prominence"]}`` for that slab: the fixed-step ``method`` over the frame
    grid, then the decode, as :func:`make_sampler` (whose rules hold). The
    adaptive and SDE solvers are out, as in the JAX package: an error norm or a
    noise draw per slab would differ between the ranks of one sample.
    """
    if "spatial" not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}; a 'spatial' axis is required "
                         "(parallel.mesh.create_mesh(n_data, n_spatial))")
    if getattr(model, "spatial_group", None) is not mesh.spatial_group:
        raise ValueError("the model must be built with the mesh's spatial group "
                         "(spatial_group=mesh.spatial_group)")
    if method == "sde":
        raise ValueError("the spatial sampler integrates an ODE; method='sde' is not one")
    return make_sampler(model, table, conditional=conditional, t0=t0, tf=tf,
                        n_frames=n_frames, substeps=substeps, method=method,
                        with_prominence=with_prominence, variables_as_arg=variables_as_arg)


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
                 inputs: Callable[[int, int], Tuple[tuple, dict]], verbose: bool) -> SampleResult:
    """``sampler(*args, **kwargs)`` with ``(args, kwargs) = inputs(b, bs)`` for each
    batch ``b`` of ``bs`` samples, timed to the decoded maps' arrival on the host."""
    decoded, trajs, proms, times = [], [], [], []
    n_batches = (n_samples - 1) // batch_size + 1
    nfe = None
    for b in range(n_batches):
        args, kwargs = inputs(b, min(batch_size, n_samples - b * batch_size))
        start = time.perf_counter()
        out = sampler(*args, **kwargs)
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


def _sde_kwargs(method: Optional[str], device: torch.device, seeds: Tuple[int, ...]) -> dict:
    """The sampler's keyword arguments: for ``method="sde"`` the noise's generator,
    seeded with ``fold_seed(*seeds, SDE_NOISE_SALT)``."""
    if method != "sde":
        return {}
    return {"generator": folded_generator(device, *seeds, SDE_NOISE_SALT)}


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
    sampler: Optional[Callable] = None,
    **sampler_kwargs,
) -> SampleResult:
    """Batched unconditional generation from seeded noise.

    ``device`` defaults to ``cuda`` and must hold ``model``; noise comes from
    one ``torch.Generator`` on that device seeded with ``seed``, drawn batch
    after batch (:func:`initial_noise`). With ``method="sde"`` batch ``b``'s
    Brownian increments come from a generator of their own, seeded with
    ``fold_seed(seed, b, 7919)`` (``utils/rng.py``), so that runs with one seed
    are identical. ``sampler`` is a prebuilt :func:`make_sampler` sampler (the
    ``method`` keyword then only says whether it is an SDE's);
    ``sampler_kwargs`` go to :func:`make_sampler` otherwise.
    """
    dev = _model_device(model, device)
    method = sampler_kwargs.get("method")
    if sampler is None:
        sampler = make_sampler(model, table.to(dev), **sampler_kwargs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _run_batches(sampler, n_samples, batch_size, lambda b, bs: (
        (initial_noise(gen, bs, data_shape, embedding_dim, state_dtype, dev),),
        _sde_kwargs(method, dev, (seed, b))), verbose)


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
    sampler: Optional[Callable] = None,
    **sampler_kwargs,
) -> SampleResult:
    """An ensemble conditioned on one observation volume ``atb [X, Y, Z, E]``.

    ``atb`` is broadcast over each batch. Batch ``b`` draws its noise from a
    generator on ``device`` (``cuda`` unless named) seeded with ``seed + b``,
    the JAX package's ``seed + i`` convention (:func:`initial_noise`); with
    ``method="sde"`` its Brownian increments come from a generator seeded with
    ``fold_seed(seed + b, 7919)``. Pass ``sampler`` (from
    ``make_sampler(..., conditional=True)``) to serve every scenario with one
    sampler, with the ``method`` keyword saying whether it is an SDE's;
    ``sampler_kwargs`` go to :func:`make_sampler` otherwise.
    """
    dev = _model_device(model, device)
    method = sampler_kwargs.get("method")
    if sampler is None:
        sampler = make_sampler(model, table.to(dev), conditional=True, **sampler_kwargs)
    atb = atb.to(dev)
    data_shape, e = tuple(atb.shape[:-1]), atb.shape[-1]

    def inputs(b: int, bs: int):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + b)
        return ((initial_noise(gen, bs, data_shape, e, state_dtype, dev),
                 atb[None].expand(bs, *atb.shape)), _sde_kwargs(method, dev, (seed + b,)))

    return _run_batches(sampler, n_samples, batch_size, inputs, verbose)


def build_atb(true_model: torch.Tensor, mask: torch.Tensor,
              table: torch.Tensor) -> torch.Tensor:
    """The observations of a categorical ``true_model [X, Y, Z]`` under ``mask``
    ``[X, Y, Z]``: ``embed(true) · mask``, ``[X, Y, Z, E]``."""
    return embed(true_model, table.to(true_model.device)) * mask[..., None]
