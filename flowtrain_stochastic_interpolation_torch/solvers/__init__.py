"""Samplers: ODE and SDE integrators for a learned velocity or denoiser field.

Port of ``flowtrain_stochastic_interpolation_tpu/solvers/__init__.py``:

* :func:`solve_ode` (trajectory on the frame grid) and :func:`solve_ode_final`
  (final state only), fixed-step Euler, Heun, midpoint, the memory-lean RK4
  (``rk4``) and the tableau RK4 (``rk4_tableau``); :func:`make_frame_advancer`
  (one frame's substeps, for a loop driven frame by frame) and
  :func:`frame_grid`;
* :func:`solve_ode_adaptive`, dopri5 on the save grid (``solvers/dopri5.py``);
* the one-sided denoiser: :func:`denoiser_to_velocity`,
  :func:`velocity_to_denoiser`, :func:`solve_denoising_ode` and the
  Euler–Maruyama samplers :func:`solve_denoising_sde` and
  :func:`solve_velocity_sde` with :func:`eps_schedule`;
* :func:`ode_sol_rk4` and :class:`ODEFlowSolver`, the reference's API.

Every ODE solver takes ``frozen_mask`` (True: dx/dt = 0, for inpainting).
PyTorch runs eagerly, so the JAX package's ``lax.scan`` / ``fori_loop`` are
Python loops here.

Times stay in float32 (float64 for a float64 state) whatever the state's
dtype, and are computed on the host in numpy with the JAX package's
arithmetic; the state's arithmetic runs in the state's dtype, with each step
constant rounded to it first, as in the JAX package (a JAX ``h.astype(x.dtype)``
is :func:`_in` here).

The SDE samplers draw their Brownian increments from a ``torch.Generator``,
or from a ``noise(step_index, shape, dtype)`` callable where the caller hands
them over (the JAX and torch random streams differ, so a test feeds JAX's own
draws). ``step_index`` counts substeps from 0 over the whole solve.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.interpolants import Interpolant
from flowtrain_stochastic_interpolation_torch.solvers.dopri5 import dopri5_integrate

VelocityFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x [B,...], t [B]) -> dx/dt
NoiseFn = Callable[[int, Tuple[int, ...], torch.dtype], torch.Tensor]
Epsilon = Union[float, Callable[[float], float]]


def _time_dtype(state_dtype: torch.dtype):
    """The numpy type of times for a state of ``state_dtype`` (JAX's
    ``promote_types(dtype, float32)``)."""
    return np.float64 if state_dtype == torch.float64 else np.float32


def _batch_time(x: torch.Tensor, t: float) -> torch.Tensor:
    """Scalar time -> a float32 ``[B]`` vector on x's device (the model takes [B])."""
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    return torch.full((x.shape[0],), t, dtype=dtype, device=x.device)


def _in(dtype: torch.dtype, value: float) -> float:
    """``value`` rounded to ``dtype`` (the JAX code's ``h.astype(x.dtype)``)."""
    return torch.tensor(value, dtype=dtype).item()


def _masked(dxdt: torch.Tensor, frozen_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if frozen_mask is None:
        return dxdt
    return torch.where(frozen_mask, torch.zeros_like(dxdt), dxdt)


def _euler_step(f: VelocityFn, x: torch.Tensor, t: float, h: float) -> torch.Tensor:
    return x + _in(x.dtype, h) * f(x, _batch_time(x, t))


# Explicit Runge-Kutta tableaux (A lower-triangular, b weights, c nodes)
_TABLEAUX = {
    "heun": (
        ((0.0, 0.0), (1.0, 0.0)),
        (0.5, 0.5),
        (0.0, 1.0),
    ),
    "midpoint": (
        ((0.0, 0.0), (0.5, 0.0)),
        (0.0, 1.0),
        (0.0, 0.5),
    ),
    "rk4": (
        ((0.0, 0.0, 0.0, 0.0),
         (0.5, 0.0, 0.0, 0.0),
         (0.0, 0.5, 0.0, 0.0),
         (0.0, 0.0, 1.0, 0.0)),
        (1 / 6, 1 / 3, 1 / 3, 1 / 6),
        (0.0, 0.5, 0.5, 1.0),
    ),
}


def _make_tableau_step(a_rows, b_weights, c_nodes):
    """A stepper for one tableau, JAX's arithmetic: the stages stack in a
    ``[s, B, ...]`` buffer of the state's dtype, each stage's increment is the
    tableau row (float32, then the state's dtype) contracted with the whole
    stack (the rows' zeros mask the stages still to come), and the stage times
    ``t + c_i h`` stay in the time dtype."""
    s = len(b_weights)
    c32 = np.asarray(c_nodes, np.float32)

    def step(f: VelocityFn, x: torch.Tensor, t: float, h: float) -> torch.Tensor:
        tdt = _time_dtype(x.dtype)
        a = torch.tensor(a_rows, dtype=torch.float32).to(device=x.device, dtype=x.dtype)
        b = torch.tensor(b_weights, dtype=torch.float32).to(device=x.device, dtype=x.dtype)
        hx = _in(x.dtype, h)
        ks = x.new_zeros((s, *x.shape))
        for i in range(s):
            xi = x + hx * torch.tensordot(a[i], ks, dims=1)
            ks[i] = f(xi, _batch_time(x, float(tdt(t) + tdt(c32[i]) * tdt(h))))
        return x + hx * torch.tensordot(b, ks, dims=1)

    return step


def _rk4_lean_step(f: VelocityFn, x: torch.Tensor, t: float, h: float) -> torch.Tensor:
    """Classic RK4 ``x + h(k1 + 2k2 + 2k3 + k4)/6`` holding only {x, acc, k}."""
    tdt = _time_dtype(x.dtype)
    half = float(tdt(h) * tdt(0.5))
    t_half = float(tdt(t) + tdt(half))
    t_full = float(tdt(t) + tdt(h))
    hx = _in(x.dtype, h)
    half_x = _in(x.dtype, hx * 0.5)
    k = f(x, _batch_time(x, t))                       # k1
    acc = k
    k = f(x + half_x * k, _batch_time(x, t_half))     # k2
    acc = acc + 2.0 * k
    k = f(x + half_x * k, _batch_time(x, t_half))     # k3
    acc = acc + 2.0 * k
    k = f(x + hx * k, _batch_time(x, t_full))         # k4
    return x + _in(x.dtype, hx / 6.0) * (acc + k)


_STEPPERS = {
    "euler": (_euler_step, 1),
    "heun": (_make_tableau_step(*_TABLEAUX["heun"]), 2),
    "midpoint": (_make_tableau_step(*_TABLEAUX["midpoint"]), 2),
    # the memory-lean RK4 is the default; the tableau form stays for A/B
    "rk4": (_rk4_lean_step, 4),
    "rk4_tableau": (_make_tableau_step(*_TABLEAUX["rk4"]), 4),
}


def stages(method: str) -> int:
    """Velocity evaluations per step of ``method``."""
    return _stepper(method)[1]


def _stepper(method: str):
    if method not in _STEPPERS:
        raise ValueError(f"unknown method {method!r}; options: {sorted(_STEPPERS)}")
    return _STEPPERS[method]


def frame_grid(state_dtype: torch.dtype, t0: float, tf: float, n_frames: int,
               substeps: int) -> Tuple[np.ndarray, float]:
    """The frame times and the step ``h``, in float32 (float64 for a float64 state)."""
    tdt = _time_dtype(state_dtype)
    frame_ts = np.linspace(t0, tf, n_frames, dtype=np.float64).astype(tdt)
    if n_frames > 1:
        h = (frame_ts[1] - frame_ts[0]) / tdt(substeps)
    else:
        h = tdt(0.0)
    return frame_ts, float(h)


def make_frame_advancer(velocity_fn: VelocityFn, *, substeps: int = 1, method: str = "rk4",
                        frozen_mask: Optional[torch.Tensor] = None):
    """``advance(x, t_start, h) -> x``: the ``substeps`` integrator steps of one
    frame from ``t_start``, the body :func:`solve_ode_final` loops over. Fed
    :func:`frame_grid`'s ``frame_ts[i]`` and ``h`` it visits the same times and
    gives the same state bit for bit."""
    stepper, _ = _stepper(method)
    # the velocity is cast to the state's dtype (a bf16 state stays bf16)
    f = lambda x, t: _masked(velocity_fn(x, t), frozen_mask).to(x.dtype)

    def advance(x: torch.Tensor, t_start: float, h: float) -> torch.Tensor:
        tdt = _time_dtype(x.dtype)
        for i in range(substeps):
            x = stepper(f, x, float(tdt(t_start) + tdt(i) * tdt(h)), h)
        return x

    return advance


def _frames(velocity_fn: VelocityFn, x0: torch.Tensor, t0: float, tf: float,
            n_frames: int, substeps: int, method: str, frozen_mask=None):
    """Yields the state at the end of each frame interval."""
    advance = make_frame_advancer(velocity_fn, substeps=substeps, method=method,
                                  frozen_mask=frozen_mask)
    frame_ts, h = frame_grid(x0.dtype, t0, tf, n_frames, substeps)
    x = x0
    for t_start in frame_ts[:-1]:
        x = advance(x, float(t_start), h)
        yield x


def solve_ode(velocity_fn: VelocityFn, x0: torch.Tensor, *, t0: float = 0.0,
              tf: float = 1.0, n_frames: int = 16, substeps: int = 1,
              method: str = "rk4", frozen_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integrate ``dx/dt = velocity_fn(x, t)``; trajectory ``[n_frames, B, ...]``,
    frame 0 = x0. NFE = ``(n_frames - 1) * substeps * stages(method)``."""
    frames: List[torch.Tensor] = [x0]
    frames += list(_frames(velocity_fn, x0, t0, tf, n_frames, substeps, method, frozen_mask))
    return torch.stack(frames, dim=0)


def solve_ode_final(velocity_fn: VelocityFn, x0: torch.Tensor, *, t0: float = 0.0,
                    tf: float = 1.0, n_frames: int = 16, substeps: int = 1,
                    method: str = "rk4",
                    frozen_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Like :func:`solve_ode` but keeps only the final state ``[B, ...]``."""
    x = x0
    for x in _frames(velocity_fn, x0, t0, tf, n_frames, substeps, method, frozen_mask):
        pass
    return x


def solve_ode_adaptive(velocity_fn: VelocityFn, x0: torch.Tensor, *, t0: float = 0.0,
                       tf: float = 1.0, n_frames: int = 16, atol: float = 1e-6,
                       rtol: float = 1e-6, frozen_mask: Optional[torch.Tensor] = None,
                       max_steps: int = 4096) -> Tuple[torch.Tensor, int]:
    """Adaptive dopri5 on the save grid ``linspace(t0, tf, n_frames)``:
    ``(trajectory [n_frames, B, ...], nfe)``. A negative ``nfe`` says that a
    segment reached ``max_steps`` attempts before its end time (the trajectory's
    tail is then truncated: a failed solve)."""
    f = lambda x, t: _masked(velocity_fn(x, _batch_time(x, t)), frozen_mask).to(x.dtype)
    ts = np.linspace(t0, tf, n_frames, dtype=np.float64).astype(_time_dtype(x0.dtype))
    return dopri5_integrate(f, x0, ts, atol=atol, rtol=rtol, max_steps=max_steps)


def _one_sided(interpolant: Interpolant) -> None:
    if not interpolant.one_sided:
        raise ValueError("denoising solvers require a one-sided interpolant")


def _schedule(interpolant: Interpolant, t: torch.Tensor, x: torch.Tensor):
    """alpha, beta and their derivatives at ``t [B]``, shaped to broadcast on x."""
    tb = t.reshape(t.shape[0], *([1] * (x.ndim - 1)))
    return (interpolant.alpha(tb), interpolant.beta(tb),
            interpolant.alpha_dot(tb), interpolant.beta_dot(tb))


def denoiser_to_velocity(denoiser_fn: VelocityFn, interpolant: Interpolant) -> VelocityFn:
    """The velocity of a one-sided denoiser ``eta(x, t)``, eq (6.7) of
    arXiv:2303.08797: ``alpha_dot·eta + (beta_dot / beta)(x - alpha·eta)``."""
    _one_sided(interpolant)

    def velocity(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        eta = denoiser_fn(x, t)
        a, b, a_dot, b_dot = _schedule(interpolant, t, x)
        return a_dot * eta + (b_dot / b) * (x - a * eta)

    return velocity


def velocity_to_denoiser(velocity_fn: VelocityFn, interpolant: Interpolant) -> VelocityFn:
    """The one-sided denoiser ``eta = E[X0 | x_t]`` of a velocity model, the
    inverse of :func:`denoiser_to_velocity`:
    ``eta = (beta·v - beta_dot·x) / (beta·alpha_dot - beta_dot·alpha)``, whose
    denominator (the schedule's Wronskian, -1 for the linear one-sided
    interpolant) never divides by ``beta(t) -> 0``."""
    _one_sided(interpolant)

    def denoiser(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        v = velocity_fn(x, t)
        a, b, a_dot, b_dot = _schedule(interpolant, t, x)
        return (b * v - b_dot * x) / (b * a_dot - b_dot * a)

    return denoiser


def solve_denoising_ode(denoiser_fn: VelocityFn, interpolant: Interpolant, x0: torch.Tensor,
                        *, t0: float = 0.0, tf: float = 1.0, n_frames: int = 32,
                        substeps: int = 2, method: str = "rk4", adaptive: bool = False,
                        atol: float = 1e-6, rtol: float = 1e-6):
    """The one-sided denoiser's ODE: a trajectory, or ``(trajectory, nfe)`` with
    ``adaptive``."""
    velocity = denoiser_to_velocity(denoiser_fn, interpolant)
    if adaptive:
        return solve_ode_adaptive(velocity, x0, t0=t0, tf=tf, n_frames=n_frames,
                                  atol=atol, rtol=rtol)
    return solve_ode(velocity, x0, t0=t0, tf=tf, n_frames=n_frames, substeps=substeps,
                     method=method)


def eps_schedule(name: str, epsilon: float) -> Callable[[float], float]:
    """A named diffusion strength ``eps(t)`` for the SDE samplers, in float32:

    * ``constant``: ``epsilon``;
    * ``linear_decay``: ``epsilon·(1 - t)``, which keeps the drift's
      ``eps(t)·score = -epsilon·eta`` bounded as t -> 1 for the linear
      one-sided schedule and switches the diffusion off at the end.
    """
    eps32 = np.float32(epsilon)
    if name == "constant":
        return lambda t: float(eps32)
    if name == "linear_decay":
        return lambda t: float(eps32 * (np.float32(1.0) - np.float32(t)))
    raise ValueError(f"unknown eps schedule {name!r}")


def _noise_source(generator: Optional[torch.Generator], noise: Optional[NoiseFn],
                  device: torch.device) -> NoiseFn:
    if noise is not None:
        return lambda i, shape, dtype: noise(i, shape, dtype).to(device)
    if generator is None:
        raise ValueError("the SDE samplers take a torch.Generator (or a noise callable) "
                         "for their Brownian increments")
    return lambda i, shape, dtype: torch.randn(shape, generator=generator, dtype=dtype,
                                               device=device)


def _euler_maruyama(drift, x0: torch.Tensor, draw: NoiseFn, eps_fn, *, t0: float, tf: float,
                    n_frames: int, substeps: int):
    """Yields the state at the end of each frame of
    ``x += (h·drift(x, t)).to(dtype) + (sqrt(h)·sqrt(2·eps(t))).to(dtype)·noise``;
    the drift is formed in >= float32, the noise drawn in the state's dtype."""
    dtype = x0.dtype
    tdt = _time_dtype(dtype)
    frame_ts, h = frame_grid(dtype, t0, tf, n_frames, substeps)
    sqrt_h = np.sqrt(np.abs(tdt(h)))
    x, step = x0, 0
    for t_start in frame_ts[:-1]:
        for i in range(substeps):
            t = float(tdt(t_start) + tdt(i) * tdt(h))
            noise = draw(step, tuple(x.shape), dtype)
            diffusion = np.sqrt(np.float32(2.0) * np.maximum(np.float32(eps_fn(t)), np.float32(0.0)))
            scale = _in(dtype, float(sqrt_h * tdt(diffusion)))
            x = x + (float(h) * drift(x, t)).to(dtype) + scale * noise
            step += 1
        yield x


def _eps_fn(epsilon: Epsilon) -> Callable[[float], float]:
    return epsilon if callable(epsilon) else (lambda t: epsilon)


def solve_denoising_sde(denoiser_fn: VelocityFn, interpolant: Interpolant, x0: torch.Tensor,
                        generator: Optional[torch.Generator] = None, *,
                        noise: Optional[NoiseFn] = None, epsilon: Epsilon = 1.0,
                        t0: float = 0.0, tf: float = 1.0, n_frames: int = 32,
                        substeps: int = 2) -> torch.Tensor:
    """Euler–Maruyama sampling from a one-sided denoiser: drift the eq-(6.7)
    velocity plus ``eps(t)·score`` with score ``-eta / alpha``, diffusion
    ``sqrt(2·eps(t)) dW`` with the ``sqrt(dt)`` scaling; the trajectory
    ``[n_frames, B, ...]``. ``epsilon`` is a float or a callable ``t -> eps``."""
    _one_sided(interpolant)
    eps_fn = _eps_fn(epsilon)

    def drift(x, t):
        tv = _batch_time(x, t)
        eta = denoiser_fn(x, tv)
        a, b, a_dot, b_dot = _schedule(interpolant, tv, x)
        v = a_dot * eta + (b_dot / b) * (x - a * eta)
        return v + eps_fn(t) * (-eta / a)

    frames = [x0] + list(_euler_maruyama(
        drift, x0, _noise_source(generator, noise, x0.device), eps_fn, t0=t0, tf=tf,
        n_frames=n_frames, substeps=substeps))
    return torch.stack(frames, dim=0)


def solve_velocity_sde(velocity_fn: VelocityFn, interpolant: Interpolant, x0: torch.Tensor,
                       generator: Optional[torch.Generator] = None, *,
                       noise: Optional[NoiseFn] = None, epsilon: Epsilon = 1.0,
                       t0: float = 0.0, tf: float = 1.0, n_frames: int = 32,
                       substeps: int = 2, keep_trajectory: bool = True) -> torch.Tensor:
    """Euler–Maruyama sampling of a velocity model: drift ``v + eps(t)·score``
    with the score recovered as in :func:`velocity_to_denoiser` (``-eta /
    alpha``), diffusion ``sqrt(2·eps(t)) dW``. With ``epsilon == 0`` it is the
    Euler ODE on the same grid. ``keep_trajectory=False`` returns only the final
    state ``[B, ...]``."""
    _one_sided(interpolant)
    eps_fn = _eps_fn(epsilon)

    def drift(x, t):
        tv = _batch_time(x, t)
        v = velocity_fn(x, tv)
        a, b, a_dot, b_dot = _schedule(interpolant, tv, x)
        eta = (b * v - b_dot * x) / (b * a_dot - b_dot * a)
        return v + eps_fn(t) * (-eta / a)

    states = _euler_maruyama(drift, x0, _noise_source(generator, noise, x0.device), eps_fn,
                             t0=t0, tf=tf, n_frames=n_frames, substeps=substeps)
    if keep_trajectory:
        return torch.stack([x0, *states], dim=0)
    x = x0
    for x in states:
        pass
    return x


def ode_sol_rk4(x0: torch.Tensor, velocity_fn: VelocityFn, nsteps: int = 100,
                tf: float = 1.0) -> torch.Tensor:
    """Fixed-step RK4 with the trajectory ``[nsteps, ...]``, the reference's
    ``odeSol_RK4``: ``nsteps - 1`` steps of ``h = tf / nsteps`` from t = 0. The
    velocity is used as it comes (not cast to the state's dtype)."""
    tdt = _time_dtype(x0.dtype)
    h = float(tdt(tf / nsteps))
    frames, x, t = [x0], x0, tdt(0.0)
    for _ in range(nsteps - 1):
        x = _rk4_lean_step(velocity_fn, x, float(t), h)
        t = tdt(t + tdt(h))
        frames.append(x)
    return torch.stack(frames, dim=0)


class ODEFlowSolver:
    """The reference's ``ODEFlowSolver`` API over :func:`solve_ode` and
    :func:`solve_ode_adaptive`: construct with a model, call
    ``solve(x0, frozen_mask, t0, tf, n_steps)`` for the trajectory."""

    def __init__(self, model: VelocityFn, atol: float = 1e-6, rtol: float = 1e-6,
                 adaptive: bool = False, method: str = "rk4", substeps: int = 2):
        self.model = model
        self.atol = atol
        self.rtol = rtol
        self.adaptive = adaptive
        self.method = method
        self.substeps = substeps

    def solve(self, x0, frozen_mask=None, t0=0.0, tf=1.0, n_steps=32):
        if self.adaptive:
            traj, _ = solve_ode_adaptive(self.model, x0, t0=t0, tf=tf, n_frames=n_steps,
                                         atol=self.atol, rtol=self.rtol,
                                         frozen_mask=frozen_mask)
            return traj
        return solve_ode(self.model, x0, t0=t0, tf=tf, n_frames=n_steps,
                         substeps=self.substeps, method=self.method, frozen_mask=frozen_mask)


__all__ = [
    "frame_grid",
    "make_frame_advancer",
    "solve_ode",
    "solve_ode_final",
    "solve_ode_adaptive",
    "solve_denoising_ode",
    "solve_denoising_sde",
    "solve_velocity_sde",
    "denoiser_to_velocity",
    "velocity_to_denoiser",
    "eps_schedule",
    "ode_sol_rk4",
    "ODEFlowSolver",
    "dopri5_integrate",
    "stages",
]
