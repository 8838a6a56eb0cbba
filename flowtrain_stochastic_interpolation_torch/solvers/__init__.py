"""Fixed-step ODE integrators for a learned velocity field.

Port of the fixed-NFE part of ``flowtrain_stochastic_interpolation_tpu/
solvers/__init__.py``: Euler and the memory-lean RK4 (``_rk4_lean_step``),
:func:`frame_grid`, :func:`solve_ode` (trajectory on the frame grid) and
:func:`solve_ode_final` (final state only). PyTorch runs eagerly, so the JAX
package's ``lax.scan`` / ``fori_loop`` are Python loops here.

Times stay in float32 (or wider) whatever the state's dtype; the state's
arithmetic runs in the state's dtype, with the step constants rounded to it
first, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

VelocityFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x [B,...], t [B]) -> dx/dt


def _batch_time(x: torch.Tensor, t: float) -> torch.Tensor:
    """Scalar time -> a float32 ``[B]`` vector on x's device (the model takes [B])."""
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    return torch.full((x.shape[0],), t, dtype=dtype, device=x.device)


def _in(dtype: torch.dtype, value: float) -> float:
    """``value`` rounded to ``dtype`` (the JAX code's ``h.astype(x.dtype)``)."""
    return torch.tensor(value, dtype=dtype).item()


def _euler_step(f: VelocityFn, x: torch.Tensor, t: float, h: float) -> torch.Tensor:
    return x + _in(x.dtype, h) * f(x, _batch_time(x, t))


def _rk4_lean_step(f: VelocityFn, x: torch.Tensor, t: float, h: float) -> torch.Tensor:
    """Classic RK4 ``x + h(k1 + 2k2 + 2k3 + k4)/6`` holding only {x, acc, k}."""
    time_dtype = np.float64 if x.dtype == torch.float64 else np.float32
    half = float(time_dtype(h) * time_dtype(0.5))
    t_half = float(time_dtype(t) + time_dtype(half))
    t_full = float(time_dtype(t) + time_dtype(h))
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
    "rk4": (_rk4_lean_step, 4),
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
    time_dtype = np.float64 if state_dtype == torch.float64 else np.float32
    frame_ts = np.linspace(t0, tf, n_frames, dtype=np.float64).astype(time_dtype)
    if n_frames > 1:
        h = (frame_ts[1] - frame_ts[0]) / time_dtype(substeps)
    else:
        h = time_dtype(0.0)
    return frame_ts, float(h)


def _frames(velocity_fn: VelocityFn, x0: torch.Tensor, t0: float, tf: float,
            n_frames: int, substeps: int, method: str):
    """Yields the state at the end of each frame interval."""
    stepper, _ = _stepper(method)
    # the velocity is cast to the state's dtype (a bf16 state stays bf16)
    f = lambda x, t: velocity_fn(x, t).to(x.dtype)
    frame_ts, h = frame_grid(x0.dtype, t0, tf, n_frames, substeps)
    time_dtype = frame_ts.dtype.type
    x = x0
    for t_start in frame_ts[:-1]:
        for i in range(substeps):
            t = float(time_dtype(t_start) + time_dtype(i) * time_dtype(h))
            x = stepper(f, x, t, h)
        yield x


def solve_ode(velocity_fn: VelocityFn, x0: torch.Tensor, *, t0: float = 0.0,
              tf: float = 1.0, n_frames: int = 16, substeps: int = 1,
              method: str = "rk4") -> torch.Tensor:
    """Integrate ``dx/dt = velocity_fn(x, t)``; trajectory ``[n_frames, B, ...]``, frame 0 = x0."""
    frames: List[torch.Tensor] = [x0]
    frames += list(_frames(velocity_fn, x0, t0, tf, n_frames, substeps, method))
    return torch.stack(frames, dim=0)


def solve_ode_final(velocity_fn: VelocityFn, x0: torch.Tensor, *, t0: float = 0.0,
                    tf: float = 1.0, n_frames: int = 16, substeps: int = 1,
                    method: str = "rk4") -> torch.Tensor:
    """Like :func:`solve_ode` but keeps only the final state ``[B, ...]``."""
    x = x0
    for x in _frames(velocity_fn, x0, t0, tf, n_frames, substeps, method):
        pass
    return x
