"""Adaptive Dormand–Prince 5(4), its controller on the host.

Port of ``flowtrain_stochastic_interpolation_tpu/solvers/dopri5.py``. JAX
runs the controller as a device ``while_loop`` inside a ``scan`` over the save
grid's segments; here it is a host loop, one attempt at a time. Each attempt
makes six evaluations, forms the RMS error norm over the whole batch (one step
size for the batch, as in JAX) and reads that one number back.

JAX's constants, its first-same-as-last reuse (an accepted step's seventh stage
is the next step's first) and its NFE count are kept: 1 + 6 per attempt, negated
when a segment reaches ``max_steps`` attempts before its end time. Error control
is torchdiffeq's: ``rms(err / (atol + rtol·max(|y|, |y_new|)))`` with safety
0.9 and the step factor clamped to [0.2, 10].

The controller's arithmetic (times, step sizes, the factor) is float32 on the
host, JAX's ``time_dtype``, so that it accepts the steps JAX accepts; the state
updates run in the state's dtype with each coefficient ``dt·a_ij`` rounded to
it first, as JAX's ``dt.astype(y.dtype) * a_ij`` is. The sums skip the
tableau's zero coefficients (JAX adds ``0·k``, which changes no finite value),
and the new state is the seventh stage's input, which JAX computes twice.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

# Dormand–Prince 5(4) Butcher tableau
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
# 5th-order solution weights == last row of A (FSAL property)
_B5 = _A[6]
# 4th-order embedded weights
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
_E = tuple(b5 - b4 for b5, b4 in zip(_B5 + (0.0,), _B4))

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0
_ORDER = 5.0


def _error_norm(err: torch.Tensor, y0: torch.Tensor, y1: torch.Tensor, atol: float,
                rtol: float) -> torch.Tensor:
    """The RMS of ``err / (atol + rtol·max(|y0|, |y1|))`` over the whole tensor,
    in float32 after the upcast (a bf16 state keeps JAX's controller)."""
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs()).float()
    r = err.float() / scale
    return torch.sqrt(torch.mean(r * r))


def _coefficient(dtype: torch.dtype, dt: np.floating, c: float) -> float:
    """JAX's ``dt.astype(dtype) * c``: dt and c each rounded to ``dtype``, their
    product rounded to it."""
    return (torch.tensor(float(dt), dtype=torch.float32).to(dtype)
            * torch.tensor(c, dtype=dtype)).item()


def _combine(y: torch.Tensor, dt: np.floating, weights: Sequence[float],
             ks: Sequence[torch.Tensor]) -> torch.Tensor:
    """``y + Σ (dt·w_j)·k_j`` in y's dtype, term by term in order."""
    for w, k in zip(weights, ks):
        if w != 0.0:
            y = y + _coefficient(y.dtype, dt, w) * k
    return y


def dopri5_integrate(f: Callable[[torch.Tensor, float], torch.Tensor], y0: torch.Tensor,
                     ts: np.ndarray, *, atol: float = 1e-6, rtol: float = 1e-6,
                     max_steps: int = 4096) -> Tuple[torch.Tensor, int]:
    """Integrate ``dy/dt = f(y, t)`` saving the solution at each ``ts[i]``.

    ``f`` takes the state and a float time. ``ts`` is a strictly increasing
    save grid (numpy); ``max_steps`` caps each segment's attempts, accepted and
    rejected. Returns ``(ys [len(ts), *y0.shape], nfe)``; ``nfe`` is negative
    when any segment was truncated by ``max_steps``.
    """
    tdt = np.promote_types(np.asarray(ts).dtype, np.float32).type
    ts = np.asarray(ts, dtype=tdt)
    t = ts[0]
    k1 = f(y0, float(t))
    dt = tdt(ts[-1] - ts[0]) / tdt(max(len(ts) * 4, 32))
    nfe, truncated = 1, False
    y, ys = y0, [y0]
    for t_end in ts[1:]:
        limit = t_end - tdt(1e-12)  # JAX's `t < t_end - 1e-12`, in the time dtype
        attempts = 0
        while t < limit and attempts < max_steps:
            dt_c = min(dt, tdt(t_end - t))
            ks = [k1]
            for i in range(1, 7):
                yi = _combine(y, dt_c, _A[i], ks)
                ks.append(f(yi, float(tdt(t + tdt(_C[i]) * dt_c))))
            y_new = yi  # the seventh stage's input: the 5th-order solution (B5 == A[6])
            err = _combine(torch.zeros_like(y), dt_c, _E, ks)
            norm = np.float32(_error_norm(err, y, y_new, atol, rtol).item())
            factor = np.clip(
                np.float32(_SAFETY) * np.power(np.maximum(norm, np.float32(1e-10)),
                                               np.float32(-1.0 / _ORDER)),
                np.float32(_MIN_FACTOR), np.float32(_MAX_FACTOR)).astype(tdt)
            if norm <= 1.0:
                y, t, k1 = y_new, tdt(t + dt_c), ks[-1]
            dt = tdt(dt_c * factor)
            nfe += 6
            attempts += 1
        truncated |= bool(t < limit)
        ys.append(y)
    return torch.stack(ys, dim=0), (-nfe if truncated else nfe)
