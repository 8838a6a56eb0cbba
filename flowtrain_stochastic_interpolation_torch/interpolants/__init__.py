"""Stochastic-interpolant schedules and the flow objective.

Port of ``flowtrain_stochastic_interpolation_tpu/interpolants``:
:func:`bcast_time`, the :class:`Interpolant` base (the alpha/beta/gamma
schedule and the objectives built from it), the five interpolants of
Albergo, Boffi & Vanden-Eijnden (arXiv:2303.08797, section 4) and the
:class:`StochasticInterpolator` wrapper:

==================  ===========================  ====================================
name                alpha / beta                 gamma
==================  ===========================  ====================================
LinearInterpolant   1-t / t                      sqrt(a t (1-t)), 0 when one-sided
TrigInterpolant     cos(pi t/2) / sin(pi t/2)    sqrt(a t (1-t)), 0 when one-sided
EncDecInterpolant   cos^2(pi t) split at t=1/2   sin^2(pi t)
SBDMInterpolant     sqrt(1-t^2) / t              0 (one-sided)
MirrorInterpolant   0 / 1                        sqrt(a t (1-t))
==================  ===========================  ====================================

Everything is a pure function of ``(t, x0, x1[, z])``; ``t`` is a scalar or a
``[N]`` vector broadcast against the leading axis of the data.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

Time = Union[float, torch.Tensor]


def bcast_time(t: Time, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar or ``[N]`` time against data ``x``: ``[N] -> [N, 1, 1, ...]``."""
    t = torch.as_tensor(t, device=x.device)
    if t.ndim == 0:
        return t
    if t.ndim == 1:
        return t.reshape(t.shape[0], *([1] * (x.ndim - 1)))
    if t.ndim == x.ndim:
        return t
    raise ValueError(f"time must be scalar, [N], or data-rank; got {tuple(t.shape)}")


@dataclasses.dataclass(frozen=True)
class Interpolant:
    """Base class: the alpha/beta/gamma schedule of a spatially linear interpolant.

    ``one_sided=True`` means the initial point X0 *is* the latent noise (no
    separate Z); gamma is then identically zero and the score uses alpha.
    """

    one_sided: bool = False

    def alpha(self, t):
        raise NotImplementedError

    def beta(self, t):
        raise NotImplementedError

    def gamma(self, t):
        raise NotImplementedError

    def alpha_dot(self, t):
        raise NotImplementedError

    def beta_dot(self, t):
        raise NotImplementedError

    def gamma_dot(self, t):
        raise NotImplementedError

    def _check_z(self, z: Optional[torch.Tensor]) -> None:
        if not self.one_sided and z is None:
            raise ValueError("Z must be provided for two-sided interpolants")

    def get_xt(self, t: Time, x0: torch.Tensor, x1: torch.Tensor,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``XT = alpha*X0 + beta*X1 (+ gamma*Z)``: coefficients in t's dtype,
        then in the state's (a bf16 state stays bf16)."""
        self._check_z(z)
        tb = bcast_time(t, x0)
        xt = self.alpha(tb).to(x0.dtype) * x0 + self.beta(tb).to(x1.dtype) * x1
        if z is not None:
            xt = xt + self.gamma(tb).to(z.dtype) * z
        return xt

    def get_bt(self, t: Time, x0: torch.Tensor, x1: torch.Tensor,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Conditional velocity ``BT = alpha_dot*X0 + beta_dot*X1 (+ gamma_dot*Z)``."""
        self._check_z(z)
        tb = bcast_time(t, x0)
        bt = self.alpha_dot(tb).to(x0.dtype) * x0 + self.beta_dot(tb).to(x1.dtype) * x1
        if z is not None:
            bt = bt + self.gamma_dot(tb).to(z.dtype) * z
        return bt

    def flow_objective(self, t: Time, x0: torch.Tensor, x1: torch.Tensor,
                       z: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(XT, BT)``, the pair of velocity-matching training."""
        return self.get_xt(t, x0, x1, z), self.get_bt(t, x0, x1, z)

    def denoising_objective(self, t: Time, x0: torch.Tensor, x1: torch.Tensor,
                            z: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(XT, Z)`` for denoising training; one-sided uses X0 as the target."""
        xt = self.get_xt(t, x0, x1, z)
        target = x0 if self.one_sided else z
        if target is None:
            raise ValueError("Z must be provided for two-sided interpolants")
        return xt, target

    def get_st(self, t: Time, z: torch.Tensor) -> torch.Tensor:
        """Score ``ST = -Z / gamma`` (alpha when one-sided)."""
        tb = bcast_time(t, z)
        g = self.alpha(tb) if self.one_sided else self.gamma(tb)
        return -z / g

    def get_vt(self, t: Time, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        """Mean velocity without the latent term."""
        tb = bcast_time(t, x0)
        return self.alpha_dot(tb) * x0 + self.beta_dot(tb) * x1

    def get_bt_from_score(self, t: Time, vt: torch.Tensor, st: torch.Tensor) -> torch.Tensor:
        """``BT = VT - gamma_dot*gamma*ST``."""
        tb = bcast_time(t, vt)
        return vt - self.gamma_dot(tb) * self.gamma(tb) * st


def _as_time(t) -> torch.Tensor:
    t = torch.as_tensor(t)
    return t if t.is_floating_point() else t.float()


def _gamma_sqrt(t: torch.Tensor, a: float) -> torch.Tensor:
    return torch.sqrt(a * t * (1.0 - t))


def _gamma_sqrt_dot(t: torch.Tensor, a: float) -> torch.Tensor:
    return 0.5 * a * (1.0 - 2.0 * t) / torch.sqrt(a * t * (1.0 - t))


@dataclasses.dataclass(frozen=True)
class LinearInterpolant(Interpolant):
    """alpha = 1 - t, beta = t, gamma = sqrt(a t (1 - t))."""

    gamma_a: float = 2.0

    def alpha(self, t):
        return 1.0 - _as_time(t)

    def beta(self, t):
        return _as_time(t) * 1.0

    def gamma(self, t):
        t = _as_time(t)
        if self.one_sided:
            return torch.zeros_like(t)
        return _gamma_sqrt(t, self.gamma_a)

    def alpha_dot(self, t):
        return -torch.ones_like(_as_time(t))

    def beta_dot(self, t):
        return torch.ones_like(_as_time(t))

    def gamma_dot(self, t):
        t = _as_time(t)
        if self.one_sided:
            return torch.zeros_like(t)
        return _gamma_sqrt_dot(t, self.gamma_a)


@dataclasses.dataclass(frozen=True)
class TrigInterpolant(Interpolant):
    """alpha = cos(pi t / 2), beta = sin(pi t / 2), gamma as the linear one's."""

    gamma_a: float = 2.0

    def alpha(self, t):
        return torch.cos(math.pi * _as_time(t) / 2.0)

    def beta(self, t):
        return torch.sin(math.pi * _as_time(t) / 2.0)

    def gamma(self, t):
        t = _as_time(t)
        if self.one_sided:
            return torch.zeros_like(t)
        return _gamma_sqrt(t, self.gamma_a)

    def alpha_dot(self, t):
        return -math.pi / 2.0 * torch.sin(math.pi * _as_time(t) / 2.0)

    def beta_dot(self, t):
        return math.pi / 2.0 * torch.cos(math.pi * _as_time(t) / 2.0)

    def gamma_dot(self, t):
        t = _as_time(t)
        if self.one_sided:
            return torch.zeros_like(t)
        return _gamma_sqrt_dot(t, self.gamma_a)


@dataclasses.dataclass(frozen=True)
class EncDecInterpolant(Interpolant):
    """Encode-decode: alpha and beta are cos^2(pi t), split at t = 1/2;
    gamma = sin^2(pi t)."""

    def alpha(self, t):
        t = _as_time(t)
        return torch.where(t < 0.5, torch.cos(math.pi * t) ** 2, torch.zeros_like(t))

    def beta(self, t):
        t = _as_time(t)
        return torch.where(t > 0.5, torch.cos(math.pi * t) ** 2, torch.zeros_like(t))

    def gamma(self, t):
        return torch.sin(math.pi * _as_time(t)) ** 2

    def alpha_dot(self, t):
        t = _as_time(t)
        return torch.where(t < 0.5, -math.pi * torch.sin(2.0 * math.pi * t), torch.zeros_like(t))

    def beta_dot(self, t):
        t = _as_time(t)
        return torch.where(t > 0.5, -math.pi * torch.sin(2.0 * math.pi * t), torch.zeros_like(t))

    def gamma_dot(self, t):
        return math.pi * torch.sin(2.0 * math.pi * _as_time(t))


@dataclasses.dataclass(frozen=True)
class SBDMInterpolant(Interpolant):
    """Score-based diffusion: alpha = sqrt(1 - t^2), beta = t; one-sided."""

    one_sided: bool = True

    def alpha(self, t):
        return torch.sqrt(1.0 - _as_time(t) ** 2)

    def beta(self, t):
        return _as_time(t) * 1.0

    def gamma(self, t):
        return torch.zeros_like(_as_time(t))

    def alpha_dot(self, t):
        t = _as_time(t)
        return -t / torch.sqrt(1.0 - t ** 2)

    def beta_dot(self, t):
        return torch.ones_like(_as_time(t))

    def gamma_dot(self, t):
        return torch.zeros_like(_as_time(t))


@dataclasses.dataclass(frozen=True)
class MirrorInterpolant(Interpolant):
    """Mirror: alpha = 0, beta = 1, gamma = sqrt(a t (1 - t))."""

    gamma_a: float = 2.0

    def alpha(self, t):
        return torch.zeros_like(_as_time(t))

    def beta(self, t):
        return torch.ones_like(_as_time(t))

    def gamma(self, t):
        return _gamma_sqrt(_as_time(t), self.gamma_a)

    def alpha_dot(self, t):
        return torch.zeros_like(_as_time(t))

    def beta_dot(self, t):
        return torch.zeros_like(_as_time(t))

    def gamma_dot(self, t):
        return _gamma_sqrt_dot(_as_time(t), self.gamma_a)


class StochasticInterpolator:
    """The reference's class API over an :class:`Interpolant`, whose methods
    hold the math."""

    def __init__(self, interpolant: Interpolant):
        self.interp = interpolant

    def __repr__(self) -> str:
        return f"StochasticInterpolator({self.interp})"

    def flow_objective(self, t, x0, x1, z=None):
        return self.interp.flow_objective(t, x0, x1, z)

    def denoising_objective(self, t, x0, x1, z=None):
        return self.interp.denoising_objective(t, x0, x1, z)

    def get_XT(self, t, x0, x1, z=None):
        return self.interp.get_xt(t, x0, x1, z)

    def get_BT(self, t, x0, x1, z=None):
        return self.interp.get_bt(t, x0, x1, z)

    def get_ST(self, t, z):
        return self.interp.get_st(t, z)

    def get_VT(self, t, x0, x1):
        return self.interp.get_vt(t, x0, x1)

    def get_BT_from_score(self, t, vt, st):
        return self.interp.get_bt_from_score(t, vt, st)


INTERPOLANTS = {
    "linear": LinearInterpolant,
    "trig": TrigInterpolant,
    "encdec": EncDecInterpolant,
    "sbdm": SBDMInterpolant,
    "mirror": MirrorInterpolant,
}
