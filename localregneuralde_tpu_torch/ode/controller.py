"""PI step-size controller and the Hairer initial-dt heuristic.

Counterpart of ``localregneuralde_tpu/ode/controller.py``. All scalars are
float32 0-d tensors, so the controller rounds as the reference's does. The
controller is outside autodiff by construction: the solver calls it on
detached values.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.residuals import internal_norm


class PIController(NamedTuple):
    gamma: float = 0.9
    qmin: float = 0.2
    qmax: float = 10.0
    beta1: float = 0.14   # 7 / (10 * 5) for a 5th-order pair
    beta2: float = 0.08   # 2 / (5 * 5)
    qoldinit: float = 1e-4

    def propose(self, eest, dt, qold):
        """Return ``(dt_accept, dt_reject, qold_accept)`` for the scaled
        error ``eest``; a non-finite ``eest`` halves the step."""
        finite = torch.isfinite(eest)
        eest_safe = torch.where(finite, torch.clamp_min(eest, 0.0), 1.0)
        q11 = torch.pow(eest_safe, self.beta1)
        q = q11 / torch.pow(qold, self.beta2)
        q = torch.clamp(q / self.gamma, min=1.0 / self.qmax, max=1.0 / self.qmin)
        dt_accept = torch.where(finite, dt / q, dt * 0.5)
        dt_reject = torch.where(
            finite, dt / torch.clamp_max(q11 / self.gamma, 1.0 / self.qmin),
            dt * 0.5,
        )
        qold_accept = torch.clamp_min(eest_safe, self.qoldinit)
        return dt_accept, dt_reject, qold_accept


def initial_step_size(f: Callable, u0, t0, order: int, rtol, atol, f0,
                      direction: float = 1.0, group=None):
    """Hairer–Nørsett–Wanner automatic initial step size (HNW II.4), given
    the derivative ``f0 = f(u0, t0)``; ``f(u, t)`` returns the derivative.
    Costs one dynamics evaluation. Returns ``(dt0, 1)``. With a
    ``DPGroup`` the norms are those of the whole distributed batch."""
    sc = atol + torch.abs(u0) * rtol
    d0 = internal_norm(u0 / sc, group)
    d1 = internal_norm(f0 / sc, group)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    dt0 = torch.where(small, 1e-6, 0.01 * d0 / torch.where(d1 == 0, 1.0, d1))
    u1 = u0 + direction * dt0 * f0
    f1 = f(u1, t0 + direction * dt0)
    d2 = internal_norm((f1 - f0) / sc, group) / dt0
    dmax = torch.maximum(d1, d2)
    dt1 = torch.where(
        dmax <= 1e-15,
        torch.clamp_min(dt0 * 1e-3, 1e-6),
        torch.pow(0.01 / dmax, 1.0 / (order + 1.0)),
    )
    return torch.minimum(100.0 * dt0, dt1), 1
