"""One differentiable four-stage SRI step (diagonal Itô noise).

Counterpart of ``localregneuralde_tpu/sde/step.py::sri_step`` (reference
``src/perform_step.jl:49-106``) for the SRIW1 and SOSRI tableaus. The step
returns the new state and the embedded error estimate ``eest``, the
tolerance-scaled RMS of the δ-weighted drift and diffusion error parts; the
local regulariser is ``eest · dt``. The commutative Milstein and
Lamba–Euler–Heun steps are not ported yet (ROADMAP).

Dynamics: ``f(u, t) -> du`` and ``g(u, t) -> gu`` with ``gu`` shaped like
``u`` (diagonal noise). Four drift and four diffusion evaluations.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.residuals import internal_norm, sde_error_residuals
from .tableaus import SRIW1Tableau

SQRT3 = math.sqrt(3.0)


class SDEStepResult(NamedTuple):
    u_new: torch.Tensor
    eest: torch.Tensor  # tolerance-scaled error norm (accept iff ≤ 1)


def sri_step(f, g, u, t, dt, dW, dZ, atol, rtol, delta: float = 1 / 6,
             tableau=None) -> SDEStepResult:
    """One SRI step from ``(u, t)`` over ``dt`` with the Brownian
    increments ``(dW, dZ)``; the expressions and their order are the JAX
    package's, so both round alike."""
    T = tableau if tableau is not None else SRIW1Tableau
    sqdt = torch.sqrt(dt)
    chi1 = (dW ** 2 - torch.abs(dt)) / (2 * sqdt)   # I_(1,1)/√h
    chi2 = (dW + dZ / SQRT3) / 2                     # I_(1,0)/h
    chi3 = (dW ** 3 - 3 * dW * dt) / (6 * dt)        # I_(1,1,1)/h

    k1 = f(u, t)
    g1 = g(u, t + T.c11 * dt)
    H01 = u + dt * T.a021 * k1 + T.b021 * chi2 * g1
    H11 = u + dt * T.a121 * k1 + sqdt * T.b121 * g1
    k2 = f(H01, t + T.c02 * dt)
    g2 = g(H11, t + T.c12 * dt)
    H02 = u + dt * (T.a031 * k1 + T.a032 * k2) + chi2 * (
        T.b031 * g1 + T.b032 * g2
    )
    H12 = u + dt * (T.a131 * k1 + T.a132 * k2) + sqdt * (
        T.b131 * g1 + T.b132 * g2
    )
    k3 = f(H02, t + T.c03 * dt)
    g3 = g(H12, t + T.c13 * dt)
    H03 = u + dt * (T.a041 * k1 + T.a042 * k2 + T.a043 * k3) + chi2 * (
        T.b041 * g1 + T.b042 * g2 + T.b043 * g3
    )
    H13 = u + dt * (T.a141 * k1 + T.a142 * k2 + T.a143 * k3) + sqdt * (
        T.b141 * g1 + T.b142 * g2 + T.b143 * g3
    )
    k4 = f(H03, t + T.c04 * dt)
    g4 = g(H13, t + T.c14 * dt)

    E2 = chi2 * (T.beta31 * g1 + T.beta32 * g2 + T.beta33 * g3
                 + T.beta34 * g4) \
        + chi3 * (T.beta41 * g1 + T.beta42 * g2 + T.beta43 * g3
                  + T.beta44 * g4)
    u_new = (
        u
        + dt * (T.alpha1 * k1 + T.alpha2 * k2 + T.alpha3 * k3 + T.alpha4 * k4)
        + E2
        + dW * (T.beta11 * g1 + T.beta12 * g2 + T.beta13 * g3 + T.beta14 * g4)
        + chi1 * (T.beta21 * g1 + T.beta22 * g2 + T.beta23 * g3
                  + T.beta24 * g4)
    )
    E1 = dt * (k1 + k2 + k3 + k4)
    eest = internal_norm(sde_error_residuals(E1, E2, u, u_new, atol, rtol,
                                             delta))
    return SDEStepResult(u_new, eest)
