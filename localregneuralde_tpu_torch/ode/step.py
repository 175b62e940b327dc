"""One explicit Tsit5 step.

Counterpart of ``localregneuralde_tpu/ode/step.py`` (reference
``src/perform_step.jl:3-47``): the step and the local regulariser computed
from it. The dynamics convention is
``f(u, t, st) -> (du, st)``, where ``st`` is carried layer state; stateless
dynamics return it unchanged.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..ops.residuals import error_residuals, internal_norm
from .tableaus import Tsit5Tableau as T


class Tsit5StepResult(NamedTuple):
    u_new: Any    # 5th-order solution at t + dt
    utilde: Any   # embedded error estimate (b − bhat contraction)
    ks: tuple     # the seven stage derivatives k1..k7; k7 is the FSAL one
    g6: Any       # 6th stage argument
    f_state: Any  # dynamics state after the step


def tsit5_step(f: Callable, u, t, dt, k1, f_state) -> Tsit5StepResult:
    """One Tsit5 step from ``(u, t)`` with FSAL derivative ``k1``: six new
    dynamics evaluations; ``k7 = f(u_new, t + dt)`` is the next ``k1``."""
    st = f_state
    k2, st = f(u + dt * (T.a21 * k1), t + T.c1 * dt, st)
    k3, st = f(u + dt * (T.a31 * k1 + T.a32 * k2), t + T.c2 * dt, st)
    k4, st = f(u + dt * (T.a41 * k1 + T.a42 * k2 + T.a43 * k3), t + T.c3 * dt, st)
    k5, st = f(
        u + dt * (T.a51 * k1 + T.a52 * k2 + T.a53 * k3 + T.a54 * k4),
        t + T.c4 * dt, st,
    )
    g6 = u + dt * (T.a61 * k1 + T.a62 * k2 + T.a63 * k3 + T.a64 * k4 + T.a65 * k5)
    k6, st = f(g6, t + dt, st)
    u_new = u + dt * (
        T.a71 * k1 + T.a72 * k2 + T.a73 * k3 + T.a74 * k4 + T.a75 * k5 + T.a76 * k6
    )
    k7, st = f(u_new, t + dt, st)
    utilde = dt * (
        T.btilde1 * k1
        + T.btilde2 * k2
        + T.btilde3 * k3
        + T.btilde4 * k4
        + T.btilde5 * k5
        + T.btilde6 * k6
        + T.btilde7 * k7
    )
    return Tsit5StepResult(u_new, utilde, (k1, k2, k3, k4, k5, k6, k7), g6, st)


def regularization_value(reg_type: str, step: Tsit5StepResult, u_prev, dt,
                         atol, rtol, group=None) -> torch.Tensor:
    """The local regulariser of one step.

    ``error_estimate``: rms(ũ / (atol + max(|u₀|, |u₁|)·rtol)) · dt.
    ``stiffness_estimate``: rms(k7 − k6) / (rms(u_new − g6) + eps) /
    stability_size, not scaled by dt, and 0 where the denominator is zero
    or an operand is not finite. The fence sits on the norm inputs and on
    the output (a double ``where``), so the zeroed branch has zero, not NaN,
    gradients. With a ``DPGroup`` (the global grid) every norm is over the
    rows of all its ranks, and the finiteness test too.
    """
    if reg_type == "error_estimate":
        res = error_residuals(step.utilde, u_prev, step.u_new, atol, rtol)
        return internal_norm(res, group) * dt
    if reg_type == "stiffness_estimate":
        eps = torch.finfo(step.u_new.dtype).eps
        num_x = step.ks[6] - step.ks[5]
        den_x = step.u_new - step.g6
        finite_in = torch.isfinite(num_x).all() & torch.isfinite(den_x).all()
        if group is not None:
            from ..parallel.mesh import all_ranks

            finite_in = all_ranks(finite_in, group)
        num = internal_norm(torch.where(finite_in, num_x, 0.0), group)
        den = internal_norm(torch.where(finite_in, den_x, 1.0), group)
        bad = ~finite_in | (den == 0.0) | ~torch.isfinite(num + den)
        num_s = torch.where(bad, 0.0, num)
        den_s = torch.where(bad, 1.0, den)
        est = torch.abs(num_s / (den_s + eps)) / T.stability_size
        return torch.where(bad, torch.zeros_like(est), est)
    raise ValueError(
        f"unknown regularize_type {reg_type!r}; expected 'error_estimate' or "
        "'stiffness_estimate'"
    )
