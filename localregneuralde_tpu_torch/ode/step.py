"""One explicit Tsit5 step.

Counterpart of ``localregneuralde_tpu/ode/step.py`` (reference
``src/perform_step.jl:3-32``). The dynamics convention is
``f(u, t, st) -> (du, st)``, where ``st`` is carried layer state; stateless
dynamics return it unchanged.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

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
