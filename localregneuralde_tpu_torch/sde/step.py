"""Differentiable single SDE steps: the four-stage SRI step, the
commutative Milstein step (diagonal and matrix noise) and the
Lamba–Euler–Heun step.

Counterpart of ``localregneuralde_tpu/sde/step.py`` (reference
``src/perform_step.jl:49-206``). Each step returns the new state and its
embedded error estimate ``eest`` (tolerance-scaled RMS; accept iff ≤ 1);
the local regulariser is ``eest · dt``. The expressions and their order are
the JAX package's, so both round alike.

Dynamics: ``f(u, t) -> du`` and ``g(u, t) -> gu``, with ``gu`` shaped like
``u`` (diagonal noise) or, for the non-diagonal Milstein step, the
noise-rate matrix ``u.shape + (m,)``. Evaluations per step (drift,
diffusion): SRI (4, 4), Milstein (1, 2), non-diagonal Milstein (1, 1 + m),
Lamba–Euler–Heun (3, 3); ``STEP_NFE`` holds them.

With a ``DPGroup`` (``group``, the global grid of data parallelism) ``u``
is one rank's rows of a batch spread over its ranks, and ``eest`` is the
norm over all their rows (``ops/residuals.internal_norm``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.residuals import (
    difference_residuals,
    internal_norm,
    sde_error_residuals,
)
from .tableaus import SRIW1Tableau

SQRT3 = math.sqrt(3.0)

# (drift, diffusion) evaluations a step; the non-diagonal Milstein step
# takes 1 + m diffusion evaluations (``step_nfe``)
STEP_NFE = {"sri": (4, 4), "sosri": (4, 4), "milstein": (1, 2),
            "euler_heun": (3, 3)}


def step_nfe(solver: str, noise_dims=None):
    """(drift, diffusion) evaluations of one step of ``solver``."""
    if noise_dims is not None:
        return 1, 1 + int(noise_dims)
    return STEP_NFE[solver]


class SDEStepResult(NamedTuple):
    u_new: torch.Tensor
    eest: torch.Tensor  # tolerance-scaled error norm (accept iff ≤ 1)


def sri_step(f, g, u, t, dt, dW, dZ, atol, rtol, delta: float = 1 / 6,
             tableau=None, group=None) -> SDEStepResult:
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
                                             delta), group)
    return SDEStepResult(u_new, eest)


def milstein_commute_step(f, g, u, t, dt, dW, atol, rtol, *,
                          interpretation: str = "ito",
                          group=None) -> SDEStepResult:
    """The diagonal-noise commutative Milstein step (reference
    ``src/perform_step.jl:108-170``, diagonal branch). As in the
    reference, ``eest`` is the tolerance-scaled RMS of ``u_new − u``: the
    drift-error expression it computes first is overwritten before use
    (``perform_step.jl:164-167``)."""
    sqdt = torch.sqrt(torch.abs(dt))
    J = (dW ** 2) / 2  # I_(1,1); Itô subtracts dt/2
    if interpretation == "ito":
        J = J - torch.abs(dt) / 2
    du1 = f(u, t)
    L = g(u, t)
    K = u + dt * du1
    base = K if interpretation == "ito" else u
    gtmp = g(base + sqdt * L, t)
    Dgj = (gtmp - L) / sqdt
    u_new = K + L * dW + Dgj * J
    return SDEStepResult(u_new, internal_norm(
        difference_residuals(u, u_new, atol, rtol), group))


def milstein_commute_step_nondiag(f, g, u, t, dt, dW, atol, rtol, *,
                                  interpretation: str = "ito",
                                  group=None) -> SDEStepResult:
    """The non-diagonal (matrix) commutative-noise Milstein step (reference
    ``src/perform_step.jl:126-160``). ``u`` is (..., d), ``dW`` (..., m)
    and ``g`` returns the noise-rate matrix (..., d, m). The iterated
    integrals take the commutative approximation ``J = dW dWᵀ / 2`` with
    the Itô correction ``J −= (dt/2)·I``; the correction sums the
    per-channel ``Dg_j = (g(K + √dt·L[:, j]) − L)/√dt`` against ``J[:, j]``
    in channel order, as the reference's loop (m diffusion evaluations).
    ``eest`` as ``milstein_commute_step``."""
    sqdt = torch.sqrt(torch.abs(dt))
    m = dW.shape[-1]
    J = 0.5 * dW[..., :, None] * dW[..., None, :]
    if interpretation == "ito":
        J = J - (torch.abs(dt) / 2) * torch.eye(m, dtype=J.dtype,
                                                device=J.device)
    du1 = f(u, t)
    L = g(u, t)
    K = u + dt * du1
    correction = None
    for j in range(m):
        gtmp = g(K + sqdt * L[..., j], t)
        Dgj = (gtmp - L) / sqdt
        c = torch.einsum("...dm,...m->...d", Dgj, J[..., j])
        correction = c if correction is None else correction + c
    u_new = K + torch.einsum("...dm,...m->...d", L, dW) + correction
    return SDEStepResult(u_new, internal_norm(
        difference_residuals(u, u_new, atol, rtol), group))


def lamba_euler_heun_step(f, g, u, t, dt, dW, atol, rtol,
                          delta: float = 1 / 6, group=None) -> SDEStepResult:
    """The Stratonovich predictor–corrector (Lamba) Euler–Heun step
    (reference ``src/perform_step.jl:172-206``, diagonal branch)."""
    sqdt = torch.sqrt(torch.abs(dt))
    du1 = f(u, t)
    K = u + dt * du1
    L = g(u, t)
    tmp = K + L * dW
    g_tmp = g(tmp, t + dt)
    noise2 = ((L + g_tmp) / 2) * dW
    f_tmp = f(tmp, t + dt)
    u_new = u + (dt / 2) * (du1 + f_tmp) + noise2
    du2 = f(K, t + dt)
    Ed = dt * (du2 - du1) / 2
    g_ut = g(u + L * sqdt, t)
    En = ((g_ut - L) / sqdt) * (dW ** 2) / 2
    return SDEStepResult(u_new, internal_norm(
        sde_error_residuals(Ed, En, u, u_new, atol, rtol, delta), group))
