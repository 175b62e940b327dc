"""Variable-coefficient Adams multistep solvers (VCAB3 / VCABM3).

Counterpart of ``localregneuralde_tpu/ode/multistep.py`` (reference
``experiments/src/construct.jl:154-164``: selectable for the solve of the
layer; its regulariser step stays Tsit5). The order-3 predictor integrates
the Newton interpolating polynomial of the last three derivatives on their
non-uniform time grid; VCABM3 adds an Adams–Moulton corrector and takes the
Milne estimate, corrector − predictor, as its error; VCAB3 takes the
order-3 minus the order-2 prediction. Until two accepted steps have built
the derivative history, the attempts are Tsit5 steps.

The loop is the eager accept/reject loop of ``ode/solve.py`` with the PI
controller of order 3 (β1 = 7/30, β2 = 2/15), one dt and one RMS error
norm for the batch, the Hairer first dt of order 3, the reservoir of the
biased regulariser (``reservoir``: one uniform per attempt), and dense
output on ``saveat`` from the cubic Hermite of ``(u, f)`` at both ends of
the accepted step (the derivative polynomial's order). NFE: 2 at the
start, 6 per Tsit5 attempt and 1 per multistep attempt (AB and ABM alike:
the corrector reuses the predictor's derivative, the reference's PECE
approximation). The reference's module docstring says 2 for ABM; its loop,
which this follows, counts 1.

``adjoint='direct'`` differentiates through the loop with autograd (t, dt
and the error estimate detached; rejected attempts leave nothing in the
graph), ``'none'`` does not.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.residuals import error_residuals, internal_norm
from .controller import PIController, initial_step_size
from .solve import ODESolution, device_scalar
from .step import tsit5_step


def adams_controller() -> PIController:
    """The PI controller for order 3 (``PIController.for_order(3)``)."""
    return PIController(beta1=7.0 / 30.0, beta2=2.0 / 15.0)


def adams_predict(u, h, f_hist, t_hist):
    """Order-3 Adams–Bashforth on a non-uniform grid by Newton divided
    differences; also the order-2 prediction, for the error control."""
    f0, f1, f2 = f_hist
    t0, t1, t2 = t_hist
    c0 = f0
    c1 = (f0 - f1) / (t0 - t1)
    c2 = ((f0 - f1) / (t0 - t1) - (f1 - f2) / (t1 - t2)) / (t0 - t2)
    a = t0 - t1
    i1 = h
    i2 = h * h / 2
    i3 = h * h * h / 3 + a * h * h / 2
    u3 = u + i1 * c0 + i2 * c1 + i3 * c2
    u2 = u + i1 * c0 + i2 * c1
    return u3, u2


def moulton_correct(u, h, f_new, f_hist, t_hist):
    """Order-3 Adams–Moulton corrector on the nodes (t + h, t, t − a)."""
    f0, f1 = f_hist[0], f_hist[1]
    t0, t1 = t_hist[0], t_hist[1]
    tn = t0 + h
    c0 = f_new
    c1 = (f_new - f0) / (tn - t0)
    c2 = ((f_new - f0) / (tn - t0) - (f0 - f1) / (t0 - t1)) / (tn - t1)
    i1 = h
    i2 = h * h / 2 - h * h
    i3 = h * h * h / 3 - h * h * h / 2
    return u + i1 * c0 + i2 * c1 + i3 * c2


def _hermite(u, f0, u_new, f_new, dt, th):
    h00 = 2 * th ** 3 - 3 * th ** 2 + 1
    h10 = th ** 3 - 2 * th ** 2 + th
    h01 = -2 * th ** 3 + 3 * th ** 2
    h11 = th ** 3 - th ** 2
    return h00 * u + h10 * dt * f0 + h01 * u_new + h11 * dt * f_new


def adams_solve(
    f: Callable,
    u0: torch.Tensor,
    tspan,
    *,
    rtol: float = 1e-3,
    atol: float = 1e-6,
    moulton: bool = True,
    saveat=None,
    max_steps: int = 256,
    adjoint: str = "direct",
    stateful: bool = False,
    f_state=None,
    reservoir: Optional[torch.Tensor] = None,
) -> ODESolution:
    """Integrate ``du/dt = f(u, t)`` (with ``stateful``: ``f(u, t, st) ->
    (du, st)``) with VCAB3 (``moulton=False``) or VCABM3. ``adjoint`` is
    ``'none'`` or ``'direct'``."""
    if adjoint not in ("none", "direct"):
        raise ValueError(f"unknown adjoint {adjoint!r} for the Adams solvers")
    fn = f if stateful else (lambda u, t, st: (f(u, t), st))
    ctrl = adams_controller()
    t0f, t_endf = float(tspan[0]), float(tspan[1])
    t = device_scalar(t0f, u0)
    t_end = device_scalar(t_endf, u0)
    saveat = (t_end.reshape(1) if saveat is None
              else torch.atleast_1d(device_scalar(saveat, u0)))
    bshape = (-1,) + (1,) * u0.ndim

    k1_0, f_st = fn(u0, t, f_state)
    with torch.no_grad():  # the dt probe is fenced
        dt, extra = initial_step_size(
            lambda u, s: fn(u, s, f_state)[0], u0, t, order=3, rtol=rtol,
            atol=atol, f0=k1_0)
        dt = torch.minimum(dt, t_end - t)
    nfe = 1 + extra
    f_hist = [k1_0, k1_0, k1_0]
    t_hist = [t, t - 1.0, t - 2.0]
    hist_count = 1
    qold = device_scalar(ctrl.qoldinit, u0)
    u = u0
    ys = u0.unsqueeze(0).repeat((saveat.shape[0],) + (1,) * u0.ndim)
    res_t, res_u = t, u0
    done = bool(t >= t_end)
    naccept = nreject = 0
    while not done and naccept + nreject < max_steps:
        natt = naccept + nreject
        t_rem = t_end - t
        dt_c = torch.minimum(dt, t_rem)
        is_last = bool(dt >= t_rem)
        t_new = t_end if is_last else t + dt_c
        if hist_count < 3:
            res = tsit5_step(fn, u, t, dt_c, f_hist[0], f_st)
            eest = internal_norm(
                error_residuals(res.utilde, u, res.u_new, atol, rtol))
            u_new, f_new, f_st_new = res.u_new, res.ks[6], res.f_state
            nfe += 6
        else:
            u_pred, u_low = adams_predict(u, dt_c, f_hist, t_hist)
            f_new, f_st_new = fn(u_pred, t_new, f_st)
            if moulton:
                u_new = moulton_correct(u, dt_c, f_new, f_hist, t_hist)
                eest = internal_norm(error_residuals(
                    u_new - u_pred, u, u_new, atol, rtol))
            else:
                u_new = u_pred
                eest = internal_norm(error_residuals(
                    u_pred - u_low, u, u_pred, atol, rtol))
            nfe += 1
        eest = eest.detach()
        dt_acc, dt_rej, qold_acc = ctrl.propose(eest, dt_c, qold)
        if not bool(eest <= 1.0):
            nreject += 1
            dt = dt_rej
            continue
        hit = (saveat > t) & (saveat <= t_new)
        if bool(hit.any()):
            th = torch.clamp((saveat - t) / dt_c, 0.0, 1.0).reshape(bshape)
            ys = torch.where(hit.reshape(bshape),
                             _hermite(u, f_hist[0], u_new, f_new, dt_c, th),
                             ys)
        if reservoir is not None and bool(reservoir[natt] * (naccept + 1) < 1.0):
            res_t, res_u = t, u
        naccept += 1
        f_hist = [f_new, f_hist[0], f_hist[1]]
        t_hist = [t_new, t_hist[0], t_hist[1]]
        hist_count = min(hist_count + 1, 3)
        u, t, dt, qold, f_st = u_new, t_new, dt_acc, qold_acc, f_st_new
        done = is_last
    as_int = lambda n: torch.tensor(n, dtype=torch.int32, device=u0.device)  # noqa: E731
    return ODESolution(
        ts=saveat, ys=ys, t_final=t, y_final=u, nfe=as_int(nfe),
        naccept=as_int(naccept), nreject=as_int(nreject),
        success=torch.tensor(done, device=u0.device), f_state=f_st,
        reservoir_t=res_t if reservoir is not None else t,
        reservoir_u=res_u if reservoir is not None else u,
    )
