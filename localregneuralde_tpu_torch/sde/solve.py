"""Adaptive SDE integration: the eager accept/reject loop over the virtual
Brownian tree.

Counterpart of ``localregneuralde_tpu/sde/solve.py``: the SRI family
(``'sri'``, ``'sosri'``, strong order 1.5), the commutative Milstein step
(``'milstein'``, order 1.0; with ``noise_shape`` the non-diagonal branch)
and Lamba–Euler–Heun (``'euler_heun'``, Stratonovich, order 0.5). The
whole batch shares one dt and one error norm. Per attempt the loop reads
the increments ``(dW, dZ)`` over ``[t, t + dt]`` from the tree, which is
consistent under rejection, takes one step, and lets the I-controller
(γ 0.9, qmin 0.2, qmax 1.2, β1 = 1/(order + 1), β2 = 0) judge it. The first
dt is the drift-magnitude heuristic (one drift evaluation). Accepted steps
write the saveat outputs by linear interpolation, may replace the
reservoir sample of the biased regulariser (``reservoir`` holds one uniform
per attempt, drawn in advance), and with ``record_knots`` record the knots
``(t, u)`` at the accepted boundaries and the increments ``(dW, dZ)`` of
each accepted step, which the stored adjoint (``sde/stored_adjoint.py``)
sweeps. NFE: drift 1 + n_f·attempts, diffusion n_g·attempts, with the
step's ``(n_f, n_g)`` of ``step.step_nfe``.

Non-diagonal noise (``noise_shape = (B, m)``): the tree draws ``(B, m)``
increments, the diffusion returns ``u.shape + (m,)``, and the solver must
be ``'milstein'`` (the reference's only non-diagonal branch,
``sde/solve.py:147-152`` there).

With a data-parallel ``group`` (the global grid,
``parallel/sharded_train.py``) the batch is spread over the group's ranks:
every norm of the solve (each attempt's error estimate, the first dt's) is
one scalar over all their rows, so every rank takes the same accept
decisions, and each rank's tree draws its own rows of the whole batch's
(``brownian.PhiloxNormals``' ``row_offset``).

The loop runs on the host and reads the accept decision once per attempt.
It is the plain version the persistent CUDA solve
(``ops/cuda/fused_sde_solve.py``, SRI/SOSRI with diagonal noise) is held
against; ``persistent_fn`` hands an ``adjoint='none'`` solve to that
kernel. ``adjoint='direct'`` differentiates through the loop with autograd
(reference ``sde/solve.py:376-392``): dt, the error estimate and the noise
are detached, and a rejected attempt's graph is dropped with its result.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..nn.basic import check_fp32_products
from ..ode.controller import PIController
from ..ode.solve import device_scalar
from ..ops.residuals import internal_norm
from .brownian import VirtualBrownianTree
from .step import (
    lamba_euler_heun_step,
    milstein_commute_step,
    milstein_commute_step_nondiag,
    sri_step,
    step_nfe,
)
from .tableaus import get_sri_tableau

SRI_SOLVERS = ("sri", "sosri")
# strong order of each solver (the controller's β1 = 1/(order + 1))
SOLVERS = {"sri": 1.5, "sosri": 1.5, "milstein": 1.0, "euler_heun": 0.5}


@dataclass
class SDESolution:
    """Result of an adaptive SDE solve; ``ys[i] ≈ u(ts[i])`` by linear
    interpolation. With ``record_knots`` the knot fields hold at least
    ``naccept + 1`` knots and ``naccept`` increments (the entries past
    them are unspecified)."""

    ts: torch.Tensor
    ys: torch.Tensor
    t_final: torch.Tensor
    y_final: torch.Tensor
    nfe_drift: torch.Tensor
    nfe_diffusion: torch.Tensor
    naccept: torch.Tensor
    nreject: torch.Tensor
    success: torch.Tensor
    reservoir_t: Any = None
    reservoir_u: Any = None
    knot_ts: Any = None
    knot_us: Any = None
    knot_dws: Any = None
    knot_dzs: Any = None


def check_solver(solver: str, noise_shape=None) -> None:
    if solver not in SOLVERS:
        raise ValueError(f"unknown SDE solver {solver!r}; one of "
                         f"{tuple(SOLVERS)}")
    if noise_shape is not None and solver != "milstein":
        raise ValueError(
            "non-diagonal noise (noise_shape=...) requires solver="
            "'milstein' (the commutative RKMilCommute branch)")


def sde_controller(solver: str = "sri") -> PIController:
    """The SDE loop's I-controller for ``solver``'s strong order."""
    return PIController(gamma=0.9, qmin=0.2, qmax=1.2,
                        beta1=1.0 / (SOLVERS[solver] + 1.0), beta2=0.0)


def sde_step(solver: str, noise_shape=None, delta: float = 1 / 6,
             group=None):
    """``step(f, g, u, t, dt, dW, dZ, atol, rtol) -> SDEStepResult`` of
    ``solver`` (the non-diagonal Milstein step with ``noise_shape``), its
    error norm over the ranks of ``group``."""
    if solver in SRI_SOLVERS:
        tableau = get_sri_tableau(solver)
        return lambda f, g, u, t, dt, dW, dZ, atol, rtol: sri_step(
            f, g, u, t, dt, dW, dZ, atol, rtol, delta, tableau, group)
    if solver == "milstein":
        step = (milstein_commute_step if noise_shape is None
                else milstein_commute_step_nondiag)
        return lambda f, g, u, t, dt, dW, dZ, atol, rtol: step(
            f, g, u, t, dt, dW, atol, rtol, group=group)
    return lambda f, g, u, t, dt, dW, dZ, atol, rtol: lamba_euler_heun_step(
        f, g, u, t, dt, dW, atol, rtol, delta, group)


def initial_dt(u0, f0, rtol, atol, t0: float, t_end: float, group=None):
    """The first step: 0.01·‖u0‖/‖f0‖ in the tolerance-scaled RMS norm
    (1e-6 when either is below 1e-5), at most half the span; both norms
    over the ranks of ``group``. Detached."""
    span = device_scalar(t_end, u0) - device_scalar(t0, u0)
    sc = atol + torch.abs(u0) * rtol
    d0 = internal_norm(u0 / sc, group)
    d1 = internal_norm(f0 / sc, group)
    dt = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6,
                     0.01 * d0 / torch.where(d1 == 0, 1.0, d1))
    return torch.minimum(dt, span / 2).detach()


def sde_loop(f: Callable, g: Callable, u0, t0: float, t_end: float, dt_init,
             *, noise, saveat, rtol, atol, solver, delta, max_steps,
             reservoir=None, brownian_depth=24, record_knots=False,
             noise_shape=None, group=None):
    """The accept/reject loop from ``u0`` at ``t0`` with first step
    ``dt_init``; ``f(u, t)``, ``g(u, t)``; the error norms over the ranks
    of ``group``. Returns a dict with ``ys``,
    ``y_final``, ``t_final``, ``naccept``, ``nreject``, ``natt``,
    ``success``, ``reservoir_t``, ``reservoir_u`` and, with
    ``record_knots``, ``knot_ts`` (naccept + 1), ``knot_us`` (naccept + 1,
    B, F), ``knot_dws`` and ``knot_dzs`` (naccept, and the noise shape:
    ``noise_shape``, default the state's)."""
    controller = sde_controller(solver)
    step = sde_step(solver, noise_shape, delta, group)
    w_shape = tuple(u0.shape if noise_shape is None else noise_shape)
    tree = VirtualBrownianTree(noise, t0, t_end, brownian_depth)
    t = device_scalar(t0, u0)
    t_end_d = device_scalar(t_end, u0)
    saveat = device_scalar(saveat, u0)
    bshape = (-1,) + (1,) * u0.ndim
    dt, qold = dt_init, device_scalar(controller.qoldinit, u0)
    u = u0
    wz = torch.zeros((2,) + w_shape, dtype=u0.dtype, device=u0.device)
    ys = u0.unsqueeze(0).repeat((saveat.shape[0],) + (1,) * u0.ndim)
    res_t, res_u = t, u0
    knots = ([t], [u0], [], [])
    done = t0 >= t_end
    naccept = nreject = 0
    while not done and naccept + nreject < max_steps:
        natt = naccept + nreject
        t_rem = t_end_d - t
        dt_c = torch.minimum(dt, t_rem)
        is_last = bool(dt >= t_rem)
        wz_new = tree.wz(t + dt_c)
        dW, dZ = wz_new[0] - wz[0], wz_new[1] - wz[1]
        res = step(f, g, u, t, dt_c, dW, dZ, atol, rtol)
        eest = res.eest.detach()
        dt_acc, dt_rej, qold_acc = controller.propose(eest, dt_c, qold)
        if not bool(eest <= 1.0):
            nreject += 1
            dt = dt_rej
            continue
        t_new = t_end_d if is_last else t + dt_c
        hit = (saveat > t) & (saveat <= t_new)
        if bool(hit.any()):
            theta = torch.clamp((saveat - t) / dt_c, 0.0, 1.0).reshape(bshape)
            ys = torch.where(hit.reshape(bshape), u + theta * (res.u_new - u),
                             ys)
        if reservoir is not None and bool(reservoir[natt] * (naccept + 1) < 1.0):
            res_t, res_u = t, u
        naccept += 1
        if record_knots:
            for buf, v in zip(knots, (t_new, res.u_new, dW, dZ)):
                buf.append(v)
        u, t, dt, qold, wz = res.u_new, t_new, dt_acc, qold_acc, wz_new
        done = is_last
    as_int = lambda n: torch.tensor(n, dtype=torch.int32, device=u0.device)  # noqa: E731
    out = dict(
        ys=ys, y_final=u, t_final=t, naccept=as_int(naccept),
        nreject=as_int(nreject), natt=as_int(naccept + nreject),
        success=torch.tensor(done, device=u0.device),
        reservoir_t=res_t if reservoir is not None else None,
        reservoir_u=res_u if reservoir is not None else None,
    )
    if record_knots:
        empty = u0.new_zeros((0,) + w_shape)
        ts, us, dws, dzs = knots
        out.update(knot_ts=torch.stack(ts), knot_us=torch.stack(us),
                   knot_dws=torch.stack(dws) if dws else empty,
                   knot_dzs=torch.stack(dzs) if dzs else empty)
    return out


def solution_from(out: dict, saveat_arr, nfe_step=(4, 4)) -> SDESolution:
    """An ``SDESolution`` from a loop's or a kernel's output dict (NFE:
    the first dt's drift evaluation and ``nfe_step`` (drift, diffusion)
    per attempt, four of each for SRI)."""
    natt = out["natt"]
    return SDESolution(
        ts=saveat_arr, ys=out["ys"], t_final=out["t_final"],
        y_final=out["y_final"], nfe_drift=1 + nfe_step[0] * natt,
        nfe_diffusion=nfe_step[1] * natt, naccept=out["naccept"],
        nreject=out["nreject"], success=out["success"],
        reservoir_t=out.get("reservoir_t"), reservoir_u=out.get("reservoir_u"),
        knot_ts=out.get("knot_ts"), knot_us=out.get("knot_us"),
        knot_dws=out.get("knot_dws"), knot_dzs=out.get("knot_dzs"),
    )


def saveat_array(saveat, t_end: float, like: torch.Tensor) -> torch.Tensor:
    if saveat is None:
        return device_scalar(t_end, like).reshape(1)
    return torch.atleast_1d(device_scalar(saveat, like))


def replicated_sde(solve: Callable, u0, group, *, noise, **kw):
    """``solve(u, noise=..., **kw)``, a kernel's whole solve, from this
    rank's rows ``u0``: on one device as it is; on the global grid
    (``group``) on the whole batch, gathered from the ranks, with the
    whole batch's tree (``noise.rows``, from row 0), on every rank, which
    keeps its rows of the result (``parallel.mesh.replicated``)."""
    if group is None:
        return solve(u0, noise=noise, **kw)
    from ..parallel.mesh import replicated

    _, sol = replicated(
        lambda u: solve(u, noise=noise.rows(u.shape[0]), **kw), u0, group)
    return sol


def sdesolve(
    f: Callable,
    g: Callable,
    u0: torch.Tensor,
    tspan,
    *,
    noise,
    rtol: float = 1e-2,
    atol: float = 1e-2,
    solver: str = "sri",
    delta: float = 1 / 6,
    saveat=None,
    max_steps: int = 256,
    adjoint: str = "none",
    reservoir: Optional[torch.Tensor] = None,
    brownian_depth: int = 24,
    record_knots: bool = False,
    persistent_fn: Optional[Callable] = None,
    noise_shape=None,
    group=None,
    **stored_kwargs,
) -> SDESolution:
    """Integrate ``du = f(u, t) dt + g(u, t) dW`` over ``tspan`` (Itô;
    Stratonovich for ``'euler_heun'``).

    Args:
      noise: the tree's normal source, ``noise(node) -> (2, *w_shape)``
        (``brownian.PhiloxNormals`` by default in the model).
      noise_shape: ``(B, m)`` for non-diagonal noise (``'milstein'``
        only): ``g`` returns ``u.shape + (m,)``; None for diagonal noise.
      saveat: 1-D output times (default ``[t_end]``); times ≤ t0 return u0.
      adjoint: ``'none'`` (not differentiable), ``'direct'`` (autograd
        through the loop) or ``'stored'``; under ``'stored'`` the dynamics
        take the parameters, ``f(u, t, params)``, and ``stored_kwargs``
        carry ``params`` and the kernel callbacks (see
        ``stored_sdesolve``).
      reservoir: one uniform per attempt (``max_steps``) for the reservoir
        sample of accepted step starts; None for no reservoir.
      persistent_fn: whole-solve replacement (the persistent CUDA solve)
        for ``adjoint='none'``; when given, the eager loop does not run.
      group: a ``parallel.DPGroup`` for the global grid: ``u0`` is this
        rank's rows of a batch spread over its ranks, ``noise`` draws
        those rows of the whole batch's tree, and every norm is over all
        the rows. A kernel takes part in no collective mid-solve, so
        ``persistent_fn`` solves the whole batch on every rank
        (``replicated_sde``).

    On a CUDA tensor it raises below rtol 1e-4 while TF32 is on
    (``nn.basic.check_fp32_products``).
    """
    check_solver(solver, noise_shape)
    check_fp32_products(rtol, u0.device)
    if adjoint == "stored":
        from .stored_adjoint import stored_sdesolve

        return stored_sdesolve(
            f, g, u0, tspan, noise=noise, rtol=rtol, atol=atol,
            solver=solver, delta=delta, saveat=saveat, max_steps=max_steps,
            reservoir=reservoir, brownian_depth=brownian_depth,
            persistent_fn=persistent_fn, noise_shape=noise_shape,
            group=group, **stored_kwargs,
        )
    if adjoint not in ("none", "direct"):
        raise ValueError(f"unknown SDE adjoint {adjoint!r}")
    t0, t_end = float(tspan[0]), float(tspan[1])
    saveat_arr = saveat_array(saveat, t_end, u0)
    kw = dict(noise=noise, saveat_arr=saveat_arr, rtol=rtol, atol=atol,
              solver=solver, delta=delta, max_steps=max_steps,
              record_knots=record_knots, reservoir=reservoir,
              brownian_depth=brownian_depth)
    if persistent_fn is not None and adjoint == "none":
        return replicated_sde(
            lambda u, **k: persistent_fn(u, (t0, t_end), **k), u0, group,
            **kw)
    with torch.no_grad():  # the first dt is fenced
        dt_init = initial_dt(u0, f(u0, device_scalar(t0, u0)), rtol, atol,
                             t0, t_end, group)
    out = sde_loop(
        f, g, u0, t0, t_end, dt_init, noise=noise, saveat=saveat_arr,
        rtol=rtol, atol=atol, solver=solver, delta=delta,
        max_steps=max_steps, reservoir=reservoir,
        brownian_depth=brownian_depth, record_knots=record_knots,
        noise_shape=noise_shape, group=group,
    )
    m = None if noise_shape is None else noise_shape[-1]
    return solution_from(out, saveat_arr, step_nfe(solver, m))
