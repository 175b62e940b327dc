"""Adaptive Tsit5 integration: the eager accept/reject loop.

Counterpart of ``localregneuralde_tpu/ode/solve.py`` for ``adjoint='none'``
(inference): the while-loop with early exit, PI control, the Hairer initial
dt, dense output onto ``saveat``, the ``max_steps`` cap and NFE statistics
(2 initial evaluations + 6 per attempted step). One dt and one RMS error
norm are shared by the whole batch; with a data-parallel ``group`` (the
global grid, ``parallel/sharded_train.py``) by the batch spread over its
ranks, whose every norm is one scalar over all their rows, so every rank
takes the same accept decisions.

The loop runs on the host and reads the accept decision once per attempt.
It is the plain version that the persistent CUDA solve
(``ops/cuda/fused_solve.py``) is held against, and the path taken when that
kernel is not used. With ``record_knots`` it records the knots and two-level
checkpoints that the stored adjoint (``ode/stored_adjoint.py``,
``adjoint='stored'``) sweeps. ``adjoint='direct'`` differentiates through
the loop itself with autograd (reference ``ode/solve.py:443-470``): t, dt
and the error estimate are detached, a rejected attempt's graph is dropped
with its result, so only the accepted steps (and the FSAL k1 at t0) stay in
the graph. The interpolating and backsolve adjoints
(``ode/interp_adjoint.py``, ``ode/adjoint.py``) run this loop forward and
integrate the adjoint ODE backward. With ``reservoir`` (one uniform per attempt,
drawn in advance) it keeps a reservoir sample of the accepted steps'
starting points, the biased regulariser's ``(t1, u(t1))``: accepted attempt
number ``natt`` takes its step start when ``reservoir[natt]·(naccept + 1)
< 1``, so every accepted step start is equally likely and ``t_end`` never
is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..nn.basic import check_fp32_products
from ..ops.residuals import scaled_error_norm
from .controller import PIController, initial_step_size
from .step import Tsit5StepResult, tsit5_step
from .tableaus import tsit5_interpolate


@dataclass
class ODESolution:
    """Result of an adaptive solve. ``ys[i] ≈ u(ts[i])`` through the Tsit5
    interpolant; ``nfe`` counts dynamics evaluations."""

    ts: torch.Tensor
    ys: torch.Tensor
    t_final: torch.Tensor
    y_final: torch.Tensor
    nfe: torch.Tensor
    naccept: torch.Tensor
    nreject: torch.Tensor
    success: torch.Tensor
    f_state: Any = None
    # the biased regulariser's reservoir sample (``reservoir`` given)
    reservoir_t: Any = None
    reservoir_u: Any = None
    # knots of a recording solve (``record_knots``), read by the stored
    # adjoint: dense (t, u, k1) at accepted steps, and with a knot stride
    # W > 1 checkpoints every W-th accept with the controller state
    # (dt_next, qold) that a window replay resumes from
    knot_ts: Any = None
    knot_us: Any = None
    knot_ks: Any = None
    ckpt_ts: Any = None
    ckpt_us: Any = None
    ckpt_ks: Any = None
    ckpt_dts: Any = None
    ckpt_qolds: Any = None


KNOT_FIELDS = ("knot_ts", "knot_us", "knot_ks", "ckpt_ts", "ckpt_us",
               "ckpt_ks", "ckpt_dts", "ckpt_qolds")
RESERVOIR_FIELDS = ("reservoir_t", "reservoir_u")


def device_scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 on ``like``'s device. A Python number is filled in
    on the device: a copy from pageable host memory would wait for the
    device's queued work."""
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=torch.float32, device=like.device)
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def host_to_device(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A CPU tensor on ``like``'s device. A card gets it through pinned
    memory without blocking, so the copy does not wait for the device's
    queued work."""
    if like.device.type == "cpu":
        return t
    return t.pin_memory().to(like.device, non_blocking=True)


class Attempt(NamedTuple):
    """One attempted step and the controller's verdict on it."""

    res: Tsit5StepResult
    dt_c: torch.Tensor      # the step actually taken (clipped to the span)
    t_new: torch.Tensor     # the time the step reaches
    is_last: bool
    accept: bool
    dt_acc: torch.Tensor    # next dt if accepted
    dt_rej: torch.Tensor    # retry dt if rejected
    qold_acc: torch.Tensor  # next qold if accepted


def attempt(step, controller, u, t, dt, qold, t_end, k1, f_st, *, atol,
            rtol, group=None) -> Attempt:
    """One attempt of the adaptive loop: clip dt to the span, take the step
    ``step(u, t, dt_c, k1, f_st)`` and let the controller judge it. The
    forward loop and the two-level window replay of the stored adjoint both
    call this, so a replay repeats its forward's arithmetic exactly."""
    t_rem = t_end - t
    dt_c = torch.minimum(dt, t_rem)
    is_last = bool(dt >= t_rem)
    res = step(u, t, dt_c, k1, f_st)
    eest = scaled_error_norm(res.utilde, u, res.u_new, atol, rtol,
                             group).detach()
    dt_acc, dt_rej, qold_acc = controller.propose(eest, dt_c, qold)
    t_new = t_end if is_last else t + dt_c
    return Attempt(res, dt_c, t_new, is_last, bool(eest <= 1.0), dt_acc,
                   dt_rej, qold_acc)


def knot_counts(max_steps: int, knot_dense_cap=None, knot_stride: int = 1):
    """``(n_dense, n_ckpt)`` of a recording solve: dense knot slots (slot 0
    and the first ``knot_dense_cap`` accepts) and, with a stride W > 1,
    checkpoint slots (0 without)."""
    cap = max_steps if knot_dense_cap is None else min(max_steps,
                                                       int(knot_dense_cap))
    return cap + 1, (max_steps // knot_stride + 1 if knot_stride > 1 else 0)


def _knot_buffers(u0, k1_0, t0, t_end, dt_init, qoldinit, max_steps,
                  dense_cap, stride):
    """Knot buffers of a recording solve (the layout ``ode/stored_adjoint``
    reads): dense knots ``(t, u, k1)`` at slot 0 and after each of the first
    ``dense_cap`` accepts, and with ``stride`` W > 1 a checkpoint
    ``(t, u, k1, dt_next, qold)`` every W-th accept. Unwritten times hold
    t_end."""
    n_dense, n_ckpt = knot_counts(max_steps, dense_cap, stride)
    kb = dict(
        knot_ts=t_end.expand(n_dense).clone(),
        knot_us=u0.new_zeros((n_dense,) + u0.shape),
        knot_ks=u0.new_zeros((n_dense,) + u0.shape),
    )
    kb["knot_ts"][0] = t0
    kb["knot_us"][0] = u0
    kb["knot_ks"][0] = k1_0
    if n_ckpt:
        kb.update(
            ckpt_ts=t_end.expand(n_ckpt).clone(),
            ckpt_us=u0.new_zeros((n_ckpt,) + u0.shape),
            ckpt_ks=u0.new_zeros((n_ckpt,) + u0.shape),
            ckpt_dts=torch.zeros(n_ckpt, device=u0.device),
            ckpt_qolds=torch.full((n_ckpt,), qoldinit, device=u0.device),
        )
        kb["ckpt_ts"][0] = t0
        kb["ckpt_us"][0] = u0
        kb["ckpt_ks"][0] = k1_0
        kb["ckpt_dts"][0] = dt_init
    return kb


def _record(kb, cnt, stride, a: Attempt):
    """Store the state after accept number ``cnt`` (writes past the dense
    capacity are dropped)."""
    if cnt < kb["knot_ts"].shape[0]:
        kb["knot_ts"][cnt] = a.t_new
        kb["knot_us"][cnt] = a.res.u_new
        kb["knot_ks"][cnt] = a.res.ks[6]
    if stride > 1 and cnt % stride == 0:
        ci = cnt // stride
        kb["ckpt_ts"][ci] = a.t_new
        kb["ckpt_us"][ci] = a.res.u_new
        kb["ckpt_ks"][ci] = a.res.ks[6]
        kb["ckpt_dts"][ci] = a.dt_acc
        kb["ckpt_qolds"][ci] = a.qold_acc


def adaptive_loop(fn: Callable, u0, k1_0, f_st0, t0, t_end, dt_init, *,
                  saveat, rtol, atol, max_steps,
                  step_fn: Optional[Callable] = None,
                  record_knots: bool = False, knot_dense_cap=None,
                  knot_stride: int = 1, reservoir=None,
                  on_accept: Optional[Callable] = None, group=None):
    """The accept/reject loop from ``(u0, k1_0)`` at ``t0`` with first step
    ``dt_init``; ``fn(u, t, st) -> (du, st)``. Returns a dict with ``ys``,
    ``y_final``, ``t_final``, ``naccept``, ``nreject``, ``natt``,
    ``success`` and ``f_state``; with ``record_knots`` also the knot and
    checkpoint buffers of ``_knot_buffers``, and with ``reservoir`` (one
    uniform per attempt) ``reservoir_t`` and ``reservoir_u``.
    ``on_accept(a)`` sees every accepted ``Attempt`` (the interpolating
    adjoint's knots, held only as far as the solve goes). ``group``: the
    error norm's ``DPGroup`` (global grid), or None."""
    controller = PIController()
    t = device_scalar(t0, u0)
    t_end = device_scalar(t_end, u0)
    saveat = device_scalar(saveat, u0)
    dt = dt_init
    qold = device_scalar(controller.qoldinit, u0)
    u, k1, f_st = u0, k1_0, f_st0
    ys = u0.unsqueeze(0).repeat((saveat.shape[0],) + (1,) * u0.ndim)
    stride = max(1, int(knot_stride))
    kb = None
    if record_knots:
        kb = _knot_buffers(u0, k1_0, t, t_end, dt_init, controller.qoldinit,
                           max_steps, knot_dense_cap, stride)
    if step_fn is None:
        def step(u_, t_, dt_, k1_, st_):
            return tsit5_step(fn, u_, t_, dt_, k1_, st_)
    else:
        def step(u_, t_, dt_, k1_, st_):
            return step_fn(fn, u_, t_, dt_, k1_, st_)
    done = bool(t >= t_end)
    naccept = nreject = 0
    res_t, res_u = t, u0
    while not done and naccept + nreject < max_steps:
        natt = naccept + nreject
        a = attempt(step, controller, u, t, dt, qold, t_end, k1, f_st,
                    atol=atol, rtol=rtol, group=group)
        if not a.accept:
            nreject += 1
            dt = a.dt_rej
            continue
        hit = (saveat > t) & (saveat <= a.t_new)
        if bool(hit.any()):
            theta = torch.clamp((saveat - t) / a.dt_c, 0.0, 1.0)
            y_interp = tsit5_interpolate(u, a.dt_c, a.res.ks, theta)
            ys = torch.where(hit.reshape((-1,) + (1,) * u.ndim), y_interp, ys)
        if reservoir is not None and bool(reservoir[natt] * (naccept + 1) < 1.0):
            res_t, res_u = t, u
        naccept += 1
        if kb is not None:
            _record(kb, naccept, stride, a)
        if on_accept is not None:
            on_accept(a)
        u, k1, f_st = a.res.u_new, a.res.ks[6], a.res.f_state
        t, dt, qold = a.t_new, a.dt_acc, a.qold_acc
        done = a.is_last
    as_int = lambda n: torch.tensor(n, dtype=torch.int32, device=u0.device)  # noqa: E731
    return dict(
        ys=ys, y_final=u, t_final=t, naccept=as_int(naccept),
        nreject=as_int(nreject), natt=as_int(naccept + nreject),
        success=torch.tensor(done, device=u0.device), f_state=f_st,
        **(kb or {}),
        **(dict(reservoir_t=res_t, reservoir_u=res_u) if reservoir is not None
           else {}),
    )


def odesolve(
    f: Callable,
    u0: torch.Tensor,
    tspan,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-7,
    saveat=None,
    max_steps: int = 256,
    adjoint: str = "none",
    stateful: bool = False,
    f_state: Any = None,
    step_fn: Optional[Callable] = None,
    persistent_fn: Optional[Callable] = None,
    record_knots: bool = False,
    knot_dense_cap: Optional[int] = None,
    knot_stride: int = 1,
    reservoir: Optional[torch.Tensor] = None,
    group=None,
    **stored_kwargs,
) -> ODESolution:
    """Integrate ``du/dt = f(u, t)`` over ``tspan`` with adaptive Tsit5.

    Args:
      f: dynamics ``f(u, t) -> du`` or, with ``stateful=True``,
        ``f(u, t, st) -> (du, st)``. Under ``adjoint='stored'`` it is
        ``f(u, t, params) -> du``, or ``f(u, t, params, st) -> (du, st)``
        when stateful (see ``stored_odesolve``).
      f_state: the dynamics' initial state; the loop threads it through
        the accepted steps only (a step's ``f_state`` is kept when it is
        accepted) and returns it as ``sol.f_state``.
      saveat: 1-D output times in ``[t0, t_end]`` (need not be sorted);
        defaults to ``[t_end]``. Times ≤ t0 return ``u0``.
      max_steps: bound on attempted steps (reference ``maxiters``).
      adjoint: ``'none'`` (inference; not differentiable), ``'direct'``
        (autograd through the loop; ``persistent_fn`` is not used),
        ``'stored'`` (``ode/stored_adjoint.py``; the other arguments of
        ``stored_odesolve`` pass through ``stored_kwargs``),
        ``'interpolating'`` (``ode/interp_adjoint.py``) or ``'backsolve'``
        (``ode/adjoint.py``). The last three take ``f(u, t, params)`` and
        ``params`` in ``stored_kwargs``. The reference's direct scan
        rematerialises chunks of ``checkpoint_every`` steps; here the
        eager loop's graph holds each accepted step's autograd residuals
        (those of the fused step kernels are their inputs only), so there
        is no such option and nothing depends on it.
      step_fn: replacement for the generic Tsit5 step with the same contract,
        ``step_fn(fn, u, t, dt, k1, f_state) -> Tsit5StepResult`` (the fused
        CUDA step, ``ops/cuda/fused_mlp.py``).
      persistent_fn: whole-solve replacement (the persistent CUDA solve,
        ``ops/cuda/fused_solve.py``); may return None to decline, and the
        loop runs instead.
      record_knots, knot_dense_cap, knot_stride: record dense knots for the
        first ``knot_dense_cap`` accepts and, with a stride W > 1, a
        checkpoint every W-th accept (``_knot_buffers``).
      reservoir: ``max_steps`` uniforms for the reservoir sample of the
        accepted step starts (the biased regulariser), or None.
      group: a ``parallel.DPGroup`` for the global grid: ``u0`` is this
        rank's rows of a batch spread over its ranks, and every norm of the
        solve is over all of them (``'none'``, ``'direct'`` and
        ``'stored'``). A kernel takes part in no collective mid-solve, so
        ``persistent_fn`` solves the whole batch, gathered from the ranks,
        on every rank, and each keeps its rows (``parallel.mesh.replicated``).

    On a CUDA tensor it raises below rtol 1e-4 while TF32 is on
    (``nn.basic.check_fp32_products``).
    """
    check_fp32_products(rtol, u0.device)
    if adjoint == "stored":
        from .stored_adjoint import stored_odesolve

        return stored_odesolve(
            f, u0, tspan, rtol=rtol, atol=atol, saveat=saveat,
            max_steps=max_steps, step_fn=step_fn, persistent_fn=persistent_fn,
            reservoir=reservoir, stateful=stateful, f_state=f_state,
            group=group, **stored_kwargs,
        )
    if group is not None and adjoint != "direct" and adjoint != "none":
        raise NotImplementedError(
            f"adjoint {adjoint!r} on the global grid of data parallelism is "
            "not ported (ROADMAP Queue 1 item 14e): the stored and the "
            "direct adjoint are")
    if adjoint in ("interpolating", "backsolve"):
        from .adjoint import continuous_odesolve

        return continuous_odesolve(
            adjoint, f, u0, tspan, rtol=rtol, atol=atol, saveat=saveat,
            max_steps=max_steps, step_fn=step_fn, reservoir=reservoir,
            stateful=stateful, f_state=f_state, **stored_kwargs,
        )
    if adjoint not in ("none", "direct"):
        raise ValueError(f"unknown adjoint {adjoint!r}")
    fn = f if stateful else (lambda u, t, st: (f(u, t), st))
    t0, t_end = float(tspan[0]), float(tspan[1])
    saveat_arr = (
        device_scalar(t_end, u0).reshape(1) if saveat is None
        else torch.atleast_1d(device_scalar(saveat, u0))
    )
    record = dict(record_knots=record_knots, knot_dense_cap=knot_dense_cap,
                  knot_stride=knot_stride, reservoir=reservoir)
    if persistent_fn is not None and adjoint == "none":
        def solve(u):
            return persistent_fn(
                u, (t0, t_end), saveat_arr=saveat_arr, rtol=rtol, atol=atol,
                max_steps=max_steps, f_state=f_state, **record,
            )

        if group is None:
            sol = solve(u0)
        else:
            from ..parallel.mesh import replicated

            _, sol = replicated(solve, u0, group)
        if sol is not None:
            return sol

    return loop_solve(fn, u0, t0, t_end, saveat_arr, f_state=f_state,
                      rtol=rtol, atol=atol, max_steps=max_steps,
                      step_fn=step_fn, group=group, **record)


def loop_solve(fn: Callable, u0, t0: float, t_end: float, saveat_arr, *,
               f_state, rtol, atol, max_steps, step_fn=None, group=None,
               **record) -> ODESolution:
    """The eager solve of ``odesolve``: k1 at t0 (in the graph), the Hairer
    dt probe (fenced), then ``adaptive_loop``; ``fn(u, t, st) -> (du,
    st)``, ``record`` as ``adaptive_loop``'s keywords, ``group`` the
    norms' ``DPGroup`` or None."""
    k1_0, f_st0 = fn(u0, t0, f_state)
    with torch.no_grad():  # the dt probe is fenced
        dt_init, nfe_dt = initial_step_size(
            lambda u, t: fn(u, t, f_state)[0], u0, device_scalar(t0, u0),
            order=5, rtol=rtol, atol=atol, f0=k1_0, group=group,
        )
        dt_init = torch.minimum(dt_init, device_scalar(t_end - t0, u0))
    nfe0 = 1 + nfe_dt
    out = adaptive_loop(
        fn, u0, k1_0, f_st0, t0, t_end, dt_init, saveat=saveat_arr,
        rtol=rtol, atol=atol, max_steps=max_steps, step_fn=step_fn,
        group=group, **record,
    )
    return ODESolution(
        ts=saveat_arr, ys=out["ys"], t_final=out["t_final"],
        y_final=out["y_final"], nfe=nfe0 + 6 * out["natt"],
        naccept=out["naccept"], nreject=out["nreject"],
        success=out["success"], f_state=out["f_state"],
        **{k: out.get(k) for k in KNOT_FIELDS + RESERVOIR_FIELDS},
    )
