"""The stored discretize-then-optimise adjoint: cost ∝ accepted steps.

Counterpart of ``localregneuralde_tpu/ode/stored_adjoint.py``.

- **Forward**: one solve that records knots ``(t_i, u_i, k1_i)`` at the
  accepted steps (``odesolve(record_knots=True)``): the persistent CUDA
  solve when the caller gives ``persistent_fn``, the eager loop otherwise.
- **Backward**: a reverse sweep over only the ``naccept`` recorded steps.
  Each step is transposed through the VJP of the step; the FSAL chain is
  carried as ``a_k`` (the cotangent on the incoming k1, i.e. the previous
  step's k7), and the saveat cotangents enter at the step whose interval
  holds each output time, with the Tsit5 interpolant's weights.
- **Two levels** for large ``max_steps``: dense knots for the first
  ``knot_window`` (default 512) accepts, plus a checkpoint every
  W = max(16, ⌈√max_steps⌉) accepts with the controller state
  ``(dt_next, qold)``. A solve that fits the dense knots is swept directly;
  a longer one replays one W-step window at a time from its checkpoint and
  sweeps it. The replay must repeat its own forward's arithmetic bitwise,
  so a kernel forward is swept only by the kernel sweep (``sweep_fn``) and
  an eager forward only by the eager sweep below.
- **The global grid** of data parallelism (``group``): the eager loop
  takes the group's norms; a kernel forward takes part in no collective,
  so it solves the whole batch, gathered from the ranks, on every rank
  (``parallel.mesh.replicated``), and each rank keeps its rows. A dense
  sweep takes no accept decision, so each rank sweeps its rows' knots; a
  two-level sweep replays the whole batch's windows, so each rank sweeps
  the whole batch with every rank's cotangents and keeps its rows and
  1/n of the parameters' gradients (the step's rank mean adds the shares).
  Where every step reads batch statistics (the conv family's kernels 13
  and 14, ``whole_batch``), the whole solve, forward and backward, runs
  so: the loop on the whole batch on every rank, then the sweep and the
  FSAL closure with every rank's cotangents.

Rejected attempts contribute nothing (their outputs are discarded), and
t, dt and the controller get no cotangents: the reference's fences.

Dynamics with state (``stateful=True``; BatchNorm running stats) thread it
through the forward on accepted steps only, as the eager loop does, and
return it as ``sol.f_state``, a fenced auxiliary output with no cotangent.
The backward transposes every step with the initial state: exact for
BatchNorm in training mode, which normalises with batch statistics
(reference ``ode/stored_adjoint.py:37-47``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from .controller import PIController, initial_step_size
from .solve import (
    KNOT_FIELDS,
    RESERVOIR_FIELDS,
    ODESolution,
    adaptive_loop,
    attempt,
    device_scalar,
)
from .step import tsit5_step
from .tableaus import tsit5_interp_weights

DEFAULT_KNOT_WINDOW = 512


def knot_layout(max_steps: int, knot_window: Optional[int] = None):
    """``(dense_cap, two_level, stride)`` of a stored solve."""
    dense_cap = min(max_steps, int(knot_window or DEFAULT_KNOT_WINDOW))
    two_level = dense_cap < max_steps
    stride = max(16, math.ceil(math.sqrt(float(max_steps)))) if two_level else 1
    return dense_cap, two_level, stride


def _zeros_for_none(grads, like):
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, like)]


def autograd_step_vjp(step: Callable) -> Callable:
    """``step_vjp`` from a step ``step(params, u, t, dt, k1) ->
    Tsit5StepResult``: the autograd VJP of ``(u_new, k2..k7)`` with respect
    to ``(params, u, k1)``."""

    def step_vjp(params, u, t, dt, k1, d_unew, d_ks):
        with torch.enable_grad():
            ps = [p.detach().requires_grad_() for p in params]
            u_ = u.detach().requires_grad_()
            k1_ = k1.detach().requires_grad_()
            res = step(ps, u_, t, dt, k1_)
            grads = torch.autograd.grad(
                [res.u_new, *res.ks[1:]], ps + [u_, k1_], [d_unew, *d_ks],
                allow_unused=True,
            )
        grads = _zeros_for_none(grads, ps + [u_, k1_])
        return grads[:-2], grads[-2], grads[-1]

    return step_vjp


def sweep_steps(step_vjp: Callable, params, ts, us, k1_of: Callable, n: int,
                saveat, ct_ys, a_u, a_k, a_p):
    """Transpose steps ``n-1 .. 0`` of the knots ``(ts, us)``: step j goes
    from ``(us[j], ts[j])`` to ``ts[j+1]`` with FSAL derivative
    ``k1_of(j)``. Returns the carries ``(a_u, a_k, a_p)``."""
    bshape = (-1,) + (1,) * (us.ndim - 1)
    for j in range(n - 1, -1, -1):
        t, tn = ts[j], ts[j + 1]
        dt = tn - t
        u = us[j]
        theta = torch.clamp((saveat - t) / dt, 0.0, 1.0)
        hit = ((saveat > t) & (saveat <= tn)).to(u.dtype)
        bs = tsit5_interp_weights(theta)
        d_u_interp = torch.sum(ct_ys * hit.reshape(bshape), dim=0)

        def k_ct(m):
            return torch.sum((dt * bs[m] * hit).reshape(bshape) * ct_ys, dim=0)

        d_ks = (k_ct(1), k_ct(2), k_ct(3), k_ct(4), k_ct(5), k_ct(6) + a_k)
        d_p, d_u, d_k1 = step_vjp(params, u, t, dt, k1_of(j), a_u, d_ks)
        a_u = d_u + d_u_interp
        a_k = d_k1 + k_ct(0)
        a_p = [a + d for a, d in zip(a_p, d_p)]
    return a_u, a_k, a_p


def replay_window(step: Callable, ckpt, w: int, n_steps: int, t_end,
                  max_steps: int, *, rtol, atol, group=None):
    """Re-integrate the ≤ ``n_steps`` accepted steps of window ``w`` from
    its checkpoint with ``attempt``, the forward loop's own attempt, so the
    accept and dt sequence repeats the forward's. ``step(u, t, dt, k1)``.
    Returns the window's knots ``(ts, us, ks, n_accepted)``."""
    controller = PIController()
    t, u, k1 = ckpt["ckpt_ts"][w], ckpt["ckpt_us"][w], ckpt["ckpt_ks"][w]
    dt, qold = ckpt["ckpt_dts"][w], ckpt["ckpt_qolds"][w]
    ts, us, ks = [t], [u], [k1]
    i = att = 0
    while i < n_steps and att < max_steps:
        a = attempt(lambda u_, t_, dt_, k1_, _: step(u_, t_, dt_, k1_),
                    controller, u, t, dt, qold, t_end, k1, None,
                    atol=atol, rtol=rtol, group=group)
        att += 1
        if a.accept:
            i += 1
            u, k1, t = a.res.u_new, a.res.ks[6], a.t_new
            dt, qold = a.dt_acc, a.qold_acc
            ts.append(t)
            us.append(u)
            ks.append(k1)
        else:
            dt = a.dt_rej
    return torch.stack(ts), torch.stack(us), torch.stack(ks), i


def eager_sweep(step: Callable, step_vjp: Callable, params, knots, naccept,
                saveat, ct_ys, ct_y, *, two_level, t_end, rtol, atol,
                max_steps, stride, dense_cap, k1_of=None, group=None):
    """The whole reverse sweep on the host: dense over the recorded knots,
    or window by window from the checkpoints when the solve outgrew
    ``dense_cap``. ``k1_of(us, ts, ks, j)`` gives a step's FSAL derivative
    (default: the recorded ``ks[j]``). A window replay on the global grid
    (``group``) takes its forward's collectives again, on every rank in the
    same order. Returns ``(a_u, a_k, a_p)``."""
    if k1_of is None:
        def k1_of(us, ts, ks, j):  # noqa: F811
            return ks[j]
    n = int(naccept)
    a = (ct_y, torch.zeros_like(ct_y), [torch.zeros_like(p) for p in params])
    if not two_level or n <= dense_cap:
        ts, us, ks = knots["knot_ts"], knots["knot_us"], knots.get("knot_ks")
        return sweep_steps(step_vjp, params, ts, us,
                           lambda j: k1_of(us, ts, ks, j), n, saveat, ct_ys, *a)
    for w in range((n - 1) // stride, -1, -1):
        n_steps = min(max(n - w * stride, 0), stride)
        ts, us, ks, got = replay_window(
            lambda u, t, dt, k1: step(params, u, t, dt, k1), knots, w,
            n_steps, t_end, max_steps, rtol=rtol, atol=atol, group=group,
        )
        # sweep what the replay accepted: an accept flip must not sweep
        # slots it never wrote
        a = sweep_steps(step_vjp, params, ts, us,
                        lambda j: k1_of(us, ts, ks, j), min(got, n_steps),
                        saveat, ct_ys, *a)
    return a


def _whole_batch_sweep(spec, params, ct_ys, ct_y):
    """The kernel sweep of a kernel forward on the global grid whose
    accepts outgrew the dense knots: its windows replay the whole batch's
    forward, so every rank sweeps the whole batch (``spec.whole``) with
    every rank's cotangents and keeps its rows of ``(a_u, a_k)`` and 1/n
    of the parameters' gradients, which the step's rank mean adds up to
    the whole batch's."""
    from ..parallel.mesh import gather_rows, rank_rows

    dp, whole = spec.group, spec.whole
    knots = {k: getattr(whole, k) for k in KNOT_FIELDS}
    a_u, a_k, a_p = spec.sweep_fn(
        params, whole.knot_ts, whole.knot_us, whole.naccept, whole.ts,
        gather_rows(ct_ys, dp, 1), gather_rows(ct_y, dp),
        two_level_ctx=spec.two_level_ctx(knots),
    )
    return (rank_rows(a_u, dp), rank_rows(a_k, dp),
            [p / dp.size for p in a_p])


def _whole_batch_adjoint(spec, params, ct_ys, ct_y, from_kernel):
    """The backward of a ``whole_batch`` solve on the global grid: the
    adjoint of the whole batch's forward (``spec.whole``) with every rank's
    cotangents; this rank's rows of the input's cotangent and 1/n of the
    parameters', which the step's rank mean adds up to the whole batch's."""
    from ..parallel.mesh import gather_rows, rank_rows

    dp = spec.group
    d_u0, d_params = _adjoint(spec, spec.whole, from_kernel, spec.whole_u0,
                              params, gather_rows(ct_ys, dp, 1),
                              gather_rows(ct_y, dp), None)
    return rank_rows(d_u0, dp), [p / dp.size for p in d_params]


def _adjoint(spec, sol, from_kernel, u0, params, ct_ys, ct_y, group):
    """``(d_u0, d_params)`` of the solve ``sol`` from ``u0``: the sweep of
    its knots (the kernel's, or the eager one with the norms of
    ``group``), then the closure of the FSAL chain at t0."""
    knots = {k: getattr(sol, k) for k in KNOT_FIELDS}
    if from_kernel and spec.whole is not None and not spec.whole_batch and (
            int(sol.naccept) > spec.dense_cap):
        a_u, a_k, a_p = _whole_batch_sweep(spec, params, ct_ys, ct_y)
    elif from_kernel:
        a_u, a_k, a_p = spec.sweep_fn(
            params, sol.knot_ts, sol.knot_us, sol.naccept, sol.ts, ct_ys,
            ct_y, two_level_ctx=spec.two_level_ctx(knots),
        )
    else:
        a_u, a_k, a_p = eager_sweep(
            spec.raw_step, spec.step_vjp, params, knots, sol.naccept,
            sol.ts, ct_ys, ct_y, two_level=spec.two_level,
            t_end=device_scalar(spec.t_end, u0), rtol=spec.rtol,
            atol=spec.atol, max_steps=spec.max_steps, stride=spec.stride,
            dense_cap=spec.dense_cap, group=group,
        )
    # close the FSAL chain: k1_0 = f(u0, t0, params), plain autograd
    with torch.enable_grad():
        u0_ = u0.detach().requires_grad_()
        ps = [p.detach().requires_grad_() for p in params]
        k1_0 = spec.fsal_fn(u0_, device_scalar(spec.t0, u0), ps)
        grads = torch.autograd.grad(k1_0, [u0_] + ps, a_k,
                                    allow_unused=True)
    grads = _zeros_for_none(grads, [u0_] + ps)
    # saveat entries the forward never wrote hold u0: times ≤ t0, and
    # times past the last accepted step of a truncated solve
    unwritten = ((sol.ts <= spec.t0) | (sol.ts > sol.t_final)).to(u0.dtype)
    d_u0_pre = torch.sum(
        ct_ys * unwritten.reshape((-1,) + (1,) * u0.ndim), dim=0
    )
    d_u0 = a_u + grads[0] + d_u0_pre
    return d_u0, [a + g for a, g in zip(a_p, grads[1:])]


class _StoredSolve(torch.autograd.Function):
    """``(u0, *params) -> (ys, y_final)`` with the stored adjoint as its
    backward. ``spec`` carries the solver and its callbacks; the fenced
    auxiliaries (NFE, success, knots) land on ``spec.sol``."""

    @staticmethod
    def forward(ctx, spec, u0, *params):
        with torch.no_grad():
            sol, from_kernel = spec.run(u0, params)
        spec.sol = sol
        ctx.spec = spec
        ctx.from_kernel = from_kernel
        ctx.save_for_backward(u0, *params)
        return sol.ys, sol.y_final

    @staticmethod
    def backward(ctx, ct_ys, ct_y):
        spec = ctx.spec
        u0, *params = ctx.saved_tensors
        if spec.whole_batch and spec.group is not None:
            d_u0, d_params = _whole_batch_adjoint(spec, params, ct_ys, ct_y,
                                                  ctx.from_kernel)
        else:
            d_u0, d_params = _adjoint(spec, spec.sol, ctx.from_kernel, u0,
                                      params, ct_ys, ct_y, spec.group)
        # the outputs are sol's tensors, whose grad_fn is this node: drop
        # the spec, so that the knots go with the step, not at the next
        # cyclic garbage collection
        ctx.spec = None
        return (None, d_u0, *d_params)


class _Spec:
    """The configuration a stored solve carries from its forward into its
    backward."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def f_pure(self, u, t, params):
        """``f`` as a function of ``(u, t, params)``, with the initial state
        when it is stateful."""
        if self.stateful:
            return self.f(u, t, params, self.f_state)[0]
        return self.f(u, t, params)

    def raw_step(self, params, u, t, dt, k1):
        """A step from the initial state: the unit the backward transposes."""
        if self.step_fn is not None:
            if self.stateful:
                return self.step_fn(params, u, t, dt, k1, self.f_state)
            return self.step_fn(params, u, t, dt, k1)
        return tsit5_step(lambda u_, t_, st: (self.f_pure(u_, t_, params), st),
                          u, t, dt, k1, None)

    def run(self, u0, params):
        """The forward solve with knots; returns ``(sol, from_kernel)``. A
        ``whole_batch`` solve on the global grid solves the whole batch,
        gathered from the ranks, on every rank and keeps it for the
        backward (``spec.whole``); ``sol`` is this rank's rows of it."""
        if self.whole_batch and self.group is not None:
            from ..parallel.mesh import gather_rows, rank_solution

            self.whole_u0 = gather_rows(u0, self.group)
            self.whole, from_kernel = self._run(self.whole_u0, params, None)
            return rank_solution(self.whole, self.group), from_kernel
        return self._run(u0, params, self.group)

    def _run(self, u0, params, group):
        """``run`` from ``u0`` with the norms of ``group``."""
        rec = dict(record_knots=True, knot_dense_cap=self.dense_cap,
                   knot_stride=self.stride, reservoir=self.reservoir)
        if self.persistent_fn is not None:
            def solve(u):
                return self.persistent_fn(
                    u, params, (self.t0, self.t_end),
                    saveat_arr=self.saveat_arr, rtol=self.rtol,
                    atol=self.atol, max_steps=self.max_steps, **rec,
                )

            if group is None:
                sol = solve(u0)
            else:
                from ..parallel.mesh import replicated

                whole, sol = replicated(solve, u0, group)
                # a two-level sweep replays the whole batch's windows
                self.whole = whole if self.two_level else None
            if sol is not None:
                return sol, True
        if self.stateful:
            def fn(u, t, st):
                return self.f(u, t, params, st)
        else:
            def fn(u, t, st):
                return self.f(u, t, params), st
        # k1 at t0 advances the state; the dt probe sees the initial one
        k1_0, st0 = fn(u0, self.t0, self.f_state)
        dt_init, nfe_dt = initial_step_size(
            lambda u, t: self.f_pure(u, t, params), u0,
            device_scalar(self.t0, u0), order=5, rtol=self.rtol,
            atol=self.atol, f0=k1_0, group=group,
        )
        dt_init = torch.minimum(
            dt_init, device_scalar(self.t_end - self.t0, u0)
        )
        step_fn = None
        if self.step_fn is not None and self.stateful:
            def step_fn(_fn, u, t, dt, k1, st):
                return self.step_fn(params, u, t, dt, k1, st)
        elif self.step_fn is not None:
            def step_fn(_fn, u, t, dt, k1, st):
                return self.step_fn(params, u, t, dt, k1)._replace(f_state=st)
        out = adaptive_loop(
            fn, u0, k1_0, st0, self.t0, self.t_end, dt_init,
            saveat=self.saveat_arr, rtol=self.rtol, atol=self.atol,
            max_steps=self.max_steps, step_fn=step_fn, group=group,
            **rec,
        )
        return ODESolution(
            ts=self.saveat_arr, ys=out["ys"], t_final=out["t_final"],
            y_final=out["y_final"], nfe=1 + nfe_dt + 6 * out["natt"],
            naccept=out["naccept"], nreject=out["nreject"],
            success=out["success"], f_state=out["f_state"],
            **{k: out.get(k) for k in KNOT_FIELDS + RESERVOIR_FIELDS},
        ), False

    def two_level_ctx(self, knots):
        if not self.two_level:
            return None
        return dict(
            knots, t_end=self.t_end, rtol=self.rtol, atol=self.atol,
            max_steps=self.max_steps, stride=self.stride,
            dense_cap=self.dense_cap,
        )


def stored_odesolve(
    f: Callable,
    u0: torch.Tensor,
    tspan,
    params: Sequence[torch.Tensor],
    *,
    rtol: float = 1e-7,
    atol: float = 1e-7,
    saveat=None,
    max_steps: int = 256,
    knot_window: Optional[int] = None,
    step_fn: Optional[Callable] = None,
    step_vjp: Optional[Callable] = None,
    persistent_fn: Optional[Callable] = None,
    sweep_fn: Optional[Callable] = None,
    fsal_fn: Optional[Callable] = None,
    reservoir: Optional[torch.Tensor] = None,
    stateful: bool = False,
    f_state=None,
    group=None,
    whole_batch: bool = False,
) -> ODESolution:
    """Integrate ``du/dt = f(u, t, params)`` with gradients with respect to
    ``u0`` and ``params`` through the stored adjoint.

    ``f`` takes the parameters explicitly, because the backward runs after
    the caller's forward has returned. Optional replacements, each given the
    parameters:

    - ``step_fn(params, u, t, dt, k1) -> Tsit5StepResult`` for the eager
      loop's step, and ``step_vjp(params, u, t, dt, k1, d_unew, d_ks) ->
      (d_params, d_u, d_k1)`` for its transpose (default: autograd of the
      step);
    - ``persistent_fn(u0, params, tspan, *, saveat_arr, rtol, atol,
      max_steps, record_knots, knot_dense_cap, knot_stride, reservoir) ->
      ODESolution``
      for the whole forward, and ``sweep_fn(params, knot_ts, knot_us,
      naccept, saveat_arr, ct_ys, ct_y, two_level_ctx) -> (a_u, a_k,
      d_params)`` for the whole sweep of that forward;
    - ``fsal_fn(u, t, params)``, a differentiable twin of ``f`` for the
      closure of the FSAL chain at t0 (default ``f``).

    ``reservoir`` (``max_steps`` uniforms) makes the forward keep the
    biased regulariser's reservoir sample (``reservoir_t``,
    ``reservoir_u``, both fenced).

    With ``stateful=True`` the dynamics carries a state, starting from
    ``f_state``: ``f(u, t, params, st) -> (du, st)`` and ``step_fn(params,
    u, t, dt, k1, st) -> Tsit5StepResult`` with the state after the step.
    The forward threads it on accepted steps and returns it as
    ``f_state``; ``fsal_fn`` and the backward see the initial state.

    With a ``DPGroup`` (``group``, the global grid of data parallelism)
    ``u0`` is this rank's rows and every norm of the forward (and of a
    window replay) is over all the ranks' rows; ``persistent_fn`` solves
    the whole batch on every rank and ``sweep_fn`` sweeps this rank's rows
    of its knots, or the whole batch where its windows replay (the
    module's docstring). With ``whole_batch`` every rank solves and sweeps
    the whole batch, gathered from the ranks, with no group (dynamics
    whose every step reads the batch's statistics).
    """
    t0, t_end = float(tspan[0]), float(tspan[1])
    saveat_arr = (
        device_scalar(t_end, u0).reshape(1) if saveat is None
        else torch.atleast_1d(device_scalar(saveat, u0))
    )
    dense_cap, two_level, stride = knot_layout(max_steps, knot_window)
    spec = _Spec(
        f=f, t0=t0, t_end=t_end, saveat_arr=saveat_arr, rtol=rtol, atol=atol,
        max_steps=max_steps, dense_cap=dense_cap, two_level=two_level,
        stride=stride, step_fn=step_fn, persistent_fn=persistent_fn,
        sweep_fn=sweep_fn, fsal_fn=fsal_fn, reservoir=reservoir,
        stateful=stateful, f_state=f_state, group=group, whole=None, sol=None,
        whole_batch=bool(whole_batch),
    )
    if spec.fsal_fn is None:
        spec.fsal_fn = spec.f_pure
    spec.step_vjp = step_vjp or autograd_step_vjp(spec.raw_step)
    ys, y_final = _StoredSolve.apply(spec, u0, *params)
    sol = spec.sol
    return ODESolution(
        ts=saveat_arr, ys=ys, t_final=sol.t_final, y_final=y_final,
        nfe=sol.nfe, naccept=sol.naccept, nreject=sol.nreject,
        success=sol.success, f_state=sol.f_state,
        reservoir_t=sol.reservoir_t, reservoir_u=sol.reservoir_u,
    )
