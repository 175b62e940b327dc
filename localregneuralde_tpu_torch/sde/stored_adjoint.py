"""The stored discretise-then-optimise adjoint of the SDE solver.

Counterpart of ``localregneuralde_tpu/sde/stored_adjoint.py``.

- **Forward**: one solve that records the knots ``(t_i, u_i)`` at the
  accepted steps and each accepted step's increments ``(dW_i, dZ_i)``: the
  persistent CUDA solve when the caller gives ``persistent_fn``, the eager
  loop otherwise. The fenced auxiliaries (NFE, success, reservoir sample)
  come from the same solve.
- **Backward**: a reverse sweep over the ``naccept`` recorded steps. Each
  step (SRI, Milstein — with matrix noise too, its knots holding the
  ``(B, m)`` increments — or Lamba–Euler–Heun) is transposed with its
  **recorded** increments, so the gradient is exact for the realised
  trajectory whichever program drew the noise, and the noise is never
  differentiated. These steps have no FSAL chain, so the state cotangent
  is the only carry. The saveat cotangents split linearly:
  ``y_s = u + θ(u_new − u)`` gives ``d_u += (1 − θ)·ct`` and
  ``d_u_new += θ·ct``. ``sweep_fn`` replaces the eager sweep with the
  persistent sweep kernel; it reads the same recorded knots.

Saveat entries the forward never wrote hold u0: times ≤ t0, and times past
the last accepted knot of a solve that ran out of ``max_steps``. Their
cotangents pass straight to ``d_u0``; dropping the second kind zeroed
``d_u0`` exactly when the steps ran out. dt and the controller get no
cotangents (the reference's fences).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .solve import (
    SDESolution,
    initial_dt,
    replicated_sde,
    saveat_array,
    sde_loop,
    sde_step,
    solution_from,
)
from .step import step_nfe


def _zeros_for_none(grads, like):
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, like)]


def autograd_step_vjp(f: Callable, g: Callable, *, solver, delta, atol, rtol,
                      noise_shape=None):
    """``step_vjp(params, u, t, dt, dW, dZ, d_unew) -> (d_params, d_u)``:
    the autograd VJP of the step's ``u_new`` with respect to the
    parameters and ``u``, for ``f(u, t, params)`` and ``g(u, t, params)``."""
    step = sde_step(solver, noise_shape, delta)

    def step_vjp(params, u, t, dt, dW, dZ, d_unew):
        with torch.enable_grad():
            ps = [p.detach().requires_grad_() for p in params]
            u_ = u.detach().requires_grad_()
            res = step(lambda x, s: f(x, s, ps), lambda x, s: g(x, s, ps),
                       u_, t, dt, dW, dZ, atol, rtol)
            grads = torch.autograd.grad(res.u_new, ps + [u_], d_unew,
                                        allow_unused=True)
        grads = _zeros_for_none(grads, ps + [u_])
        return grads[:-1], grads[-1]

    return step_vjp


def eager_sde_sweep(step_vjp: Callable, params, knot_ts, knot_us, knot_dws,
                    knot_dzs, naccept, saveat, ct_ys, ct_y):
    """Transpose the recorded steps ``naccept − 1 .. 0`` on the host.
    Returns ``(a_u, d_params)``: the state cotangent at t0 and the
    parameter gradients."""
    bshape = (-1,) + (1,) * ct_y.ndim
    a_u = ct_y
    a_p = [torch.zeros_like(p) for p in params]
    for j in range(int(naccept) - 1, -1, -1):
        t, tn = knot_ts[j], knot_ts[j + 1]
        dt = tn - t
        theta = torch.clamp((saveat - t) / dt, 0.0, 1.0).reshape(bshape)
        hit = ((saveat > t) & (saveat <= tn)).to(ct_y.dtype).reshape(bshape)
        ct_hit = ct_ys * hit
        d_u_interp = torch.sum((1.0 - theta) * ct_hit, dim=0)
        d_unew_interp = torch.sum(theta * ct_hit, dim=0)
        d_p, d_u = step_vjp(params, knot_us[j], t, dt, knot_dws[j],
                            knot_dzs[j], a_u + d_unew_interp)
        a_u = d_u + d_u_interp
        a_p = [a + d for a, d in zip(a_p, d_p)]
    return a_u, a_p


class _StoredSDESolve(torch.autograd.Function):
    """``(u0, *params) -> (ys, y_final)`` with the stored adjoint as its
    backward; the fenced auxiliaries land on ``spec.sol``."""

    @staticmethod
    def forward(ctx, spec, u0, *params):
        with torch.no_grad():
            spec.sol = spec.run(u0, params)
        ctx.spec = spec
        ctx.save_for_backward(u0, *params)
        return spec.sol.ys, spec.sol.y_final

    @staticmethod
    def backward(ctx, ct_ys, ct_y):
        spec, sol = ctx.spec, ctx.spec.sol
        u0, *params = ctx.saved_tensors
        naccept = sol.naccept.reshape(1).long()
        t_last = torch.index_select(sol.knot_ts, 0, naccept).reshape(())
        unwritten = ((sol.ts <= spec.t0) | (sol.ts > t_last)).to(u0.dtype)
        d_u0_pre = torch.sum(
            ct_ys * unwritten.reshape((-1,) + (1,) * u0.ndim), dim=0
        )
        knots = (sol.knot_ts, sol.knot_us, sol.knot_dws, sol.knot_dzs)
        if spec.sweep_fn is not None:
            a_u, d_p = spec.sweep_fn(params, *knots, sol.naccept, sol.ts,
                                     ct_ys, ct_y)
        else:
            step_vjp = autograd_step_vjp(spec.f, spec.g, solver=spec.solver,
                                         delta=spec.delta, atol=spec.atol,
                                         rtol=spec.rtol,
                                         noise_shape=spec.noise_shape)
            a_u, d_p = eager_sde_sweep(step_vjp, params, *knots,
                                       sol.naccept, sol.ts, ct_ys, ct_y)
        # the outputs are sol's tensors, whose grad_fn is this node: drop
        # the spec, so that the knots go with the step, not at the next
        # cyclic garbage collection
        ctx.spec = None
        return (None, a_u + d_u0_pre, *d_p)


class _Spec:
    """What a stored solve carries from its forward into its backward."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def run(self, u0, params):
        """The forward solve with knots."""
        kw = dict(noise=self.noise, saveat_arr=self.saveat_arr,
                  rtol=self.rtol, atol=self.atol, solver=self.solver,
                  delta=self.delta, max_steps=self.max_steps,
                  record_knots=True, reservoir=self.reservoir,
                  brownian_depth=self.brownian_depth)
        if self.persistent_fn is not None:
            return replicated_sde(
                lambda u, **k: self.persistent_fn(u, params,
                                                  (self.t0, self.t_end), **k),
                u0, self.group, **kw)
        f = lambda u, t: self.f(u, t, params)  # noqa: E731
        g = lambda u, t: self.g(u, t, params)  # noqa: E731
        dt_init = initial_dt(u0, f(u0, self.t0), self.rtol, self.atol,
                             self.t0, self.t_end, self.group)
        out = sde_loop(
            f, g, u0, self.t0, self.t_end, dt_init, noise=self.noise,
            saveat=self.saveat_arr, rtol=self.rtol, atol=self.atol,
            solver=self.solver, delta=self.delta, max_steps=self.max_steps,
            reservoir=self.reservoir, brownian_depth=self.brownian_depth,
            record_knots=True, noise_shape=self.noise_shape,
            group=self.group,
        )
        m = None if self.noise_shape is None else self.noise_shape[-1]
        return solution_from(out, self.saveat_arr, step_nfe(self.solver, m))


def stored_sdesolve(
    f: Callable,
    g: Callable,
    u0: torch.Tensor,
    tspan,
    params: Sequence[torch.Tensor] = (),
    *,
    noise,
    rtol: float = 1e-2,
    atol: float = 1e-2,
    solver: str = "sri",
    delta: float = 1 / 6,
    saveat=None,
    max_steps: int = 256,
    reservoir: Optional[torch.Tensor] = None,
    brownian_depth: int = 24,
    persistent_fn: Optional[Callable] = None,
    sweep_fn: Optional[Callable] = None,
    noise_shape=None,
    group=None,
) -> SDESolution:
    """Integrate ``du = f(u, t, params) dt + g(u, t, params) dW`` with
    gradients with respect to ``u0`` and ``params`` through the stored
    adjoint.

    Optional kernel replacements, each given the parameters:
    ``persistent_fn(u0, params, tspan, *, noise, saveat_arr, rtol, atol,
    solver, delta, max_steps, record_knots, reservoir, brownian_depth)
    -> SDESolution`` for the recording forward, and ``sweep_fn(params,
    knot_ts, knot_us, knot_dws, knot_dzs, naccept, saveat_arr, ct_ys,
    ct_y) -> (a_u, d_params)`` for the sweep. When given they replace the
    eager loop and the autograd sweep; ``f`` and ``g`` are then not called.
    ``noise_shape`` as ``sdesolve``'s (non-diagonal Milstein).

    With a ``DPGroup`` (``group``, the global grid of data parallelism)
    ``u0`` is this rank's rows and every norm of the forward is over all
    the ranks' rows: the eager loop takes the group's norms, and
    ``persistent_fn`` solves the whole batch, gathered from the ranks, on
    every rank (``solve.replicated_sde``). The backward (``sweep_fn`` where
    given) transposes this rank's rows of the shared steps, taking no
    collective.
    """
    t0, t_end = float(tspan[0]), float(tspan[1])
    saveat_arr = saveat_array(saveat, t_end, u0)
    spec = _Spec(
        f=f, g=g, t0=t0, t_end=t_end, saveat_arr=saveat_arr, rtol=rtol,
        atol=atol, solver=solver, delta=delta, max_steps=max_steps,
        noise=noise, reservoir=reservoir, brownian_depth=brownian_depth,
        persistent_fn=persistent_fn, sweep_fn=sweep_fn,
        noise_shape=noise_shape, group=group, sol=None,
    )
    ys, y_final = _StoredSDESolve.apply(spec, u0, *params)
    sol = spec.sol
    return SDESolution(
        ts=saveat_arr, ys=ys, t_final=sol.t_final, y_final=y_final,
        nfe_drift=sol.nfe_drift, nfe_diffusion=sol.nfe_diffusion,
        naccept=sol.naccept, nreject=sol.nreject, success=sol.success,
        reservoir_t=sol.reservoir_t, reservoir_u=sol.reservoir_u,
    )
