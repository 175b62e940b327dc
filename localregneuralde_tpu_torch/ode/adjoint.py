"""The continuous adjoints: backsolve, and the machinery it shares with the
interpolating adjoint (``ode/interp_adjoint.py``).

Counterpart of ``localregneuralde_tpu/ode/adjoint.py``
(``odesolve(..., adjoint='backsolve')``):

- **Forward**: the eager loop with ``adjoint='none'`` (``solve.loop_solve``),
  with the caller's step (the fused step kernel on the TD-MLP's route).
  Its fenced auxiliaries (NFE, success, reservoir, dynamics state) come
  from the same solve.
- **Backward**: one adaptive Tsit5 solve in reversed time, τ = −t, of the
  augmented state ``(u, a_u, a_p)``: ``du/dτ = −f``, ``da_u/dτ = a_uᵀ∂f/∂u``
  and ``da_p/dτ = a_uᵀ∂f/∂p``, each product one autograd VJP of the
  dynamics (the reference's per-evaluation ``jax.vjp``). The state is
  flattened into one vector, so one RMS error norm covers all of it, as
  ``ravel_pytree`` does there. The saveat cotangents are injected segment
  by segment at their output times, in descending order, and a last
  segment reaches t0 with a zero cotangent.

Memory is O(state) whatever the number of steps. t, dt and the controller
get no cotangents; the dynamics state is fenced (the backward evaluates
``f`` with the initial state).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .solve import ODESolution, device_scalar, loop_solve


def flatten(tensors) -> torch.Tensor:
    """The tensors' elements in one vector, in order."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten(vec: torch.Tensor, likes) -> list:
    """``flatten``'s inverse for tensors shaped as ``likes``."""
    out, i = [], 0
    for like in likes:
        n = like.numel()
        out.append(vec[i:i + n].reshape(like.shape))
        i += n
    return out


def vjp(f_pure: Callable, u, t, params, a):
    """``(f(u, t, params), a·∂f/∂u, a·∂f/∂params)`` by autograd, every
    result detached (a zero where a parameter does not reach ``f``)."""
    with torch.enable_grad():
        u_ = u.detach().requires_grad_()
        ps = [p.detach().requires_grad_() for p in params]
        du = f_pure(u_, t, ps)
        grads = torch.autograd.grad(du, [u_] + ps, a, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, [u_] + ps)]
    return du.detach(), grads[0], grads[1:]


def reverse_segments(f_aug: Callable, state0, saveat, ct_ys, t0: float,
                     t_end: float, inject: Callable, *, rtol, atol,
                     max_steps):
    """Integrate the flat augmented state ``state0`` from τ = −t_end to
    −t0, stopping at each saveat time (descending, clipped to the span) to
    add its cotangent with ``inject(state, ct) -> state``. ``f_aug(vec, τ)``
    is the augmented dynamics. Returns the final state."""
    order = torch.argsort(-saveat, stable=True)
    events = torch.clamp(saveat[order], t0, t_end)
    taus = torch.cat([-events, device_scalar(-t0, saveat).reshape(1)])
    cts = torch.cat([ct_ys[order], torch.zeros_like(ct_ys[:1])])
    state, tau = state0, float(-torch.tensor(t_end, dtype=torch.float32))
    for tau_next, ct in zip(taus.tolist(), cts):
        seg = loop_solve(
            lambda v, s, st: (f_aug(v, s), st), state, tau, tau_next,
            device_scalar(tau_next, state).reshape(1), f_state=None,
            rtol=rtol, atol=atol, max_steps=max_steps,
        )
        state, tau = inject(seg.y_final, ct), tau_next
    return state


class _ContinuousSolve(torch.autograd.Function):
    """``(u0, *params) -> (ys, y_final)`` with a continuous adjoint as its
    backward (``spec.backward``); the fenced auxiliaries land on
    ``spec.sol``."""

    @staticmethod
    def forward(ctx, spec, u0, *params):
        with torch.no_grad():
            spec.sol = spec.run(u0, params)
        ctx.spec = spec
        ctx.save_for_backward(u0, *params)
        return spec.sol.ys, spec.sol.y_final

    @staticmethod
    def backward(ctx, ct_ys, ct_y):
        spec = ctx.spec
        u0, *params = ctx.saved_tensors
        with torch.no_grad():
            d_u0, d_params = spec.backward(u0, params, ct_ys, ct_y)
        ctx.spec = None  # the knots go with the step (no reference cycle)
        return (None, d_u0, *d_params)


class ContinuousSpec:
    """What a continuous-adjoint solve carries from its forward into its
    backward. ``mode`` is ``'backsolve'`` or ``'interpolating'``."""

    def __init__(self, mode, f, t0, t_end, saveat_arr, *, rtol, atol,
                 max_steps, step_fn, reservoir, stateful, f_state):
        self.__dict__.update(
            mode=mode, f=f, t0=t0, t_end=t_end, saveat_arr=saveat_arr,
            rtol=rtol, atol=atol, max_steps=max_steps, step_fn=step_fn,
            reservoir=reservoir, stateful=stateful, f_state=f_state,
            sol=None, knots=None)

    def f_pure(self, u, t, params):
        """``f`` of ``(u, t, params)``, with the initial state when it is
        stateful (the state is fenced under these adjoints)."""
        if self.stateful:
            return self.f(u, t, params, self.f_state)[0]
        return self.f(u, t, params)

    def run(self, u0, params) -> ODESolution:
        """The forward: the eager loop, recording the knots ``(t, u, k1)``
        of every accepted step for the interpolating adjoint."""
        if self.stateful:
            def fn(u, t, st):
                return self.f(u, t, params, st)
        else:
            def fn(u, t, st):
                return self.f(u, t, params), st
        step = None
        if self.step_fn is not None:
            def step(_fn, u, t, dt, k1, st):
                if self.stateful:
                    return self.step_fn(params, u, t, dt, k1, st)
                return self.step_fn(params, u, t, dt, k1)._replace(f_state=st)
        on_accept = None
        if self.mode == "interpolating":
            t0 = device_scalar(self.t0, u0)
            knots = self.knots = []

            def on_accept(a):
                if not knots:  # knot 0: u0 and the first step's k1 (k1_0)
                    knots.append((t0, u0, a.res.ks[0]))
                knots.append((a.t_new, a.res.u_new, a.res.ks[6]))
        sol = loop_solve(
            fn, u0, self.t0, self.t_end, self.saveat_arr,
            f_state=self.f_state, rtol=self.rtol, atol=self.atol,
            max_steps=self.max_steps, step_fn=step, reservoir=self.reservoir,
            on_accept=on_accept,
        )
        if self.knots == []:  # no accepted step: u(t) is u0
            self.knots.append((t0, u0, torch.zeros_like(u0)))
        return sol

    def backward(self, u0, params, ct_ys, ct_y):
        """``(d_u0, d_params)`` from the reverse solve of the augmented
        state."""
        solve_kw = dict(rtol=self.rtol, atol=self.atol,
                        max_steps=self.max_steps)
        zero_p = [torch.zeros_like(p) for p in params]
        if self.mode == "backsolve":
            y_final = self.sol.y_final
            likes = [y_final, y_final, *params]

            def f_aug(vec, tau):
                u, a, *_ = unflatten(vec, likes)
                du, vu, vp = vjp(self.f_pure, u, -tau, params, a)
                return flatten([-du, vu, *vp])

            def inject(vec, ct):
                u, a, *g = unflatten(vec, likes)
                return flatten([u, a + ct, *g])

            state0 = flatten([y_final, ct_y, *zero_p])
            n_skip = 1
        else:
            from .interp_adjoint import hermite_at

            ts = torch.stack([k[0] for k in self.knots])
            us = torch.stack([k[1] for k in self.knots])
            ks = torch.stack([k[2] for k in self.knots])
            likes = [ct_y, *params]

            def f_aug(vec, tau):
                a, *_ = unflatten(vec, likes)
                t = -device_scalar(tau, vec)
                u = hermite_at(ts, us, ks, t)
                _, vu, vp = vjp(self.f_pure, u, t, params, a)
                return flatten([vu, *vp])

            def inject(vec, ct):
                a, *g = unflatten(vec, likes)
                return flatten([a + ct, *g])

            state0 = flatten([ct_y, *zero_p])
            n_skip = 0
        final = reverse_segments(f_aug, state0, self.saveat_arr, ct_ys,
                                 self.t0, self.t_end, inject, **solve_kw)
        parts = unflatten(final, likes)
        return parts[n_skip], parts[n_skip + 1:]


def continuous_odesolve(
    mode: str,
    f: Callable,
    u0: torch.Tensor,
    tspan,
    params: Sequence[torch.Tensor] = (),
    *,
    rtol: float = 1e-7,
    atol: float = 1e-7,
    saveat=None,
    max_steps: int = 256,
    step_fn: Optional[Callable] = None,
    reservoir: Optional[torch.Tensor] = None,
    stateful: bool = False,
    f_state=None,
    **unused,
) -> ODESolution:
    """Integrate ``du/dt = f(u, t, params)`` with gradients with respect to
    ``u0`` and ``params`` through the ``'backsolve'`` or ``'interpolating'``
    adjoint. ``step_fn(params, u, t, dt, k1) -> Tsit5StepResult`` replaces
    the forward's generic step (with ``stateful``: ``step_fn(params, u, t,
    dt, k1, st)`` and ``f(u, t, params, st) -> (du, st)``). Keywords of the
    stored adjoint (``persistent_fn``, ``sweep_fn``, ...) are ignored: the
    reference's continuous adjoints pass no persistent solve."""
    t0, t_end = float(tspan[0]), float(tspan[1])
    saveat_arr = (
        device_scalar(t_end, u0).reshape(1) if saveat is None
        else torch.atleast_1d(device_scalar(saveat, u0))
    )
    spec = ContinuousSpec(mode, f, t0, t_end, saveat_arr, rtol=rtol,
                          atol=atol, max_steps=max_steps, step_fn=step_fn,
                          reservoir=reservoir, stateful=stateful,
                          f_state=f_state)
    ys, y_final = _ContinuousSolve.apply(spec, u0, *params)
    sol = spec.sol
    return ODESolution(
        ts=saveat_arr, ys=ys, t_final=sol.t_final, y_final=y_final,
        nfe=sol.nfe, naccept=sol.naccept, nreject=sol.nreject,
        success=sol.success, f_state=sol.f_state,
        reservoir_t=sol.reservoir_t, reservoir_u=sol.reservoir_u,
    )
