"""Adaptive Tsit5 integration: the eager accept/reject loop.

Counterpart of ``localregneuralde_tpu/ode/solve.py`` for ``adjoint='none'``
(inference): the while-loop with early exit, PI control, the Hairer initial
dt, dense output onto ``saveat``, the ``max_steps`` cap and NFE statistics
(2 initial evaluations + 6 per attempted step). One dt and one RMS error
norm are shared by the whole batch.

The loop runs on the host and reads the accept decision once per attempt.
It is the plain version that the persistent CUDA solve
(``ops/cuda/fused_solve.py``) is held against, and the path taken when that
kernel is not used. The gradient paths (``direct``, ``stored``) are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..ops.residuals import scaled_error_norm
from .controller import PIController, initial_step_size
from .step import tsit5_step
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


def device_scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 on ``like``'s device. A Python number is filled in
    on the device: a copy from pageable host memory would wait for the
    device's queued work."""
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=torch.float32, device=like.device)
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def adaptive_loop(fn: Callable, u0, k1_0, f_st0, t0, t_end, dt_init, *,
                  saveat, rtol, atol, max_steps,
                  step_fn: Optional[Callable] = None):
    """The accept/reject loop from ``(u0, k1_0)`` at ``t0`` with first step
    ``dt_init``; ``fn(u, t, st) -> (du, st)``. Returns a dict with ``ys``,
    ``y_final``, ``t_final``, ``naccept``, ``nreject``, ``natt``,
    ``success`` and ``f_state``."""
    controller = PIController()
    t = device_scalar(t0, u0)
    t_end = device_scalar(t_end, u0)
    saveat = device_scalar(saveat, u0)
    dt = dt_init
    qold = device_scalar(controller.qoldinit, u0)
    u, k1, f_st = u0, k1_0, f_st0
    ys = u0.unsqueeze(0).repeat((saveat.shape[0],) + (1,) * u0.ndim)
    done = bool(t >= t_end)
    naccept = nreject = 0
    while not done and naccept + nreject < max_steps:
        t_rem = t_end - t
        dt_c = torch.minimum(dt, t_rem)
        is_last = bool(dt >= t_rem)
        if step_fn is None:
            res = tsit5_step(fn, u, t, dt_c, k1, f_st)
        else:
            res = step_fn(fn, u, t, dt_c, k1, f_st)
        eest = scaled_error_norm(res.utilde, u, res.u_new, atol, rtol).detach()
        dt_acc, dt_rej, qold_acc = controller.propose(eest, dt_c, qold)
        if not bool(eest <= 1.0):
            nreject += 1
            dt = dt_rej
            continue
        t_new = t_end if is_last else t + dt_c
        hit = (saveat > t) & (saveat <= t_new)
        if bool(hit.any()):
            theta = torch.clamp((saveat - t) / dt_c, 0.0, 1.0)
            y_interp = tsit5_interpolate(u, dt_c, res.ks, theta)
            ys = torch.where(hit.reshape((-1,) + (1,) * u.ndim), y_interp, ys)
        naccept += 1
        u, k1, f_st = res.u_new, res.ks[6], res.f_state
        t, dt, qold = t_new, dt_acc, qold_acc
        done = is_last
    as_int = lambda n: torch.tensor(n, dtype=torch.int32, device=u0.device)  # noqa: E731
    return dict(
        ys=ys, y_final=u, t_final=t, naccept=as_int(naccept),
        nreject=as_int(nreject), natt=as_int(naccept + nreject),
        success=torch.tensor(done, device=u0.device), f_state=f_st,
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
) -> ODESolution:
    """Integrate ``du/dt = f(u, t)`` over ``tspan`` with adaptive Tsit5.

    Args:
      f: dynamics ``f(u, t) -> du`` or, with ``stateful=True``,
        ``f(u, t, st) -> (du, st)``.
      saveat: 1-D output times in ``[t0, t_end]`` (need not be sorted);
        defaults to ``[t_end]``. Times ≤ t0 return ``u0``.
      max_steps: bound on attempted steps (reference ``maxiters``).
      adjoint: only ``'none'`` (inference) is ported.
      step_fn: replacement for the generic Tsit5 step with the same contract,
        ``step_fn(fn, u, t, dt, k1, f_state) -> Tsit5StepResult`` (the fused
        CUDA step, ``ops/cuda/fused_mlp.py``).
      persistent_fn: whole-solve replacement (the persistent CUDA solve,
        ``ops/cuda/fused_solve.py``); may return None to decline, and the
        loop runs instead.
    """
    if adjoint != "none":
        raise NotImplementedError(
            f"adjoint={adjoint!r} is not ported yet: only inference "
            "(adjoint='none') is; the gradient paths are ROADMAP Queue 1 "
            "items 5 and 11"
        )
    fn = f if stateful else (lambda u, t, st: (f(u, t), st))
    t0, t_end = float(tspan[0]), float(tspan[1])
    saveat_arr = (
        device_scalar(t_end, u0).reshape(1) if saveat is None
        else torch.atleast_1d(device_scalar(saveat, u0))
    )
    if persistent_fn is not None:
        sol = persistent_fn(
            u0, (t0, t_end), saveat_arr=saveat_arr, rtol=rtol, atol=atol,
            max_steps=max_steps, f_state=f_state,
        )
        if sol is not None:
            return sol

    k1_0, f_st0 = fn(u0, t0, f_state)
    dt_init, nfe_dt = initial_step_size(
        lambda u, t: fn(u, t, f_state)[0], u0, device_scalar(t0, u0), order=5,
        rtol=rtol, atol=atol, f0=k1_0,
    )
    dt_init = torch.minimum(dt_init, device_scalar(t_end - t0, u0)).detach()
    nfe0 = 1 + nfe_dt
    out = adaptive_loop(
        fn, u0, k1_0, f_st0, t0, t_end, dt_init, saveat=saveat_arr,
        rtol=rtol, atol=atol, max_steps=max_steps, step_fn=step_fn,
    )
    return ODESolution(
        ts=saveat_arr, ys=out["ys"], t_final=out["t_final"],
        y_final=out["y_final"], nfe=nfe0 + 6 * out["natt"],
        naccept=out["naccept"], nreject=out["nreject"],
        success=out["success"], f_state=out["f_state"],
    )
