"""Score-SDE samplers with adaptive steps: the reverse-time VP-SDE and its
probability-flow ODE.

Counterpart of ``localregneuralde_tpu/models/score_sde.py`` (the baseline's
"Score-SDE diffusion sampler with locally regularized adaptive steps"). The
VP-SDE with β(t) = β_min + t·(β_max − β_min):

    forward:  du = −½β(t)·u dt + √β(t) dW
    reverse:  du = [−½β(t)·u − β(t)·s_θ(u, t)] dt + √β(t) dW̄   (t: t1 → t0)

Both samplers integrate on the clock τ = t1 − t, τ ∈ [0, t1 − t0]:
``sample_vpsde`` the reverse SDE with the adaptive SDE loop
(``sde/solve.py``: SRI/SOSRI, commutative Milstein or Lamba–Euler–Heun), ``sample_probability_flow`` du/dt = −½β(t)·(u + s_θ)
with adaptive Tsit5 (``ode/solve.py``), both with ``adjoint='none'`` and
their NFE statistics.

The score is ``score_fn(u, t, p)`` or, with ``score_module``, a module's
own evaluation. A ``TDChain`` of biased Dense layers
(``ops/cuda/fused_sde_solve.py::match_td_score_chain``) runs the whole
solve in one launch of kernel 11 (SDE) or kernel 6 (probability flow) on a
CUDA device, and in their plain versions on the CPU; ``use_pallas=False``,
another module or a score function take the eager loop.

Draws: ``u_init`` comes from ``sample_u_init`` and the Brownian source
from ``noise_source``, in that order, both from the caller's CPU
``torch.Generator``; tests replace the two functions to inject the
reference's draws. Kernel 11 serves SRI/SOSRI only, as the reference's:
``'milstein'`` and ``'euler_heun'`` run the eager loop on any device.

Tiers: the reference calls its samplers' kernels with no precision and
evaluates the score module outside any precision scope, so on a card every
product takes the backend default, TF32; so do the port's. Both samplers
pass the reference's ``precision=None`` to kernels 11 and 6 (TF32 on a
card: ``lrnde_vpsde_solve_tf32``, ``lrnde_persistent_pf_tf32``; FP32 on
the CPU), and evaluate the score module (the eager loops of SRI, Milstein
and Euler–Heun, and the dt heuristic) inside
``product_tier_scope(product_tier(None, device))``. A TF32 forward below
rtol 1e-4 raises (``nn.basic.check_product_tier``; README, documented
deviations): the samplers' defaults (1e-2, 1e-4) are at or above it.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..core.containers import ArrayAndTime, get_array
from ..nn.basic import check_product_tier, product_tier, product_tier_scope
from ..ode.solve import ODESolution, odesolve
from ..sde.brownian import PhiloxNormals
from ..sde.solve import SRI_SOLVERS, sdesolve, solution_from
from .neural_sde import sample_noise_seed


class VPSDE:
    """Variance-preserving SDE with linear β(t) = β_min + t·(β_max − β_min).
    ``t`` is a float or a tensor."""

    def __init__(self, beta_min: float = 0.1, beta_max: float = 20.0):
        self.beta_min = float(beta_min)
        self.beta_max = float(beta_max)

    def beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def marginal_log_alpha(self, t):
        """log α(t) where u(t) ~ N(√α·u0, (1 − α)·I)."""
        return -0.5 * (
            self.beta_min * t + 0.5 * (self.beta_max - self.beta_min) * t ** 2
        )

    def marginal_std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * torch.as_tensor(
            self.marginal_log_alpha(t), dtype=torch.float32)))


def gaussian_score_fn(mean=0.0, var=1.0, sde: Optional[VPSDE] = None):
    """The exact score of data ~ N(mean, var) under the VP-SDE marginals,
    s(u, t) = −(u − √α·mean) / (α·var + 1 − α), for checking the samplers
    without a trained network."""
    sde = sde or VPSDE()

    def score(u, t, p):
        alpha = torch.exp(2.0 * torch.as_tensor(sde.marginal_log_alpha(t),
                                                dtype=torch.float32,
                                                device=u.device))
        m = torch.sqrt(alpha) * mean
        v = alpha * var + (1.0 - alpha)
        return -(u - m) / v

    return score


def module_score_fn(module, training: bool = False):
    """A ``score_fn`` from a module that takes ``ArrayAndTime`` (a
    ``TDChain``): its own parameters, and ``p`` its layer state (None: the
    module's initial state)."""

    def score(u, t, p):
        state = module.init_state() if p is None else p
        y, _ = module(ArrayAndTime(u, t), state, training=training)
        return get_array(y)

    return score


def _resolve_score_fn(score_fn, score_module):
    """Exactly one of ``score_fn`` and ``score_module``: with a module,
    every route (kernel and eager loop) evaluates that module, so a separate
    ``score_fn`` could silently disagree with the kernel."""
    if score_module is not None:
        if score_fn is not None:
            raise ValueError(
                "pass exactly one of score_fn / score_module: with "
                "score_module the eager loop uses the module too, so a "
                "separate score_fn could silently diverge from the kernel"
            )
        return module_score_fn(score_module)
    if score_fn is None:
        raise ValueError("pass score_fn or score_module")
    return score_fn


def sample_u_init(generator: torch.Generator, shape, device) -> torch.Tensor:
    """The sampler's starting noise u(t1) ~ N(0, I), drawn on the CPU from
    ``generator`` and copied to ``device`` once."""
    u = torch.randn(tuple(shape), generator=generator)
    return u.to(device) if torch.device(device).type != "cpu" else u


def noise_source(generator: torch.Generator, u: torch.Tensor):
    """The Brownian tree's normal source of a reverse-SDE solve from ``u``:
    a ``PhiloxNormals`` seeded from ``generator``, over ``u``'s rows and
    its other axes flattened (the kernel's own source for a (B, F) state)."""
    seed = sample_noise_seed(generator)
    if u.ndim == 2:
        return PhiloxNormals(seed, u.shape[0], u.shape[1], device=u.device)
    src = PhiloxNormals(seed, u.shape[0], math.prod(u.shape[1:]),
                        device=u.device)
    return lambda node: src(node).reshape((2,) + tuple(u.shape))


def _start(shape, generator, device, score_fn, score_module, rtol):
    from ..harness.construct import resolve_device

    device = resolve_device(device)
    if score_module is not None:
        # the module's products take the backend default: TF32 on a card
        check_product_tier(product_tier(None, device), rtol)
    if score_module is not None and next(score_module.parameters(),
                                         None) is not None:
        on = next(score_module.parameters()).device
        if on != device:
            raise ValueError(f"score_module on {on}, sampling on {device}")
    score = _resolve_score_fn(score_fn, score_module)
    return device, score, sample_u_init(generator, shape, device)


def _score_chain(score_module, use_pallas):
    """(params, spec) of a score module the kernels take, else None."""
    from ..ops.cuda.fused_sde_solve import (
        match_td_score_chain,
        score_chain_params,
    )

    if score_module is None or not use_pallas:
        return None
    chain = match_td_score_chain(score_module)
    if chain is None:
        return None
    return [p.detach() for p in score_chain_params(score_module, chain)], chain


@torch.no_grad()
def sample_vpsde(
    score_fn: Optional[Callable],
    shape,
    generator: torch.Generator,
    p=None,
    *,
    sde: Optional[VPSDE] = None,
    t0: float = 1e-3,
    t1: float = 1.0,
    rtol: float = 1e-2,
    atol: float = 1e-2,
    solver: str = "sri",
    max_steps: int = 256,
    score_module=None,
    use_pallas: bool = True,
    device=None,
):
    """Draw samples of ``shape`` by integrating the reverse-time VP-SDE
    adaptively from u(t1) ~ N(0, I) down to t0.

    In the τ = t1 − t clock the reverse SDE ``du = f̄ dt + g dW̄`` with
    dt < 0 reads ``du = −f̄(u, t1 − τ) dτ + g(t1 − τ) dW_τ``. ``p`` is passed
    to ``score_fn`` (with ``score_module``: the module's layer state).
    Returns ``(samples, solution)``; the solution carries the drift and
    diffusion NFE. With a ``score_module`` the kernels take and an SRI
    solver (``'sri'``, ``'sosri'``), the solve is one launch of kernel 11
    on a CUDA device (its plain version on the CPU); ``'milstein'`` and
    ``'euler_heun'`` take the eager loop. Runs on ``device``
    (default CUDA; without a GPU pass ``device='cpu'``).
    """
    sde = sde or VPSDE()
    device, score, u_init = _start(shape, generator, device, score_fn,
                                   score_module, rtol)
    noise = noise_source(generator, u_init)

    def drift(u, tau):
        # reverse drift f̄ = −½βu − βs; du/dτ = −f̄(u, t1 − τ)
        t = t1 - tau
        b = sde.beta(t)
        return -(-0.5 * b * u - b * score(u, t, p))

    def diffusion(u, tau):
        return torch.sqrt(sde.beta(t1 - tau)) * torch.ones_like(u)

    persistent_fn = None
    kernel = _score_chain(score_module, use_pallas) if solver in SRI_SOLVERS \
        else None
    if kernel is not None:
        from ..ops.cuda.fused_sde_solve import persistent_vpsde_solve

        def persistent_fn(u0, tspan, *, saveat_arr, record_knots, reservoir,
                          **kw):
            out = persistent_vpsde_solve(
                *kernel, u0, tspan, saveat_arr=saveat_arr,
                beta_min=sde.beta_min, beta_max=sde.beta_max, t1=t1,
                precision=None, **kw)
            return solution_from(out, saveat_arr)

    # the module's products at the backend default, as the reference's
    with product_tier_scope(product_tier(None, device)):
        sol = sdesolve(
            drift, diffusion, u_init, (0.0, t1 - t0), noise=noise,
            rtol=rtol, atol=atol, solver=solver, max_steps=max_steps,
            adjoint="none", persistent_fn=persistent_fn,
        )
    return sol.y_final, sol


@torch.no_grad()
def sample_probability_flow(
    score_fn: Optional[Callable],
    shape,
    generator: torch.Generator,
    p=None,
    *,
    sde: Optional[VPSDE] = None,
    t0: float = 1e-3,
    t1: float = 1.0,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    max_steps: int = 256,
    score_module=None,
    use_pallas: bool = True,
    device=None,
):
    """The deterministic probability-flow ODE sampler (adaptive Tsit5):
    du/dt = −½β(t)·(u + s_θ(u, t)) from u(t1) ~ N(0, I) down to t0.

    ``p`` as for ``sample_vpsde``. Returns ``(samples, solution)`` with the
    NFE. With a ``score_module`` the kernels take, the solve is one launch
    of kernel 6 on a CUDA device (its plain version on the CPU). Runs on
    ``device`` (default CUDA; without a GPU pass ``device='cpu'``).
    """
    sde = sde or VPSDE()
    device, score, u_init = _start(shape, generator, device, score_fn,
                                   score_module, rtol)

    def dynamics(u, tau):
        t = t1 - tau
        b = sde.beta(t)
        return -(-0.5 * b * (u + score(u, t, p)))

    persistent_fn = None
    kernel = _score_chain(score_module, use_pallas)
    if kernel is not None:
        from ..ops.cuda.fused_solve import persistent_pf_solve

        def persistent_fn(u0, tspan, *, saveat_arr, rtol, atol, max_steps,
                          f_state, **record):
            out = persistent_pf_solve(
                *kernel, u0, tspan, rtol=rtol, atol=atol,
                saveat_arr=saveat_arr, max_steps=max_steps,
                beta_min=sde.beta_min, beta_max=sde.beta_max, t1=t1,
                precision=None)
            return ODESolution(
                ts=saveat_arr, ys=out["ys"], t_final=out["t_final"],
                y_final=out["y_final"], nfe=out["nfe"],
                naccept=out["naccept"], nreject=out["nreject"],
                success=out["success"], f_state=f_state,
            )

    with product_tier_scope(product_tier(None, device)):
        sol = odesolve(
            dynamics, u_init, (0.0, t1 - t0), rtol=rtol, atol=atol,
            max_steps=max_steps, adjoint="none", persistent_fn=persistent_fn,
        )
    return sol.y_final, sol
