"""NeuralODE — the locally regularised neural ODE layer.

Counterpart of ``localregneuralde_tpu/models/neural_ode.py`` (reference
``src/layers/neural_ode.jl``). The layer returns the state
``{"model", "nfe", "reg_val", "rng", "success"}`` under the reference's
keys; ``rng`` is a ``torch.Generator`` where the reference keeps a JAX key.

- Eval mode solves with adjoint ``'none'`` and no regulariser.
- Training solves with the stored adjoint (``ode/stored_adjoint.py``).
  With ``regularize='unbiased'`` it draws t1 ~ U(t0, t2) from ``rng``,
  appends t1 to the saveat grid (and strips it from the outputs), and takes
  one more Tsit5 step from ``(u(t1), t1)`` with a fresh Hairer dt. Its
  error (or stiffness) estimate is ``reg_val``; u(t1), t1, the step's k1
  and dt are all detached, so the regulariser's gradient reaches the
  parameters only, never the layer input. NFE is the solve's + 8 (six
  stages, k1 and the dt probe). With ``regularize='biased'`` the point
  ``(t1, u(t1))`` is instead a reservoir sample of the accepted steps'
  starting points (so never t_end), kept by the solve from ``max_steps``
  uniforms drawn in advance from ``rng``.

Kernel dispatch (``use_pallas``, the reference's config name): when the
dynamics is a kernel family, ``'on'`` routes the solve through its wrappers
(``ops/cuda``) and ``'auto'`` does so for CUDA inputs; ``'off'`` runs the
dynamics module in the eager loop. The families are the TD-MLP (a
``TDChain`` of two Dense layers), the autonomous Dense chain of the
latent ODE (``Chain([Lambda(tanh)], Dense...)``, ``match_dense_chain``) and
the CIFAR conv dynamics (``TDChain`` of Conv+BatchNorm twice and a Conv,
``match_conv_family``).
With ``use_persistent`` the whole solve is one launch of the persistent
kernel; without it the loop calls the fused Tsit5 step kernel per attempt
(TD-MLP) or the generic step of the plain chain. The wrappers run their
plain versions on CPU tensors.

The chain family, as in the reference (``neural_ode.py:196-201,
271-272``), has kernels for the whole solve (kernel 5) and the whole sweep
(kernel 9) only: k1, the dt probe, the FSAL closure and the regulariser's
step are plain autograd through ``chain_eval``.

The conv family, as in the reference (``neural_ode.py:273-325, 349-353``),
has a step kernel (13) and its VJP (14) and no persistent solve or sweep:
every attempt of the eager loop, eval and training, and the regulariser's
step run kernel 13, the sweep runs kernel 14 once per accepted step, and
k1, the dt probe and the FSAL closure are the plain module (cuDNN, FP32).

Dynamics state (the conv family's BatchNorm running stats) is threaded
through the solve's accepted steps, in training through the stored
adjoint as a fenced output, and then through the regulariser's step; in
training the dynamics runs in training mode (batch statistics).

In training the kernel route runs the forward as one launch of the
persistent solve with knot recording, the backward as one launch of the
sweep kernel (dense, or two-level beyond ``knot_window``), and the
regulariser step through the step kernel with the step-VJP kernel as its
backward (``ops/cuda/fused_mlp_bwd.py``). Without ``use_persistent`` the
loop calls the step kernel per attempt and the sweep the step-VJP kernel
per accepted step. ``grad_precision='default'`` is accepted for the
reference's configs; every tier computes in FP32 here.
"""
from __future__ import annotations

from typing import Optional, Union

import dataclasses

import torch

from ..nn.basic import Dense, resolve_solver_precision
from ..nn.module import Module
from ..ode.controller import initial_step_size
from ..ode.solve import ODESolution, device_scalar, host_to_device, odesolve
from ..ode.step import Tsit5StepResult, regularization_value, tsit5_step
from ..core.containers import ArrayAndTime, get_array
from ..ops.cuda.fused_conv import (
    ConvWeights, match_conv_family, running_stats, with_running_stats,
)
from .common import TDChain

_VALID_REGULARIZE = ("none", "unbiased", "biased")
_VALID_REG_TYPE = ("error_estimate", "stiffness_estimate")
_VALID_USE_PALLAS = ("auto", "on", "off")


def sample_t1(generator: torch.Generator, t0: float, t2: float) -> float:
    """The unbiased regulariser's time, t1 ~ U(t0, t2), from the layer's
    CPU generator (so drawing it never waits for the device)."""
    return t0 + (t2 - t0) * float(torch.rand((), generator=generator))


def sample_reservoir_uniforms(generator: torch.Generator, n: int):
    """The biased regulariser's uniforms, one per attempt of the solve,
    from the layer's CPU generator."""
    return torch.rand(n, generator=generator)


def is_tdmlp(model) -> bool:
    """True for ``TDChain(Dense, Dense)``: the fused TD-MLP kernel family."""
    layers = list(getattr(model, "layers", {}).values())
    return (
        isinstance(model, TDChain) and len(layers) == 2
        and all(isinstance(l, Dense) and l.use_bias for l in layers)
    )


class NeuralODE(Module):
    def __init__(
        self,
        model: Module,
        *,
        tspan=(0.0, 1.0),
        regularize: Union[bool, str] = True,
        regularize_type: str = "error_estimate",
        rtol: float = 1e-3,
        atol: float = 1e-6,
        max_steps: int = 256,
        checkpoint_every: int = 16,
        saveat=None,
        adjoint: str = "stored",
        solver: str = "tsit5",
        use_pallas: Union[bool, str] = "auto",
        use_persistent: bool = True,
        precision: str = "auto",
        grad_precision: str = "match",
        compute_dtype: Optional[str] = None,
        knot_window: Optional[int] = None,
        rng_seed: int = 0,
    ):
        super().__init__()
        if isinstance(regularize, bool):
            regularize = "unbiased" if regularize else "none"
        if regularize not in _VALID_REGULARIZE:
            raise ValueError(f"regularize must be one of {_VALID_REGULARIZE}")
        if regularize_type not in _VALID_REG_TYPE:
            raise ValueError(f"regularize_type must be one of {_VALID_REG_TYPE}")
        if solver != "tsit5":
            raise NotImplementedError(
                f"solver {solver!r} is not ported yet (ROADMAP Queue 1 item "
                "11); only tsit5 is"
            )
        if compute_dtype not in (None, "float32"):
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r} is not ported yet"
            )
        if grad_precision not in ("match", "default"):
            raise ValueError(
                f"grad_precision must be 'match' or 'default', got "
                f"{grad_precision!r}"
            )
        if isinstance(use_pallas, bool):
            use_pallas = "on" if use_pallas else "off"
        if use_pallas not in _VALID_USE_PALLAS:
            raise ValueError(f"use_pallas must be one of {_VALID_USE_PALLAS}")
        from ..ops.cuda.fused_solve import match_dense_chain

        self.chain = None if is_tdmlp(model) else match_dense_chain(model)
        self.conv = None
        if not is_tdmlp(model) and self.chain is None:
            self.conv = match_conv_family(model)
        self.family = ("tdmlp" if is_tdmlp(model)
                       else "chain" if self.chain is not None
                       else "conv" if self.conv is not None else None)
        if use_pallas == "on" and self.family is None:
            raise ValueError(
                "use_pallas='on' requires a TDChain of two Dense layers (the "
                "fused TD-MLP family), an autonomous Dense chain (the "
                "latent ODE's generative dynamics, ops/cuda/fused_solve.py::"
                "match_dense_chain) or the CIFAR conv dynamics "
                "(ops/cuda/fused_conv.py::match_conv_family); the score "
                "samplers' families are not ported yet"
            )
        self.model = model
        self.tspan = (float(tspan[0]), float(tspan[1]))
        self.regularize = regularize
        self.regularize_type = regularize_type
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.max_steps = int(max_steps)
        self.checkpoint_every = int(checkpoint_every)
        self.saveat = None if saveat is None else torch.as_tensor(
            saveat, dtype=torch.float32
        )
        self.adjoint = adjoint
        self.solver = solver
        self.use_pallas = use_pallas if self.family is not None else "off"
        self.use_persistent = bool(use_persistent)
        self.knot_window = None if knot_window is None else int(knot_window)
        self.rng_seed = int(rng_seed)
        # recorded for parity with the reference; every tier is FP32 here
        self.mm_precision = resolve_solver_precision(precision, self.rtol)

    def init_state(self) -> dict:
        return {
            "model": self.model.init_state(),
            "nfe": torch.tensor(-1, dtype=torch.int32),
            "reg_val": torch.tensor(0.0),
            "rng": torch.Generator().manual_seed(self.rng_seed),
            "success": torch.tensor(True),
        }

    def uses_kernels(self, x: torch.Tensor) -> bool:
        """Whether a solve from ``x`` goes through the kernel family."""
        if self.use_pallas == "on":
            return True
        return self.use_pallas == "auto" and x.is_cuda

    def tdmlp_weights(self):
        from ..ops.cuda import TDMLPWeights

        l0, l1 = self.model.layers.values()
        return TDMLPWeights(l0.w, l0.b, l1.w, l1.b)

    def _generic_dynamics(self, training: bool = False):
        def f(u, t, st):
            y, st_new = self.model(ArrayAndTime(u, t), st, training=training)
            return get_array(y), st_new

        return f

    def conv_weights(self) -> ConvWeights:
        return ConvWeights(*self.model.parameters())

    def chain_params(self):
        """The chain family's parameters, ``[W_0, b_0, W_1, ...]``."""
        return [p for _, p in self.model.named_parameters()]

    def _kernel_solvers(self):
        """(dynamics, step_fn, persistent_fn) of the kernel family."""
        if self.family == "chain":
            return self._chain_solvers()
        if self.family == "conv":
            return self._conv_solvers()
        from ..ops.cuda import (
            fused_tdmlp, fused_tsit5_step, persistent_tsit5_solve,
            solve_feasible,
        )

        w = self.tdmlp_weights()

        def f(u, t, st):
            return fused_tdmlp(w, u, t), st

        def step(fn, u, t, dt, k1, f_st):
            u_new, utilde, *ks, g6 = fused_tsit5_step(w, u, t, dt, k1)
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, f_st)

        def persistent(u0, tspan, *, saveat_arr, rtol, atol, max_steps,
                       f_state, **record):
            if (u0.ndim != 2 or u0.dtype != torch.float32
                    or not solve_feasible(*u0.shape, w.b1.shape[0])):
                return None  # decline: the loop with the step kernel runs
            out = persistent_tsit5_solve(
                w, u0.contiguous(), tspan, rtol=rtol, atol=atol,
                saveat_arr=saveat_arr, max_steps=max_steps, **record,
            )
            # the fused family is stateless: its state passes through
            return _solution(out, f_state)

        return f, step, (persistent if self.use_persistent else None)

    def _chain_solvers(self):
        """(dynamics, step_fn, persistent_fn) of the chain family: the plain
        chain for the loop, kernel 5 for the whole solve."""
        from ..ops.cuda import chain_eval, persistent_chain_solve

        params, chain = self.chain_params(), self.chain

        def f(u, t, st):
            return chain_eval(params, chain, u), st

        def persistent(u0, tspan, *, saveat_arr, rtol, atol, max_steps,
                       f_state, **record):
            if u0.ndim != 2 or u0.dtype != torch.float32:
                return None  # decline: the eager loop runs
            out = persistent_chain_solve(
                params, chain, u0.contiguous(), tspan, rtol=rtol, atol=atol,
                saveat_arr=saveat_arr, max_steps=max_steps, **record,
            )
            return _solution(out, f_state)

        return f, None, (persistent if self.use_persistent else None)

    def _conv_solvers(self):
        """(dynamics, step_fn, None) of the conv family in eval mode: the
        plain module for k1 and the dt probe, kernel 13 for every attempt
        (running stats, or batch statistics under ``eval_stats='batch'``);
        the state passes through unchanged."""
        from ..ops.cuda import fused_conv_step

        w, spec = self.conv_weights(), self.conv

        def step(fn, u, t, dt, k1, f_st):
            u_new, utilde, *ks, g6, _ = fused_conv_step(
                w, spec, u.contiguous(), t, dt, k1.contiguous(),
                training=False, rstats=running_stats(spec, f_st))
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, f_st)

        return self._generic_dynamics(), step, None

    def _train_dynamics(self, names):
        """The dynamics module in training mode as the stored adjoint's
        stateful ``f(u, t, params, st) -> (du, st)``."""
        model = self.model

        def f(u, t, params, st):
            y, st_new = torch.func.functional_call(
                model, dict(zip(names, params)), (ArrayAndTime(u, t), st),
                {"training": True},
            )
            return get_array(y), st_new

        return f

    def _conv_stored_kwargs(self, names):
        """``stored_odesolve``'s callables for the conv family: the plain
        module (training mode) for k1, the dt probe and the FSAL closure,
        kernel 13 for every attempt with the running stats threaded, kernel
        14 for the transpose of every accepted step."""
        from ..ops.cuda import fused_conv_step, fused_conv_step_bwd

        spec = self.conv

        def step_fn(params, u, t, dt, k1, st):
            u_new, utilde, *ks, g6, stats = fused_conv_step(
                ConvWeights(*params), spec, u.contiguous(), t, dt,
                k1.contiguous(), training=True,
                rstats=running_stats(spec, st))
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6,
                                   with_running_stats(spec, st, stats))

        def step_vjp(params, u, t, dt, k1, d_unew, d_ks):
            zero = torch.zeros_like(u)
            d_w, d_u, d_k1 = fused_conv_step_bwd(
                ConvWeights(*params), spec, u.contiguous(), t, dt,
                k1.contiguous(),
                [c.contiguous() for c in (d_unew, zero, *d_ks, zero)])
            return list(d_w), d_u, d_k1

        return dict(f=self._train_dynamics(names), step_fn=step_fn,
                    step_vjp=step_vjp, stateful=True)

    def _chain_stored_kwargs(self):
        """``stored_odesolve``'s callables for the chain family: the plain
        chain for f (and so for the FSAL closure and any eager step), kernel
        5 for the recorded forward and kernel 9 for the sweep. The forward
        declines where the sweep cannot run, so an eager forward is swept
        by the eager sweep."""
        from ..ops.cuda import (
            chain_eval, chain_sweep_feasible, persistent_chain_solve,
            persistent_chain_sweep,
        )

        chain = self.chain

        def f(u, t, params):
            return chain_eval(params, chain, u)

        def persistent_fn(u0, params, tspan, *, saveat_arr, **kw):
            if not chain_sweep_feasible(chain, saveat_arr.shape[0], u0.device):
                return None
            out = persistent_chain_solve(list(params), chain, u0.contiguous(),
                                         tspan, saveat_arr=saveat_arr, **kw)
            return _solution(out, None)

        def sweep_fn(params, knot_ts, knot_us, naccept, saveat_arr, ct_ys,
                     ct_y, two_level_ctx=None):
            return persistent_chain_sweep(
                list(params), chain, knot_ts, knot_us, naccept, saveat_arr,
                ct_ys, ct_y, two_level_ctx=two_level_ctx)

        kw = dict(f=f)
        if self.use_persistent:
            kw.update(persistent_fn=persistent_fn, sweep_fn=sweep_fn)
        return kw

    def _stored_kwargs(self, kernels: bool, names, x, n_save: int):
        """The dynamics and replacements ``stored_odesolve`` takes, for the
        kernel route or the generic one, for a solve from ``x`` with
        ``n_save`` saveat times; every callable gets the parameters
        explicitly, since the backward runs after the caller returns."""
        if not kernels:
            return dict(f=self._train_dynamics(names), stateful=True)
        if self.family == "chain":
            return self._chain_stored_kwargs()
        if self.family == "conv":
            return self._conv_stored_kwargs(names)
        from ..ops.cuda import (
            TDMLPWeights, fused_tdmlp, fused_tsit5_step,
            persistent_stored_sweep, persistent_tsit5_solve,
            persistent_two_level_sweep, sweep_feasible, tdmlp_plain,
        )

        B, F = x.shape
        H = self.tdmlp_weights().b1.shape[0]
        step_bwd = tdmlp_step_vjp(F, H)

        def f(u, t, params):
            return fused_tdmlp(TDMLPWeights(*params), u, t)

        def fsal_fn(u, t, params):
            # the closure of the FSAL chain is plain autograd, as the
            # reference leaves it to XLA
            return tdmlp_plain(TDMLPWeights(*params), u, t)

        def step_fn(params, u, t, dt, k1):
            u_new, utilde, *ks, g6 = fused_tsit5_step(
                TDMLPWeights(*params), u, t, dt, k1)
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, None)

        def step_vjp(params, u, t, dt, k1, d_unew, d_ks):
            zero = torch.zeros_like(u)
            d_w, d_u, d_k1 = step_bwd(
                TDMLPWeights(*params), u, t, dt, k1,
                (d_unew, zero, *d_ks, zero),
            )
            return list(d_w), d_u, d_k1

        def persistent_fn(u0, params, tspan, **kw):
            out = persistent_tsit5_solve(TDMLPWeights(*params),
                                         u0.contiguous(), tspan, **kw)
            return _solution(out, None)

        def sweep_fn(params, knot_ts, knot_us, naccept, saveat_arr, ct_ys,
                     ct_y, two_level_ctx=None):
            w = TDMLPWeights(*params)
            if two_level_ctx is None:
                a_u, a_k, d_w = persistent_stored_sweep(
                    w, knot_ts, knot_us, naccept, saveat_arr, ct_ys, ct_y)
            else:
                c = two_level_ctx
                a_u, a_k, d_w = persistent_two_level_sweep(
                    w, knot_ts, knot_us, naccept, saveat_arr, ct_ys, ct_y,
                    c["ckpt_ts"], c["ckpt_us"], c["ckpt_ks"], c["ckpt_dts"],
                    c["ckpt_qolds"], t_end=c["t_end"], rtol=c["rtol"],
                    atol=c["atol"], max_steps=c["max_steps"],
                    stride=c["stride"], dense_cap=c["dense_cap"],
                )
            return a_u, a_k, list(d_w)

        kw = dict(f=f, fsal_fn=fsal_fn, step_fn=step_fn, step_vjp=step_vjp)
        # a planned decline, as the reference's: where kernel 4 or the sweep
        # cannot take the width, neither runs, so the plain loop records
        # unpadded knots for the plain sweep
        if self.use_persistent and sweep_feasible(B, F, H, n_save):
            kw.update(persistent_fn=persistent_fn, sweep_fn=sweep_fn)
        return kw

    def _eval_solve(self, x, state):
        if self.uses_kernels(x):
            f, step_fn, persistent_fn = self._kernel_solvers()
        else:
            f, step_fn, persistent_fn = self._generic_dynamics(), None, None
        saveat = None if self.saveat is None else self.saveat.to(x.device)
        sol = odesolve(
            f, x, self.tspan, rtol=self.rtol, atol=self.atol, saveat=saveat,
            max_steps=self.max_steps, adjoint="none", stateful=True,
            f_state=state["model"], step_fn=step_fn,
            persistent_fn=persistent_fn,
        )
        new_state = dict(state)
        new_state.update(model=sol.f_state, nfe=sol.nfe,
                         reg_val=torch.zeros((), device=x.device),
                         success=sol.success)
        return sol, new_state

    def apply_layer(self, x, state, *, training: bool = False):
        if not training:
            return self._eval_solve(x, state)
        if self.adjoint != "stored":
            raise NotImplementedError(
                f"training with adjoint={self.adjoint!r} is not ported yet: "
                "only the stored adjoint is (ROADMAP Queue 1 item 11)"
            )
        t0, t2 = self.tspan
        kernels = self.uses_kernels(x)
        names, params = zip(*self.model.named_parameters())
        user_saveat = (
            self.saveat.to(x.device) if self.saveat is not None
            else device_scalar(t2, x).reshape(1)
        )
        unbiased = self.regularize == "unbiased"
        saveat, reservoir = user_saveat, None
        if unbiased:
            t1 = sample_t1(state["rng"], t0, t2)
            saveat = torch.cat([user_saveat, device_scalar(t1, x).reshape(1)])
        elif self.regularize == "biased":
            reservoir = host_to_device(
                sample_reservoir_uniforms(state["rng"], self.max_steps), x)
        kw = self._stored_kwargs(kernels, names, x, saveat.shape[0])
        sol = odesolve(
            kw.pop("f"), x, self.tspan, rtol=self.rtol, atol=self.atol,
            saveat=saveat, max_steps=self.max_steps, adjoint="stored",
            params=list(params), knot_window=self.knot_window,
            reservoir=reservoir, f_state=state["model"], **kw,
        )
        # the stateless kernel families return no state: theirs passes
        model_state = state["model"] if sol.f_state is None else sol.f_state
        new_state = dict(state)
        new_state.update(model=model_state, nfe=sol.nfe,
                         reg_val=torch.zeros((), device=x.device),
                         success=sol.success)
        if self.regularize == "none":
            return sol, new_state
        if unbiased:
            u1, t1 = sol.ys[-1].detach(), device_scalar(t1, x)
            sol = dataclasses.replace(sol, ys=sol.ys[:-1], ts=user_saveat)
        else:
            u1, t1 = sol.reservoir_u.detach(), sol.reservoir_t.detach()
        # the chain family has no step kernel: its regulariser step is the
        # generic one, as in the reference
        step, dt_r = self._reg_step(
            x, u1, t1, model_state,
            self.family if kernels and self.family != "chain" else None)
        new_state.update(
            model=step.f_state,
            reg_val=regularization_value(self.regularize_type, step, u1,
                                         dt_r, self.atol, self.rtol),
            nfe=sol.nfe + 8,  # 6 stages + k1 + the dt probe
        )
        return sol, new_state

    def _reg_step(self, x, u1, t1, st, family):
        """The regulariser's step from the fenced ``(u1, t1)`` and the
        dynamics state ``st`` after the solve: k1 and dt under no_grad, then
        one differentiable Tsit5 step in training mode (the step kernel with
        its VJP kernel on the kernel route of the TD-MLP and conv families,
        the generic step otherwise). Returns (step, dt); ``step.f_state`` is
        the state after the step."""
        t2 = self.tspan[1]
        if family == "tdmlp":
            from ..ops.cuda import differentiable_step, fused_tdmlp

            w = self.tdmlp_weights()

            def f(u, t):
                return fused_tdmlp(w, u, t)
        else:
            dyn = self._generic_dynamics(training=True)

            def f(u, t):
                return dyn(u, t, st)[0]
        with torch.no_grad():
            k1 = f(u1, t1)
            dt_r, _ = initial_step_size(f, u1, t1, order=5, rtol=self.rtol,
                                        atol=self.atol, f0=k1)
            dt_r = torch.minimum(dt_r, device_scalar(t2, x) - t1)
        if family == "tdmlp":
            u_new, utilde, *ks, g6 = differentiable_step(
                w, u1.contiguous(), t1, dt_r, k1,
                tdmlp_step_vjp(w.b2.shape[0], w.b1.shape[0]))
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, st), dt_r
        if family == "conv":
            from ..ops.cuda import differentiable_conv_step

            spec = self.conv
            u_new, utilde, *ks, g6, stats = differentiable_conv_step(
                self.conv_weights(), spec, u1.contiguous(), t1, dt_r,
                k1.contiguous(), running_stats(spec, st))
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6,
                                   with_running_stats(spec, st, stats)), dt_r
        return tsit5_step(dyn, u1, t1, dt_r, k1, st), dt_r


def tdmlp_step_vjp(F: int, H: int):
    """The TD-MLP step's VJP at (F, H): kernel 3 where its transposed step
    fits a CTA, else its plain twin. The reference's VJP kernel takes any
    width (its tile shrinks); kernel 3 has no plan for a wide one yet
    (README, documented deviations)."""
    from ..ops.cuda import (
        fused_step_bwd, fused_step_bwd_plain, step_bwd_feasible,
    )

    return fused_step_bwd if step_bwd_feasible(F, H) else fused_step_bwd_plain


def _solution(out, f_state) -> ODESolution:
    """An ``ODESolution`` from the persistent solve's output dict."""
    return ODESolution(
        ts=out["ts"], ys=out["ys"], t_final=out["t_final"],
        y_final=out["y_final"], nfe=out["nfe"], naccept=out["naccept"],
        nreject=out["nreject"], success=out["success"], f_state=f_state,
        **{k: out[k] for k in out
           if k.startswith(("knot_", "ckpt_", "reservoir_"))},
    )
