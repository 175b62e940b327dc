"""NeuralODE — the locally regularised neural ODE layer.

Counterpart of ``localregneuralde_tpu/models/neural_ode.py`` (reference
``src/layers/neural_ode.jl``). The layer returns the state
``{"model", "nfe", "reg_val", "rng", "success"}`` under the reference's
keys; ``rng`` is a ``torch.Generator`` where the reference keeps a JAX key.

- Eval mode solves with adjoint ``'none'`` and no regulariser.
- Training solves with the layer's ``adjoint``: ``'stored'``
  (``ode/stored_adjoint.py``), ``'direct'`` (autograd through the eager
  loop), ``'interpolating'`` or ``'backsolve'`` (``ode/interp_adjoint.py``,
  ``ode/adjoint.py``). ``solver='vcab3'`` or ``'vcabm3'`` runs the Adams
  solvers (``ode/multistep.py``) under ``'direct'`` (the stored and the
  continuous adjoints fall back to it, reference ``neural_ode.py:518-527``);
  the regulariser's step is Tsit5 whatever the solver.
  With ``regularize='unbiased'`` it draws t1 ~ U(t0, t2) from ``rng``
  (``draw``; a train step stages it ahead, ``models/draws.py``),
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
k1, the dt probe and the FSAL closure are the plain module (cuDNN on
operands rounded to the forward's tier).

The eval solve of each kernel family on one device is one registered
operator (``ops/cuda/serving.py``), live and under ``torch.export`` alike,
so that an exported model runs the live model's code path: the TD-MLP's
kernel 4 (``lrnde::tsit5_solve``), the chain's kernel 5
(``lrnde::chain_solve``) and the conv family's loop around kernel 13
(``lrnde::conv_solve``, its k1 and dt probe on the plain dynamics, the
module's computation op for op).

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
per accepted step.

Precision tiers (the TD-MLP, conv and chain families; reference
``neural_ode.py:104-147, 262-325, 408-469``): ``mm_precision`` is
``precision`` resolved at ``rtol`` ('auto': 'highest' below 1e-4, else
None, the backend default), ``bwd_precision`` is ``mm_precision`` under
``grad_precision='match'`` and None under ``'default'``.
``nn.basic.product_tier`` maps each to what a product computes on the
device: the default is TF32 on a card and FP32 on the CPU. The forward
(kernels 1, 2, 4, 5 and 13, the sweep's window replay, the plain module's
or chain's k1, dt probe and FSAL closure) runs at ``mm_precision``, the
sweeps' and the stored adjoint's step VJPs' recompute (kernels 3, 7, 8, 9
and 14) at ``bwd_precision`` (the regulariser's and the direct adjoint's
step VJPs at ``mm_precision``, as the reference's fused steps), and every
cotangent, data-gradient and weight-gradient product of kernels 3, 7, 8,
9 and 14 at the default tier, the reference's ``grad_precision=None``. The
plain route computes the dynamics' Dense and Conv products at
``mm_precision``'s tier, forward and backward
(``nn.basic.product_tier_scope``), and warns that
``grad_precision='default'`` does nothing there, as the reference does. A
forward at the TF32 tier below rtol 1e-4 raises (the reference saturates
``max_steps``). The SDE family's tiers are ``NeuralDSDE``'s; the score
samplers' are ``models/score_sde.py``'s.

The other modes route each family as the reference does
(``neural_ode.py:224-303``): on the TD-MLP's kernel route the dynamics is
kernel 1 through ``FusedTDMLP`` (its VJP the plain twin's, recomputed) and
the step is kernel 2 with kernel 3 as its VJP (``FusedTsit5Step``); the
conv family steps with kernel 13, kernel 14 its VJP; the chain family
takes generic steps. The continuous adjoints' forwards take the step
kernel and no persistent solve, and their reverse solves take VJPs of the
dynamics (kernel 1 forward on the TD-MLP route). ``compute_dtype=
'bfloat16'`` computes the dynamics in bfloat16 on the plain route only
(u and the parameters cast, du cast back to float32, the solver in
float32; reference ``neural_ode.py:146-171``): it refuses rtol < 1e-4,
``use_pallas='on'`` raises and ``'auto'`` declines to the plain route.
None of these modes is a persistent step (``persistent_step``), so a
K-step call of a model that uses them runs eagerly.

The global grid of data parallelism (``parallel/sharded_train.py``) gives
the layer a ``DPGroup`` under its state's ``"dp_group"`` key (``GROUP``):
the layer's input is then one rank's rows of a batch spread over the
group's ranks, and every norm of the solve and of the regulariser is over
all their rows (``ops/residuals.py``), so the ranks take one grid. The
persistent solves take no part in a collective. The TD-MLP's kernel route
runs the loop with the step kernel per attempt and the step-VJP kernel per
accepted step (kernels 2 and 3). The chain family's runs kernel 5 as GSPMD
runs a replicated custom call: on the whole batch, gathered from the
ranks, on every rank, each keeping its rows (``parallel.mesh.replicated``);
kernel 9 sweeps the rank's rows of the knots (``ode/stored_adjoint.py``).
The conv family's kernel route runs its whole solve so, kernel 13 with its
BatchNorm statistics on every attempt, the plain k1, dt probe and FSAL
closure, the sweep with kernel 14 on every accepted step
(``stored_odesolve(whole_batch=True)``; the direct adjoint differentiates
through the gather, ``mesh.gather_rows_grad``) and the regulariser's step:
their batch statistics are the whole batch's by construction, and the
dynamics' running stats the same on every rank. The eager routes give the
dynamics' BatchNorms the group in every evaluation, so their moments are
over all the rows (``nn.basic.BatchNorm``). The regulariser's step and its
dt probe take the group's norms. After each solve the ranks' accept and
reject counts are held equal. Every family takes the global grid under
the stored and the direct adjoint with Tsit5 (``check_global_grid``).
"""
from __future__ import annotations

from typing import Optional, Union

import dataclasses
import functools
import warnings

import torch

from ..nn.basic import (
    GROUP, Dense, check_product_tier, product_tier, product_tier_scope,
    resolve_solver_precision,
)
from ..nn.module import Module
from ..ode.controller import initial_step_size
from ..ode.multistep import adams_solve
from ..ode.solve import ODESolution, device_scalar, loop_solve, odesolve
from ..ode.step import Tsit5StepResult, regularization_value, tsit5_step
from ..core.containers import ArrayAndTime, get_array
from ..ops.cuda.fused_conv import (
    ConvWeights, match_conv_family, running_stats, with_running_stats,
)
from .common import TDChain
from .draws import layers_with, pop_draws, to_device, with_key

_VALID_REGULARIZE = ("none", "unbiased", "biased")
_VALID_REG_TYPE = ("error_estimate", "stiffness_estimate")
_VALID_USE_PALLAS = ("auto", "on", "off")
_VALID_SOLVERS = ("tsit5", "vcab3", "vcabm3")
_VALID_ADJOINTS = ("stored", "direct", "interpolating", "backsolve")


def pop_group(state: dict):
    """``(group, state without it)``; None when the state carries none."""
    if GROUP not in state:
        return None, state
    state = dict(state)
    return state.pop(GROUP), state


def sample_t1(generator: torch.Generator, t0: float, t2: float) -> float:
    """The unbiased regulariser's time, t1 ~ U(t0, t2), from the layer's
    CPU generator (so drawing it never waits for the device)."""
    return t0 + (t2 - t0) * float(torch.rand((), generator=generator))


def sample_reservoir_uniforms(generator: torch.Generator, n: int):
    """The biased regulariser's uniforms, one per attempt of the solve,
    from the layer's CPU generator."""
    return torch.rand(n, generator=generator)


def device_saveat(layer, device):
    """``layer.saveat`` on ``device``, copied there once (a step copies
    nothing from the host), or None."""
    if layer.saveat is None:
        return None
    cache = layer.__dict__.setdefault("_saveat_on", {})
    device = torch.device(device)
    src, on_device = cache.get(device, (None, None))
    if src is not layer.saveat:  # first use, or a new grid
        on_device = layer.saveat.to(device)
        cache[device] = (layer.saveat, on_device)
    return on_device


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
        if solver not in _VALID_SOLVERS:
            raise ValueError(
                "solver must be 'tsit5', 'vcab3' or 'vcabm3' (reference "
                "construct.jl:154-164)")
        if adjoint not in _VALID_ADJOINTS:
            raise ValueError(f"adjoint must be one of {_VALID_ADJOINTS}")
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32/bfloat16, got {compute_dtype!r}")
        if grad_precision not in ("match", "default"):
            raise ValueError(
                f"grad_precision must be 'match' or 'default', got "
                f"{grad_precision!r}"
            )
        if isinstance(use_pallas, bool):
            use_pallas = "on" if use_pallas else "off"
        if use_pallas not in _VALID_USE_PALLAS:
            raise ValueError(f"use_pallas must be one of {_VALID_USE_PALLAS}")
        self.compute_dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                              else None)
        if self.compute_dtype is not None:
            if resolve_solver_precision(precision, float(rtol)) is not None:
                raise ValueError(
                    "compute_dtype='bfloat16' is incompatible with tight-"
                    "tolerance precision='highest' (rtol < 1e-4): the bf16 "
                    "dynamics noise would swamp the error estimate")
            if use_pallas == "on":
                raise ValueError(
                    "compute_dtype='bfloat16' is not supported by the "
                    "kernels (float32 throughout)")
            use_pallas = "off"  # 'auto' declines to the plain route
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
        self.mm_precision = resolve_solver_precision(precision, self.rtol)
        self.bwd_precision = (self.mm_precision if grad_precision == "match"
                              else None)
        if (grad_precision == "default" and self.mm_precision is not None
                and self.use_pallas == "off"):
            warnings.warn(
                "solver.grad_precision='default' has no effect with "
                "use_pallas off: the plain backward runs at the forward's "
                f"matmul precision ({self.mm_precision!r}). Only the fused "
                "backward kernels honor the knob.", stacklevel=2)

    def init_state(self) -> dict:
        return {
            "model": self.model.init_state(),
            "nfe": torch.tensor(-1, dtype=torch.int32),
            "reg_val": torch.tensor(0.0),
            "rng": torch.Generator().manual_seed(self.rng_seed),
            "success": torch.tensor(True),
        }

    def draw(self, state, rows: int) -> dict:
        """A training call's draws from ``state["rng"]``, on the host: t1
        (unbiased) or the reservoir's ``max_steps`` uniforms (biased);
        nothing without the regulariser. ``rows`` is unused: no draw
        depends on the batch."""
        t0, t2 = self.tspan
        if self.regularize == "unbiased":
            return {"t1": torch.tensor(sample_t1(state["rng"], t0, t2),
                                       dtype=torch.float32)}
        if self.regularize == "biased":
            return {"reservoir": sample_reservoir_uniforms(state["rng"],
                                                           self.max_steps)}
        return {}

    def persistent_step(self, rows: int, device) -> bool:
        """Whether a training step of a batch of ``rows`` on ``device`` runs
        every solve and sweep of this layer as one persistent kernel launch
        each, with no host read: the TD-MLP's K4 with K8 or K7, the chain's
        K5 with K9. The conv family's adaptive loop (K13 per attempt,
        accepted on the host), the plain loop of a declined or generic
        route and the CPU are not."""
        device = torch.device(device)
        if (device.type != "cuda" or not self.use_persistent
                or self.family not in ("tdmlp", "chain")
                or self.use_pallas == "off" or self.solver != "tsit5"
                or self.adjoint != "stored"):
            return False
        n_save = (1 if self.saveat is None else self.saveat.shape[0]) + (
            self.regularize == "unbiased")
        if self.family == "chain":
            from ..ops.cuda import chain_sweep_feasible
            from ..ops.cuda.fused_solve_bwd import sweep_tiers

            return chain_sweep_feasible(
                self.chain, n_save, device,
                sweep_tiers(self.mm_precision, None, self.bwd_precision,
                            device))
        from ..ops.cuda import sweep_feasible

        w = self.tdmlp_weights()
        return sweep_feasible(rows, w.b2.shape[0], w.b1.shape[0], n_save)

    def check_global_grid(self) -> None:
        """Raise ``NotImplementedError`` where the global grid of data
        parallelism is not ported: the solver modes other than Tsit5 under
        the stored or direct adjoint."""
        if self.solver != "tsit5" or self.adjoint not in ("stored", "direct"):
            raise NotImplementedError(
                f"data_parallel='gspmd' with solver {self.solver!r} and "
                f"adjoint {self.adjoint!r} is not ported (ROADMAP Queue 1 "
                "item 14e): Tsit5 under the stored or direct adjoint is")

    def uses_kernels(self, x: torch.Tensor) -> bool:
        """Whether a solve from ``x`` goes through the kernel family."""
        if self.use_pallas == "on":
            return True
        return self.use_pallas == "auto" and x.is_cuda

    def tdmlp_weights(self):
        from ..ops.cuda import TDMLPWeights

        l0, l1 = self.model.layers.values()
        return TDMLPWeights(l0.w, l0.b, l1.w, l1.b)

    def forward_tier(self, device) -> str:
        """The tier of the dynamics' forward products on ``device``: the
        TD-MLP, conv and chain families' ``mm_precision``; FP32 for the
        other families."""
        if self.family not in ("tdmlp", "conv", "chain"):
            return "fp32"
        return product_tier(self.mm_precision, device)

    def _call_model(self, u, t, st, training: bool, params=None,
                    group=None):
        """The dynamics module at ``(u, t)`` with state ``st`` (with
        ``params``, a name → tensor dict, through ``functional_call``),
        its Dense products at ``forward_tier``; under ``compute_dtype`` u
        and the float32 parameters are cast to it and du back to u's
        dtype. With a ``group`` (the global grid's eager route) each
        BatchNorm of the dynamics gets it, for moments over every rank's
        rows; the state it returns carries none."""
        if group is not None:
            for path, _, _ in layers_with(self.model, st, "group_moments"):
                st = with_key(st, path, GROUP, group)
        with product_tier_scope(self.forward_tier(u.device)):
            return self._call_module(u, t, st, training, params)

    def _call_module(self, u, t, st, training: bool, params=None):
        cdt = self.compute_dtype
        u_in = u
        if cdt is not None:
            u_in = u.to(cdt)
            if params is None:
                params = dict(self.model.named_parameters())
            params = {k: v.to(cdt) if v.dtype == torch.float32 else v
                      for k, v in params.items()}
        if params is None:
            y, st_new = self.model(ArrayAndTime(u_in, t), st,
                                   training=training)
        else:
            y, st_new = torch.func.functional_call(
                self.model, params, (ArrayAndTime(u_in, t), st),
                {"training": training})
        du = get_array(y)
        return (du if cdt is None else du.to(u.dtype)), st_new

    def _generic_dynamics(self, training: bool = False, group=None):
        def f(u, t, st):
            return self._call_model(u, t, st, training, group=group)

        return f

    def conv_weights(self) -> ConvWeights:
        return ConvWeights(*self.model.parameters())

    def chain_params(self):
        """The chain family's parameters, ``[W_0, b_0, W_1, ...]``."""
        return [p for _, p in self.model.named_parameters()]

    def _kernel_solvers(self, group=None):
        """(dynamics, step_fn, persistent_fn) of the kernel family (for the
        global grid of ``group``: the TD-MLP's loop of kernel 2, the conv
        family's whole-batch solve)."""
        if self.family == "chain":
            return self._chain_solvers()
        if self.family == "conv":
            return self._conv_solvers(group)
        from ..ops.cuda import (
            fused_tdmlp, fused_tsit5_step, persistent_tsit5_solve,
            solve_feasible,
        )

        w = self.tdmlp_weights()
        prec = self.mm_precision

        def f(u, t, st):
            return fused_tdmlp(w, u, t, prec), st

        def step(fn, u, t, dt, k1, f_st):
            u_new, utilde, *ks, g6 = fused_tsit5_step(w, u, t, dt, k1, prec)
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, f_st)

        def persistent(u0, tspan, *, saveat_arr, rtol, atol, max_steps,
                       f_state, **record):
            if (u0.ndim != 2 or u0.dtype != torch.float32
                    or not solve_feasible(*u0.shape, w.b1.shape[0])):
                return None  # decline: the loop with the step kernel runs
            out = persistent_tsit5_solve(
                w, u0.contiguous(), tspan, rtol=rtol, atol=atol,
                saveat_arr=saveat_arr, max_steps=max_steps, precision=prec,
                **record,
            )
            # the fused family is stateless: its state passes through
            return _solution(out, f_state)

        return f, step, (persistent if self.use_persistent
                         and group is None else None)

    def _chain_solvers(self):
        """(dynamics, step_fn, persistent_fn) of the chain family: the plain
        chain for the loop, kernel 5 for the whole solve, both at
        ``mm_precision``."""
        from ..ops.cuda import chain_eval, persistent_chain_solve

        params, chain = self.chain_params(), self.chain
        prec = self.mm_precision

        def f(u, t, st):
            tier = self.forward_tier(u.device)
            return chain_eval(params, chain, u, tier), st

        def persistent(u0, tspan, *, saveat_arr, rtol, atol, max_steps,
                       f_state, **record):
            if u0.ndim != 2 or u0.dtype != torch.float32:
                return None  # decline: the eager loop runs
            out = persistent_chain_solve(
                params, chain, u0.contiguous(), tspan, rtol=rtol, atol=atol,
                saveat_arr=saveat_arr, max_steps=max_steps, precision=prec,
                **record,
            )
            return _solution(out, f_state)

        return f, None, (persistent if self.use_persistent else None)

    def _conv_solvers(self, group=None):
        """(dynamics, step_fn, whole) of the conv family in eval mode: the
        plain module for k1 and the dt probe, kernel 13 for every attempt
        (running stats, or batch statistics under ``eval_stats='batch'``),
        both at ``mm_precision``; the state passes through unchanged.
        ``whole`` is that loop as a whole solve: on one device the
        registered operator ``lrnde::conv_solve`` (``ops/cuda/serving.py``:
        the same loop on the plain dynamics, which is the module's
        computation op for op), which ``torch.export`` records; on the
        global grid (``group``) the loop itself, which ``odesolve`` runs on
        the whole batch on every rank."""
        from ..ops.cuda import fused_conv_step

        w, spec, prec = self.conv_weights(), self.conv, self.mm_precision
        f = self._generic_dynamics()

        def step(fn, u, t, dt, k1, f_st):
            u_new, utilde, *ks, g6, _ = fused_conv_step(
                w, spec, u.contiguous(), t, dt, k1.contiguous(),
                training=False, rstats=running_stats(spec, f_st),
                precision=prec)
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, f_st)

        def whole(u0, tspan, *, saveat_arr, rtol, atol, max_steps, f_state,
                  **record):
            return loop_solve(f, u0, *tspan, saveat_arr, f_state=f_state,
                              rtol=rtol, atol=atol, max_steps=max_steps,
                              step_fn=step, **record)

        def served(u0, tspan, *, saveat_arr, rtol, atol, max_steps, f_state,
                   **record):
            from ..ops.cuda.serving import conv_solve

            out = conv_solve(w, spec, running_stats(spec, f_state),
                             u0.contiguous(), tspan, rtol=rtol, atol=atol,
                             saveat_arr=saveat_arr, max_steps=max_steps,
                             tier=product_tier(prec, u0.device))
            # eval leaves the running stats alone: the state passes through
            return _solution(out, f_state)

        return f, step, (served if group is None else whole)

    def _train_dynamics(self, names, group=None):
        """The dynamics module in training mode as the stored adjoint's
        stateful ``f(u, t, params, st) -> (du, st)`` (its BatchNorms'
        moments over the ranks of ``group``)."""
        def f(u, t, params, st):
            return self._call_model(u, t, st, True, dict(zip(names, params)),
                                    group)

        return f

    def _conv_stored_kwargs(self, names, group=None):
        """``stored_odesolve``'s callables for the conv family: the plain
        module (training mode) for k1, the dt probe and the FSAL closure,
        kernel 13 for every attempt with the running stats threaded (all at
        ``mm_precision``), kernel 14 for the transpose of every accepted
        step, recomputing at ``bwd_precision`` with its gradient products at
        the default tier (the reference's ``conv_step_vjp``). On the global
        grid (``group``) the whole forward and sweep run on the whole batch
        on every rank (``whole_batch``): kernel 13's statistics are in
        every step."""
        from ..ops.cuda import fused_conv_step, fused_conv_step_bwd

        spec, prec, bwd = self.conv, self.mm_precision, self.bwd_precision

        def step_fn(params, u, t, dt, k1, st):
            u_new, utilde, *ks, g6, stats = fused_conv_step(
                ConvWeights(*params), spec, u.contiguous(), t, dt,
                k1.contiguous(), training=True,
                rstats=running_stats(spec, st), precision=prec)
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6,
                                   with_running_stats(spec, st, stats))

        def step_vjp(params, u, t, dt, k1, d_unew, d_ks):
            zero = torch.zeros_like(u)
            d_w, d_u, d_k1 = fused_conv_step_bwd(
                ConvWeights(*params), spec, u.contiguous(), t, dt,
                k1.contiguous(),
                [c.contiguous() for c in (d_unew, zero, *d_ks, zero)],
                precision=bwd, grad_precision=None)
            return list(d_w), d_u, d_k1

        return dict(f=self._train_dynamics(names), step_fn=step_fn,
                    step_vjp=step_vjp, stateful=True,
                    whole_batch=group is not None)

    def _chain_stored_kwargs(self):
        """``stored_odesolve``'s callables for the chain family, routed as
        the reference's: the plain chain for f (and so for the FSAL closure
        and any eager step) and kernel 5 for the recorded forward at
        ``mm_precision``, kernel 9 for the sweep with its replay at
        ``mm_precision``, its recompute at ``bwd_precision`` and its
        gradient products at the default tier (``grad_precision=None``),
        whatever the forward's tier. The forward declines where the sweep
        cannot run, so an eager forward is swept by the eager sweep. On the
        global grid ``stored_odesolve`` runs both on the whole batch's
        solve (``ode/stored_adjoint.py``)."""
        from ..ops.cuda import (
            chain_eval, chain_sweep_feasible, persistent_chain_solve,
            persistent_chain_sweep,
        )
        from ..ops.cuda.fused_solve_bwd import sweep_tiers

        chain, prec = self.chain, self.mm_precision
        tiers = dict(precision=prec, grad_precision=None,
                     recompute_precision=self.bwd_precision)

        def f(u, t, params):
            return chain_eval(params, chain, u, self.forward_tier(u.device))

        def persistent_fn(u0, params, tspan, *, saveat_arr, **kw):
            if not chain_sweep_feasible(chain, saveat_arr.shape[0], u0.device,
                                        sweep_tiers(**tiers,
                                                    device=u0.device)):
                return None
            out = persistent_chain_solve(list(params), chain, u0.contiguous(),
                                         tspan, saveat_arr=saveat_arr,
                                         precision=prec, **kw)
            return _solution(out, None)

        def sweep_fn(params, knot_ts, knot_us, naccept, saveat_arr, ct_ys,
                     ct_y, two_level_ctx=None):
            return persistent_chain_sweep(
                list(params), chain, knot_ts, knot_us, naccept, saveat_arr,
                ct_ys, ct_y, two_level_ctx=two_level_ctx, **tiers)

        kw = dict(f=f)
        if self.use_persistent:
            kw.update(persistent_fn=persistent_fn, sweep_fn=sweep_fn)
        return kw

    def _stored_kwargs(self, kernels: bool, names, x, n_save: int,
                       group=None):
        """The dynamics and replacements ``stored_odesolve`` takes, for the
        kernel route or the generic one, for a solve from ``x`` with
        ``n_save`` saveat times (on the global grid of ``group``); every
        callable gets the parameters explicitly, since the backward runs
        after the caller returns."""
        if not kernels:
            return dict(f=self._train_dynamics(names, group), stateful=True)
        if self.family == "chain":
            return self._chain_stored_kwargs()
        if self.family == "conv":
            return self._conv_stored_kwargs(names, group)
        from ..ops.cuda import (
            TDMLPWeights, fused_tdmlp, fused_tsit5_step,
            persistent_stored_sweep, persistent_tsit5_solve,
            persistent_two_level_sweep, sweep_feasible, tdmlp_plain,
        )

        B, F = x.shape
        H = self.tdmlp_weights().b1.shape[0]
        prec, bwd = self.mm_precision, self.bwd_precision
        tier = product_tier(prec, x.device)
        # the stage recompute at bwd_precision, the gradients at the
        # default tier (the reference's grad_precision=None)
        step_bwd = step_vjp_at(F, H, bwd, None)

        def f(u, t, params):
            return fused_tdmlp(TDMLPWeights(*params), u, t, prec)

        def fsal_fn(u, t, params):
            # the closure of the FSAL chain is plain autograd at the
            # forward's tier, as the reference transposes its pure twin
            return tdmlp_plain(TDMLPWeights(*params), u, t, tier)

        def step_fn(params, u, t, dt, k1):
            u_new, utilde, *ks, g6 = fused_tsit5_step(
                TDMLPWeights(*params), u, t, dt, k1, prec)
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
                                         u0.contiguous(), tspan,
                                         precision=prec, **kw)
            return _solution(out, None)

        # the replay at the forward's precision, the recompute at
        # bwd_precision, the gradients at the default tier
        tiers = dict(precision=prec, grad_precision=None,
                     recompute_precision=bwd)

        def sweep_fn(params, knot_ts, knot_us, naccept, saveat_arr, ct_ys,
                     ct_y, two_level_ctx=None):
            w = TDMLPWeights(*params)
            if two_level_ctx is None:
                a_u, a_k, d_w = persistent_stored_sweep(
                    w, knot_ts, knot_us, naccept, saveat_arr, ct_ys, ct_y,
                    **tiers)
            else:
                c = two_level_ctx
                a_u, a_k, d_w = persistent_two_level_sweep(
                    w, knot_ts, knot_us, naccept, saveat_arr, ct_ys, ct_y,
                    c["ckpt_ts"], c["ckpt_us"], c["ckpt_ks"], c["ckpt_dts"],
                    c["ckpt_qolds"], t_end=c["t_end"], rtol=c["rtol"],
                    atol=c["atol"], max_steps=c["max_steps"],
                    stride=c["stride"], dense_cap=c["dense_cap"], **tiers,
                )
            return a_u, a_k, list(d_w)

        kw = dict(f=f, fsal_fn=fsal_fn, step_fn=step_fn, step_vjp=step_vjp)
        # a planned decline, as the reference's: where kernel 4 or the sweep
        # cannot take the width, neither runs, so the plain loop records
        # unpadded knots for the plain sweep; the global grid runs kernels
        # 2 and 3
        if (self.use_persistent and group is None
                and sweep_feasible(B, F, H, n_save)):
            kw.update(persistent_fn=persistent_fn, sweep_fn=sweep_fn)
        return kw

    def _eval_solve(self, x, state, group=None):
        if torch.compiler.is_exporting():
            self._check_exportable(x)
        if self.uses_kernels(x) or torch.compiler.is_exporting():
            f, step_fn, persistent_fn = self._kernel_solvers(group)
        else:
            f, step_fn, persistent_fn = (self._generic_dynamics(group=group),
                                         None, None)
        saveat = device_saveat(self, x.device)
        if self.solver != "tsit5":
            sol = self._adams(f, x, state["model"], saveat, None, "none")
        else:
            sol = odesolve(
                f, x, self.tspan, rtol=self.rtol, atol=self.atol,
                saveat=saveat, max_steps=self.max_steps, adjoint="none",
                stateful=True, f_state=state["model"], step_fn=step_fn,
                persistent_fn=persistent_fn, group=group,
            )
        new_state = dict(state)
        new_state.update(model=sol.f_state, nfe=sol.nfe,
                         reg_val=torch.zeros((), device=x.device),
                         success=sol.success)
        return sol, new_state

    def _check_exportable(self, x):
        """Raise unless ``torch.export`` can trace this layer's eval solve
        from ``x``: one registered operator (``ops/cuda/serving.py``), the
        TD-MLP family's persistent solve (kernel 4, ``lrnde::tsit5_solve``),
        the chain family's (kernel 5, ``lrnde::chain_solve``) or the conv
        family's eval loop around kernel 13 (``lrnde::conv_solve``). The
        eager loop of a generic dynamics accepts steps on the host and has
        no operator."""
        ops = {"tdmlp": self.use_persistent, "chain": self.use_persistent,
               "conv": True}
        if (not ops.get(self.family) or self.solver != "tsit5"
                or self.use_pallas == "off"):
            raise NotImplementedError(
                "torch.export takes a NeuralODE whose eval solve is one "
                "registered operator: kernel 4 (the TD-MLP family, "
                "use_persistent), kernel 5 (the latent ODE's Dense chain, "
                "use_persistent) or the conv family's loop around kernel 13,"
                " each with Tsit5 and use_pallas not 'off'; this layer's "
                f"family is {self.family!r} with solver {self.solver!r}, "
                "whose adaptive loop accepts steps on the host")
        if x.ndim != (4 if self.family == "conv" else 2):
            raise NotImplementedError(
                f"torch.export: the {self.family} family's operator takes no "
                f"state of shape {tuple(x.shape)}")
        if self.family != "tdmlp":
            return
        from ..ops.cuda import solve_feasible

        w = self.tdmlp_weights()
        if not solve_feasible(x.shape[0], w.b2.shape[0], w.b1.shape[0]):
            raise NotImplementedError(
                f"torch.export: kernel 4 declines a state of shape "
                f"{tuple(x.shape)} at H = {w.b1.shape[0]}")

    def apply_layer(self, x, state, *, training: bool = False):
        draws, state = pop_draws(state)
        group, state = pop_group(state)
        if group is not None:
            self.check_global_grid()
        # every route's forward runs at this tier: refuse it below 1e-4
        check_product_tier(self.forward_tier(x.device), self.rtol)
        if not training:
            sol, new_state = self._eval_solve(x, state, group)
            agree_counts(sol, group)
            return sol, new_state
        t2 = self.tspan[1]
        kernels = self.uses_kernels(x)
        names, params = zip(*self.model.named_parameters())
        user_saveat = (
            device_saveat(self, x.device) if self.saveat is not None
            else device_scalar(t2, x).reshape(1)
        )
        if draws is None:
            draws = to_device(self.draw(state, x.shape[0]), x)
        unbiased = self.regularize == "unbiased"
        saveat, reservoir = user_saveat, draws.get("reservoir")
        if unbiased:
            t1 = draws["t1"]
            saveat = torch.cat([user_saveat, t1.reshape(1)])
        if self.solver == "tsit5" and self.adjoint == "stored":
            kw = self._stored_kwargs(kernels, names, x, saveat.shape[0],
                                     group)
            sol = odesolve(
                kw.pop("f"), x, self.tspan, rtol=self.rtol, atol=self.atol,
                saveat=saveat, max_steps=self.max_steps, adjoint="stored",
                params=list(params), knot_window=self.knot_window,
                reservoir=reservoir, f_state=state["model"], group=group,
                **kw,
            )
        else:
            sol = self._mode_solve(x, state["model"], saveat, reservoir,
                                   kernels, names, params, group)
        agree_counts(sol, group)
        # the stateless kernel families return no state: theirs passes
        model_state = state["model"] if sol.f_state is None else sol.f_state
        new_state = dict(state)
        new_state.update(model=model_state, nfe=sol.nfe,
                         reg_val=torch.zeros((), device=x.device),
                         success=sol.success)
        if self.regularize == "none":
            return sol, new_state
        if unbiased:
            u1 = sol.ys[-1].detach()
            sol = dataclasses.replace(sol, ys=sol.ys[:-1], ts=user_saveat)
        else:
            u1, t1 = sol.reservoir_u.detach(), sol.reservoir_t.detach()
        # the chain family has no step kernel: its regulariser step is the
        # generic one, as in the reference
        family = self.family if kernels and self.family != "chain" else None
        if family == "conv" and group is not None:
            # kernel 13's statistics: the whole batch's step on every rank
            from ..parallel.mesh import gather_rows

            u1, group = gather_rows(u1, group), None
        step, dt_r = self._reg_step(x, u1, t1, model_state, family, group)
        new_state.update(
            model=step.f_state,
            reg_val=regularization_value(self.regularize_type, step, u1,
                                         dt_r, self.atol, self.rtol, group),
            nfe=sol.nfe + 8,  # 6 stages + k1 + the dt probe
        )
        return sol, new_state

    def _adams(self, f, x, st, saveat, reservoir, adjoint):
        """The Adams solve of ``f(u, t, st) -> (du, st)`` from ``x``."""
        return adams_solve(
            f, x, self.tspan, rtol=self.rtol, atol=self.atol,
            moulton=self.solver == "vcabm3", saveat=saveat,
            max_steps=self.max_steps, adjoint=adjoint, stateful=True,
            f_state=st, reservoir=reservoir)

    def _direct_solvers(self, kernels: bool, group=None):
        """``(f(u, t, st) -> (du, st), step_fn)`` that autograd runs
        through, on the live parameters: on the kernel route kernel 1
        (``FusedTDMLP``) and kernels 2 + 3 (``FusedTsit5Step``) for the
        TD-MLP, the plain module and kernels 13 + 14 for the conv family,
        the plain chain and generic steps for the chain; else the module
        (its BatchNorms' moments over the ranks of ``group``) and generic
        steps."""
        if not kernels:
            return self._generic_dynamics(training=True, group=group), None
        if self.family == "chain":
            from ..ops.cuda import chain_eval

            params, chain = self.chain_params(), self.chain
            return (lambda u, t, st: (chain_eval(
                params, chain, u, self.forward_tier(u.device)), st)), None
        if self.family == "conv":
            from ..ops.cuda import differentiable_conv_step

            w, spec, prec = self.conv_weights(), self.conv, self.mm_precision

            def conv_step(fn, u, t, dt, k1, st):
                # the fused step's VJP: recompute at the forward's
                # precision, gradients at the default tier
                u_new, utilde, *ks, g6, stats = differentiable_conv_step(
                    w, spec, u.contiguous(), t, dt, k1.contiguous(),
                    running_stats(spec, st), prec, None)
                return Tsit5StepResult(u_new, utilde, (k1, *ks), g6,
                                       with_running_stats(spec, st, stats))

            return self._generic_dynamics(training=True), conv_step
        from ..ops.cuda import differentiable_step, differentiable_tdmlp

        w = self.tdmlp_weights()
        prec = self.mm_precision
        # the fused step's VJP: recompute at the forward's precision,
        # gradients at the default tier (reference fused_mlp.py:285-290)
        vjp = step_vjp_at(w.b2.shape[0], w.b1.shape[0], prec, None)

        def f(u, t, st):
            return differentiable_tdmlp(w, u.contiguous(), t, prec), st

        def step(fn, u, t, dt, k1, st):
            u_new, utilde, *ks, g6 = differentiable_step(
                w, u.contiguous(), t, dt, k1.contiguous(), vjp, prec)
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, st)

        return f, step

    def _continuous_kwargs(self, kernels: bool, names):
        """``f(u, t, params, st)`` and ``step_fn(params, u, t, dt, k1, st)``
        of the continuous adjoints: the forward's step is the family's step
        kernel (under no_grad), the reverse solves take VJPs of ``f``
        (kernel 1 forward on the TD-MLP route)."""
        if not kernels:
            return dict(f=self._train_dynamics(names))
        if self.family == "chain":
            from ..ops.cuda import chain_eval

            chain = self.chain
            return dict(f=lambda u, t, params, st: (
                chain_eval(params, chain, u, self.forward_tier(u.device)),
                st))
        if self.family == "conv":
            kw = self._conv_stored_kwargs(names)
            return dict(f=kw["f"], step_fn=kw["step_fn"])
        from ..ops.cuda import (
            TDMLPWeights, differentiable_tdmlp, fused_tsit5_step,
        )

        prec = self.mm_precision

        def f(u, t, params, st):
            return differentiable_tdmlp(TDMLPWeights(*params),
                                        u.contiguous(), t, prec), st

        def step_fn(params, u, t, dt, k1, st):
            u_new, utilde, *ks, g6 = fused_tsit5_step(
                TDMLPWeights(*params), u.contiguous(), t, dt,
                k1.contiguous(), prec)
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, st)

        return dict(f=f, step_fn=step_fn)

    def _mode_solve(self, x, st, saveat, reservoir, kernels, names, params,
                    group=None):
        """A training solve other than the stored adjoint's Tsit5: the
        Adams solvers under ``'direct'``, the direct adjoint (on the global
        grid with ``group``), or a continuous adjoint."""
        if self.solver != "tsit5":
            f, _ = self._direct_solvers(kernels)
            return self._adams(f, x, st, saveat, reservoir, "direct")
        if self.adjoint == "direct":
            f, step = self._direct_solvers(kernels, group)
            whole = kernels and self.family == "conv" and group is not None
            if whole:
                # kernel 13's statistics: the whole batch on every rank,
                # each rank's loss differentiated through the gather
                from ..parallel.mesh import gather_rows_grad, rank_solution

                x, dp, group = gather_rows_grad(x, group), group, None
            sol = odesolve(
                f, x, self.tspan, rtol=self.rtol, atol=self.atol,
                saveat=saveat, max_steps=self.max_steps, adjoint="direct",
                stateful=True, f_state=st, step_fn=step, reservoir=reservoir,
                group=group)
            return rank_solution(sol, dp) if whole else sol
        kw = self._continuous_kwargs(kernels, names)
        return odesolve(
            kw.pop("f"), x, self.tspan, rtol=self.rtol, atol=self.atol,
            saveat=saveat, max_steps=self.max_steps, adjoint=self.adjoint,
            params=list(params), stateful=True, f_state=st,
            reservoir=reservoir, **kw)

    def _reg_step(self, x, u1, t1, st, family, group=None):
        """The regulariser's step from the fenced ``(u1, t1)`` and the
        dynamics state ``st`` after the solve: k1 and dt under no_grad, then
        one differentiable Tsit5 step in training mode (the step kernel with
        its VJP kernel on the kernel route of the TD-MLP and conv families,
        the generic step otherwise). Returns (step, dt); ``step.f_state`` is
        the state after the step. On the global grid (``group``) the dt
        probe's norms are over every rank's rows, and so are the generic
        dynamics' BatchNorm moments."""
        t2 = self.tspan[1]
        prec = self.mm_precision
        if family == "tdmlp":
            from ..ops.cuda import differentiable_step, fused_tdmlp

            w = self.tdmlp_weights()

            def f(u, t):
                return fused_tdmlp(w, u, t, prec)
        else:
            dyn = self._generic_dynamics(training=True, group=group)

            def f(u, t):
                return dyn(u, t, st)[0]
        with torch.no_grad():
            k1 = f(u1, t1)
            dt_r, _ = initial_step_size(f, u1, t1, order=5, rtol=self.rtol,
                                        atol=self.atol, f0=k1, group=group)
            dt_r = torch.minimum(dt_r, device_scalar(t2, x) - t1)
        if family == "tdmlp":
            u_new, utilde, *ks, g6 = differentiable_step(
                w, u1.contiguous(), t1, dt_r, k1,
                step_vjp_at(w.b2.shape[0], w.b1.shape[0], prec, None),
                prec)
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, st), dt_r
        if family == "conv":
            from ..ops.cuda import differentiable_conv_step

            spec = self.conv
            u_new, utilde, *ks, g6, stats = differentiable_conv_step(
                self.conv_weights(), spec, u1.contiguous(), t1, dt_r,
                k1.contiguous(), running_stats(spec, st), prec, None)
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6,
                                   with_running_stats(spec, st, stats)), dt_r
        return tsit5_step(dyn, u1, t1, dt_r, k1, st), dt_r


def step_vjp_at(F: int, H: int, precision, grad_precision):
    """The TD-MLP step's VJP at (F, H), ``vjp(w, u, t, dt, k1, cts)``, its
    stage recompute at ``precision`` and its transposed products at
    ``grad_precision``: kernel 3 where its transposed step fits a CTA, else
    its plain twin. The reference's VJP kernel takes any width (its tile
    shrinks); kernel 3 has no plan for a wide one yet (README, documented
    deviations)."""
    from ..ops.cuda import fused_step_bwd, step_bwd_feasible
    from ..ops.cuda.fused_mlp_bwd import step_bwd_plain_at

    fn = fused_step_bwd if step_bwd_feasible(F, H) else step_bwd_plain_at
    return functools.partial(fn, precision=precision,
                             grad_precision=grad_precision)


def agree_counts(sol, group) -> None:
    """On the global grid, raise unless every rank took this solve's
    accepts and rejects (one collective of the two counts)."""
    if group is not None:
        from ..parallel.mesh import agree

        agree(torch.stack([sol.naccept, sol.nreject]), group,
              "the solve's accepts and rejects")


def _solution(out, f_state) -> ODESolution:
    """An ``ODESolution`` from the persistent solve's output dict."""
    return ODESolution(
        ts=out["ts"], ys=out["ys"], t_final=out["t_final"],
        y_final=out["y_final"], nfe=out["nfe"], naccept=out["naccept"],
        nreject=out["nreject"], success=out["success"], f_state=f_state,
        **{k: out[k] for k in out
           if k.startswith(("knot_", "ckpt_", "reservoir_"))},
    )
