"""NeuralODE — the locally regularised neural ODE layer, in eval mode.

Counterpart of ``localregneuralde_tpu/models/neural_ode.py`` (reference
``src/layers/neural_ode.jl``). In eval mode the layer solves with adjoint
``'none'`` and no regulariser, and returns the layer state
``{"model", "nfe", "reg_val", "success"}`` under the reference's keys.

Kernel dispatch (``use_pallas``, the reference's config name): when the
dynamics is a ``TDChain`` of two Dense layers, ``'on'`` routes the solve
through the fused TD-MLP wrappers (``ops/cuda``) and ``'auto'`` does so for
CUDA inputs; ``'off'`` runs the dynamics module in the eager loop. With
``use_persistent`` the whole solve is one launch of the persistent kernel;
without it the loop calls the fused Tsit5 step kernel per attempt. The
wrappers run their plain versions on CPU tensors.

Training (the unbiased/biased regulariser and the adjoints) is not ported
yet: ``training=True`` raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..nn.basic import Dense, resolve_solver_precision
from ..nn.module import Module
from ..ode.solve import ODESolution, odesolve
from ..ode.step import Tsit5StepResult
from ..core.containers import ArrayAndTime, get_array
from .common import TDChain

_VALID_REGULARIZE = ("none", "unbiased", "biased")
_VALID_REG_TYPE = ("error_estimate", "stiffness_estimate")
_VALID_USE_PALLAS = ("auto", "on", "off")


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
        if use_pallas == "on" and not is_tdmlp(model):
            raise ValueError(
                "use_pallas='on' requires a TDChain of two Dense layers (the "
                "fused TD-MLP family); the other kernel families are not "
                "ported yet"
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
        self.use_pallas = use_pallas if is_tdmlp(model) else "off"
        self.use_persistent = bool(use_persistent)
        self.knot_window = None if knot_window is None else int(knot_window)
        # recorded for parity with the reference; every tier is FP32 here
        self.mm_precision = resolve_solver_precision(precision, self.rtol)

    def init_state(self) -> dict:
        return {
            "model": self.model.init_state(),
            "nfe": torch.tensor(-1, dtype=torch.int32),
            "reg_val": torch.tensor(0.0),
            "success": torch.tensor(True),
        }

    def uses_kernels(self, x: torch.Tensor) -> bool:
        """Whether a solve from ``x`` goes through the fused TD-MLP family."""
        if self.use_pallas == "on":
            return True
        return self.use_pallas == "auto" and x.is_cuda

    def tdmlp_weights(self):
        from ..ops.cuda import TDMLPWeights

        l0, l1 = self.model.layers.values()
        return TDMLPWeights(l0.w, l0.b, l1.w, l1.b)

    def _generic_dynamics(self):
        def f(u, t, st):
            y, st_new = self.model(ArrayAndTime(u, t), st)
            return get_array(y), st_new

        return f

    def _kernel_solvers(self):
        """(dynamics, step_fn, persistent_fn) of the fused TD-MLP family."""
        from ..ops.cuda import fused_tdmlp, fused_tsit5_step, persistent_tsit5_solve

        w = self.tdmlp_weights()

        def f(u, t, st):
            return fused_tdmlp(w, u, t), st

        def step(fn, u, t, dt, k1, f_st):
            u_new, utilde, *ks, g6 = fused_tsit5_step(w, u, t, dt, k1)
            return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, f_st)

        def persistent(u0, tspan, *, saveat_arr, rtol, atol, max_steps,
                       f_state):
            if u0.ndim != 2 or u0.dtype != torch.float32:
                return None  # decline: the loop with the step kernel runs
            out = persistent_tsit5_solve(
                w, u0.contiguous(), tspan, rtol=rtol, atol=atol,
                saveat_arr=saveat_arr, max_steps=max_steps,
            )
            # the fused family is stateless: its state passes through
            return ODESolution(
                ts=saveat_arr, ys=out["ys"], t_final=out["t_final"],
                y_final=out["y_final"], nfe=out["nfe"],
                naccept=out["naccept"], nreject=out["nreject"],
                success=out["success"], f_state=f_state,
            )

        return f, step, (persistent if self.use_persistent else None)

    def apply_layer(self, x, state, *, training: bool = False):
        if training:
            raise NotImplementedError(
                "NeuralODE training (regularised solve, stored adjoint) is not "
                "ported yet: it is the next slice, ROADMAP Queue 1 items 5-6"
            )
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
        new_state = {
            "model": sol.f_state,
            "nfe": sol.nfe,
            "reg_val": torch.zeros((), device=x.device),
            "success": sol.success,
        }
        return sol, new_state
