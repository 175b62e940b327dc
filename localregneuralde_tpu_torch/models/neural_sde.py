"""NeuralDSDE — the locally regularised neural SDE layer (drift +
diffusion, diagonal noise or, with ``noise_dims``, matrix noise).

Counterpart of ``localregneuralde_tpu/models/neural_sde.py`` (reference
``src/layers/neural_sde.jl``). The layer returns the state ``{"drift",
"diffusion", "nfe_drift", "nfe_diffusion", "reg_val", "rng", "success"}``
under the reference's keys, NFE counted per closure; ``rng`` is a
``torch.Generator`` where the reference keeps a JAX key. The solver is
``'sosri'`` (default), ``'sri'``, ``'milstein'`` (commutative Milstein) or
``'euler_heun'`` (Lamba–Euler–Heun, Stratonovich). With ``noise_dims = m``
(``'milstein'`` only) the diffusion net emits d·m values, viewed as the
noise-rate matrix ``u.shape + (m,)``, and the tree draws ``(B, m)``
increments (reference ``neural_sde.py:60-80, 262-281``). Training takes
the stored adjoint or, with ``adjoint='direct'``, autograd through the
eager loop.

- Every call draws the noise seed of its Brownian tree from ``rng``
  (``sample_noise_seed``); the tree's normals come from ``noise_source``,
  the counter-based Philox source by default. A call's draws (the seed,
  t1 or the reservoir, the regulariser's noise) come from ``draw``; a
  train step stages them ahead (``models/draws.py``).
- Eval mode solves with adjoint ``'none'`` and no regulariser.
- Training solves with the stored adjoint (``sde/stored_adjoint.py``).
  ``regularize='unbiased'`` draws t1 ~ U(t0, t2), appends it to the saveat
  grid and strips it from the outputs; ``'biased'`` takes ``(t1, u(t1))``
  from a reservoir sample of the accepted steps' starting points (never
  t_end), from ``max_steps`` uniforms drawn in advance. Either way one more
  step of the layer's solver from the fenced ``(u(t1), t1)`` — dt from the drift-magnitude
  heuristic under ``no_grad``, fresh ``dW, dZ ~ N(0, dt)`` from ``rng`` — is
  taken through autograd, and ``reg_val = eest · dt``; its gradient reaches
  the parameters only (the noise has the noise's shape). NFE adds the
  step's evaluations and the dt probe's drift evaluation (4 + 1 and 4 for
  SRI).

Kernel dispatch (``use_pallas``): for the kernel family of the reference's
MNIST SDE (``_is_fused_family``: drift ``Chain(Dense(F, H, tanh), Dense(H,
F))``, diffusion ``Dense(F, F)``), ``'on'`` routes the solves through the
fused wrappers and ``'auto'`` does so for CUDA inputs, when
``use_persistent`` is set: the forward is one launch of the persistent SDE
solve (``ops/cuda/fused_sde_solve.py``), the backward one launch of the
sweep (``ops/cuda/fused_sde_sweep.py``). The kernels serve SRI/SOSRI with
diagonal noise under the stored adjoint (and in eval), as the reference's
(``neural_sde.py:164-165, 210-211``): any other solver, ``noise_dims`` or
the direct adjoint runs the eager loop on the modules. The wrappers run their plain
versions on CPU tensors. Otherwise the eager loop runs the drift and
diffusion modules. The regulariser's step is plain PyTorch on either route,
as the reference leaves it to XLA.

Precision tiers (reference ``neural_sde.py:155-268``): ``mm_precision`` is
``precision`` resolved at ``rtol`` ('auto': 'highest' below 1e-4, else
None, the backend default), and ``nn.basic.product_tier`` maps it to what a
product computes on the device: the default is TF32 on a card and FP32 on
the CPU. Kernel 10 solves at ``mm_precision``, in eval and in the training
forward; kernel 12 recomputes the stages at ``mm_precision`` and runs its
transposed and weight-gradient products at the default tier whatever the
forward's, the reference's ``grad_precision=None`` (so ``'highest'`` keeps
FP32 forwards with TF32 gradient products on a card). The plain route (the
eager SRI/SOSRI, Milstein and Lamba–Euler–Heun loops, the direct adjoint,
the plain stored adjoint's step VJP) and the regulariser's step call the
drift and diffusion modules inside ``product_tier_scope`` at
``mm_precision``'s tier, their transposes at the same tier (JAX transposes
a dot at its own precision). ``grad_precision='default'`` warns and does
nothing, as the reference's. A forward at the TF32 tier below rtol 1e-4
raises (``nn.basic.check_product_tier``; the reference saturates
``max_steps``).

The global grid of data parallelism (``parallel/sharded_train.py``) gives
the layer a ``DPGroup`` under its state's ``"dp_group"`` key: the input is
then one rank's rows of a batch spread over the group's ranks. Every norm
of the solve, of its first dt and of the regulariser's step is over all
their rows (``ops/residuals.py``), the tree draws this rank's rows of the
whole batch's (``noise_source``'s ``row_offset``: the rank's offset in its
microbatch), and the regulariser's normals are this rank's rows of the
whole batch's (staged by global row, ``draw_row_axes``). Kernel 10 takes no
part in a collective, so on the kernel route it runs as GSPMD runs a
replicated custom call: on the whole batch, gathered from the ranks, with
the whole batch's tree, on every rank, each keeping its rows
(``sde.solve.replicated_sde``); kernel 12 sweeps the rank's rows of the
knots. The eager route's loop takes the group's norms. After each solve
the ranks' accept and reject counts are held equal.
"""
from __future__ import annotations

import warnings
from typing import Optional, Union

import dataclasses

import torch

from ..nn.basic import (
    _ACTIVATIONS,
    Chain,
    Dense,
    check_product_tier,
    product_tier,
    product_tier_scope,
    resolve_solver_precision,
)
from ..nn.module import Module
from ..ode.solve import device_scalar
from ..ops.residuals import internal_norm
from ..sde.brownian import PhiloxNormals, seed_to_word
from ..sde.solve import (
    SRI_SOLVERS,
    SDESolution,
    check_solver,
    sde_step,
    sdesolve,
    solution_from,
)
from ..sde.step import step_nfe
from .draws import pop_draws, to_device
from .neural_ode import (
    agree_counts, device_saveat, pop_group, sample_reservoir_uniforms,
    sample_t1,
)

_VALID_REGULARIZE = ("none", "unbiased", "biased")
_VALID_USE_PALLAS = ("auto", "on", "off")


def sample_noise_seed(generator: torch.Generator) -> int:
    """The 32-bit seed of a solve's Brownian tree, from the layer's CPU
    generator."""
    return int(torch.randint(0, 2 ** 32, (), generator=generator))


def noise_source(seed, x: torch.Tensor, width: Optional[int] = None,
                 row_offset: int = 0):
    """The normal source of the tree of a solve from ``x``, of ``(B,
    width)`` increments (default the state's width; ``noise_dims`` for
    matrix noise); ``seed`` is the one-element int32 tensor ``draw``
    staged (or a number). On the global grid of data parallelism ``x`` is
    rows ``row_offset ..`` of the batch, and the source draws those rows
    of the whole batch's tree."""
    return PhiloxNormals(seed, x.shape[0], width or x.shape[-1],
                         device=x.device, row_offset=row_offset)


def sample_reg_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard normals ``(2, *shape)`` for the regulariser's step; scaled
    by √dt they are its ``(dW, dZ)``."""
    return torch.randn((2,) + tuple(shape), generator=generator)


def _identity(layer) -> bool:
    return any(layer.activation is _ACTIVATIONS[k] for k in (None, "identity"))


def is_sde_family(drift, diffusion) -> bool:
    """True for drift ``Chain(Dense(F, H, tanh), Dense(H, F))`` and
    diffusion ``Dense(F, F)``, all with biases: the SDE kernels' family.
    The activations are checked by identity, since the parameter shapes
    cannot tell them apart."""
    layers = list(getattr(drift, "layers", {}).values())
    if not (isinstance(drift, Chain) and len(layers) == 2):
        return False
    l0, l1 = layers
    if not all(isinstance(x, Dense) and x.use_bias for x in (l0, l1, diffusion)):
        return False
    F = l0.in_dim
    return (l0.activation is torch.tanh and _identity(l1) and _identity(diffusion)
            and l1.in_dim == l0.out_dim and l1.out_dim == F
            and diffusion.in_dim == F and diffusion.out_dim == F)


class NeuralDSDE(Module):
    # the draws with a row of the batch on an axis: the regulariser step's
    # normals (2, rows, F) (models/draws.py::rows_of)
    draw_row_axes = {"reg_noise": 1}

    def __init__(
        self,
        drift: Module,
        diffusion: Module,
        *,
        tspan=(0.0, 1.0),
        regularize: Union[bool, str] = "unbiased",
        rtol: float = 1e-2,
        atol: float = 1e-2,
        max_steps: int = 256,
        checkpoint_every: int = 16,
        saveat=None,
        adjoint: str = "stored",
        solver: str = "sosri",
        delta: float = 1 / 6,
        noise_dims: Optional[int] = None,
        precision: str = "auto",
        grad_precision: str = "match",
        use_pallas: Union[bool, str] = "auto",
        use_persistent: bool = True,
        rng_seed: int = 0,
    ):
        super().__init__()
        if isinstance(regularize, bool):
            regularize = "unbiased" if regularize else "none"
        if regularize not in _VALID_REGULARIZE:
            raise ValueError(f"regularize must be one of {_VALID_REGULARIZE}")
        check_solver(solver, None if noise_dims is None else (noise_dims,))
        if adjoint not in ("stored", "direct"):
            raise ValueError(
                f"NeuralDSDE adjoint must be 'stored' or 'direct', got "
                f"{adjoint!r}")
        if grad_precision not in ("match", "default"):
            raise ValueError(
                f"grad_precision must be 'match' or 'default', got "
                f"{grad_precision!r}"
            )
        if isinstance(use_pallas, bool):
            use_pallas = "on" if use_pallas else "off"
        if use_pallas not in _VALID_USE_PALLAS:
            raise ValueError(f"use_pallas must be one of {_VALID_USE_PALLAS}")
        if use_pallas == "on" and not is_sde_family(drift, diffusion):
            raise ValueError(
                "use_pallas='on' requires drift Chain(Dense(F, H, tanh), "
                "Dense(H, F)) and diffusion Dense(F, F) (the SDE kernels' "
                "family)"
            )
        self.drift = drift
        self.diffusion = diffusion
        self.tspan = (float(tspan[0]), float(tspan[1]))
        self.regularize = regularize
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.max_steps = int(max_steps)
        self.checkpoint_every = int(checkpoint_every)
        self.saveat = None if saveat is None else torch.as_tensor(
            saveat, dtype=torch.float32
        )
        self.adjoint = adjoint
        self.solver = solver
        self.delta = float(delta)
        self.noise_dims = None if noise_dims is None else int(noise_dims)
        self.use_pallas = use_pallas if is_sde_family(drift, diffusion) else "off"
        self.use_persistent = bool(use_persistent)
        self.rng_seed = int(rng_seed)
        self.mm_precision = resolve_solver_precision(precision, self.rtol)
        if grad_precision == "default" and self.mm_precision is not None:
            warnings.warn(
                "solver.grad_precision='default' has no effect on the "
                "NeuralDSDE family: its backward recomputes the stages at "
                f"the forward's matmul precision ({self.mm_precision!r}).",
                stacklevel=2,
            )

    def init_state(self) -> dict:
        return {
            "drift": self.drift.init_state(),
            "diffusion": self.diffusion.init_state(),
            "nfe_drift": torch.tensor(-1, dtype=torch.int32),
            "nfe_diffusion": torch.tensor(-1, dtype=torch.int32),
            "reg_val": torch.tensor(0.0),
            "rng": torch.Generator().manual_seed(self.rng_seed),
            "success": torch.tensor(True),
        }

    def state_width(self) -> int:
        """F, the width of the SDE's state: the input width of the drift's
        first Dense layer."""
        for m in self.drift.modules():
            if isinstance(m, Dense):
                return m.in_dim
        raise ValueError("NeuralDSDE.draw: the drift has no Dense layer to "
                         "give the state's width")

    def draw(self, state, rows: int, training: bool = True) -> dict:
        """A call's draws from ``state["rng"]``, on the host, in the order
        the call uses them: the tree's seed (as an int32 word), then in
        training t1 (unbiased) or the reservoir's uniforms (biased), then
        the regulariser step's ``(2, rows, F)`` normals."""
        gen = state["rng"]
        seed = seed_to_word(sample_noise_seed(gen))
        out = {"seed": torch.tensor([seed], dtype=torch.int32)}
        mode = self.regularize if training else "none"
        if mode == "unbiased":
            out["t1"] = torch.tensor(sample_t1(gen, *self.tspan),
                                     dtype=torch.float32)
        elif mode == "biased":
            out["reservoir"] = sample_reservoir_uniforms(gen, self.max_steps)
        if mode != "none":
            out["reg_noise"] = sample_reg_noise(
                gen, (rows, self.noise_dims or self.state_width()))
        return out

    def persistent_step(self, rows: int, device) -> bool:
        """Whether a training step on ``device`` runs the solve and the
        sweep as one kernel launch each (K10 and K12), with no host read:
        the stored adjoint over SRI/SOSRI with diagonal noise."""
        return torch.device(device).type == "cuda" and (
            self.kernel_mode() and self.adjoint == "stored"
            and self.use_pallas != "off")

    def check_global_grid(self) -> None:
        """Every solver, noise and adjoint of the layer takes the global
        grid of data parallelism (``parallel/sharded_train.py``): the
        eager loop with the group's norms and the tree by global row, or
        on the kernel route kernel 10 on the whole batch on every rank and
        kernel 12 on the rank's rows of its knots."""

    def kernel_mode(self) -> bool:
        """Whether the persistent SDE kernels serve this layer's solver and
        noise (SRI/SOSRI, diagonal), as the reference's gate."""
        return (self.use_persistent and self.solver in SRI_SOLVERS
                and self.noise_dims is None)

    def uses_kernels(self, x: torch.Tensor) -> bool:
        """Whether a solve from ``x`` goes through the persistent SDE
        kernels."""
        if not self.kernel_mode():
            return False
        return self.use_pallas == "on" or (self.use_pallas == "auto"
                                           and x.is_cuda)

    def forward_tier(self, device) -> str:
        """The tier of the drift's and diffusion's forward products on
        ``device``: ``mm_precision``'s."""
        return product_tier(self.mm_precision, device)

    def _params(self):
        return (list(self.drift.named_parameters()),
                list(self.diffusion.named_parameters()))

    def _dynamics(self):
        """``f(u, t, params)`` and ``g(u, t, params)`` of the modules, with
        the drift's parameters first in ``params``, their products at
        ``forward_tier`` (the reference's ``default_matmul_precision``
        around them), their transposes at the same tier."""
        d_params, g_params = self._params()
        dn, gn = [n for n, _ in d_params], [n for n, _ in g_params]
        n_d = len(dn)

        def call(module, names, params, u, t):
            with product_tier_scope(self.forward_tier(u.device)):
                y, _ = torch.func.functional_call(
                    module, dict(zip(names, params)), (u, module.init_state()))
            return y

        def f(u, t, params):
            return call(self.drift, dn, params[:n_d], u, t)

        def g(u, t, params):
            gu = call(self.diffusion, gn, params[n_d:], u, t)
            if self.noise_dims is not None:  # the noise-rate matrix
                gu = gu.reshape(u.shape + (self.noise_dims,))
            return gu

        return f, g

    def _kernel_fns(self):
        """The kernel route's replacements: the persistent solve at
        ``mm_precision`` and its sweep, recomputing at ``mm_precision``
        with its gradient products at the default tier (the reference's
        ``grad_precision=None``)."""
        from ..ops.cuda import SDEWeights, persistent_sde_solve, persistent_sde_sweep

        prec = self.mm_precision

        def persistent_fn(u0, params, tspan, *, saveat_arr, **kw):
            out = persistent_sde_solve(SDEWeights(*params), u0.contiguous(),
                                       tspan, saveat_arr=saveat_arr,
                                       precision=prec, **kw)
            return solution_from(out, saveat_arr)

        def sweep_fn(params, knot_ts, knot_us, knot_dws, knot_dzs, naccept,
                     saveat_arr, ct_ys, ct_y):
            a_u, d_w = persistent_sde_sweep(
                SDEWeights(*params), knot_ts, knot_us, knot_dws, knot_dzs,
                naccept, saveat_arr, ct_ys, ct_y, solver=self.solver,
                delta=self.delta, precision=prec, grad_precision=None)
            return a_u, list(d_w)

        return persistent_fn, sweep_fn

    def _serving_fn(self, params, seed, x):
        """The eval solve's replacement on the kernel route (and whenever
        ``torch.export`` traces the layer, which cannot trace the eager
        loop): kernel 10 with its tree from the staged ``seed``, through
        the registered operator ``lrnde::sde_solve``
        (``ops/cuda/serving.py``); None where the eager loop runs."""
        if not (self.uses_kernels(x) or torch.compiler.is_exporting()):
            return None
        if not self.kernel_mode():
            raise NotImplementedError(
                "torch.export of a NeuralDSDE takes the persistent SDE "
                "solve (kernel 10: SRI/SOSRI, diagonal noise, "
                "use_persistent); this layer's solver runs the eager loop")
        from ..ops.cuda import SDEWeights
        from ..ops.cuda.serving import sde_solve

        tier = product_tier(self.mm_precision, x.device)
        check_product_tier(tier, self.rtol)

        def solve(u0, tspan, *, saveat_arr, rtol, atol, solver, delta,
                  max_steps, brownian_depth, **_):
            # the tree is the seed word's (the eval solve records nothing)
            out = sde_solve(SDEWeights(*params), u0.contiguous(), seed, tspan,
                            rtol=rtol, atol=atol, solver=solver, delta=delta,
                            saveat_arr=saveat_arr, max_steps=max_steps,
                            tier=tier, brownian_depth=brownian_depth)
            return solution_from(out, saveat_arr)

        return solve

    def apply_layer(self, x, state, *, training: bool = False):
        t2 = self.tspan[1]
        # every route's forward runs at this tier: refuse it below 1e-4
        check_product_tier(self.forward_tier(x.device), self.rtol)
        draws, state = pop_draws(state)
        group, state = pop_group(state)
        if draws is None:
            if torch.compiler.is_exporting():
                raise ValueError(
                    "torch.export cannot trace a NeuralDSDE's draw from its "
                    "CPU generator: stage the call's draws in the state "
                    "(utils/export.py's export_model does)")
            draws = to_device(self.draw(state, x.shape[0], training), x)
        # on the global grid x is rows rank·B .. of the whole batch (of
        # this microbatch), whose tree the rank draws its rows of
        at = {} if group is None else {"row_offset": group.rank * x.shape[0]}
        noise = (noise_source(draws["seed"], x, **at)
                 if self.noise_dims is None
                 else noise_source(draws["seed"], x, self.noise_dims, **at))
        params = [p for _, p in self._params()[0] + self._params()[1]]
        # on the kernel route the replacements run the whole solve and
        # sweep, and the modules' dynamics are never called
        f, g = self._dynamics()
        persistent_fn, sweep_fn = (self._kernel_fns() if self.uses_kernels(x)
                                   else (None, None))
        noise_shape = (None if self.noise_dims is None
                       else (x.shape[0], self.noise_dims))
        common = dict(noise=noise, rtol=self.rtol, atol=self.atol,
                      solver=self.solver, delta=self.delta,
                      max_steps=self.max_steps, noise_shape=noise_shape,
                      group=group)
        saveat = device_saveat(self, x.device)
        mode = self.regularize if training else "none"
        if not training:
            with torch.no_grad():
                sol = sdesolve(
                    lambda u, t: f(u, t, params), lambda u, t: g(u, t, params),
                    x, self.tspan, saveat=saveat, adjoint="none",
                    persistent_fn=self._serving_fn(params, draws["seed"], x),
                    **common,
                )
            agree_counts(sol, group)
            return sol, self._new_state(state, sol, x)
        user_saveat = (saveat if saveat is not None
                       else device_scalar(t2, x).reshape(1))
        reservoir = draws.get("reservoir")
        solve_saveat = user_saveat
        if mode == "unbiased":
            t1 = draws["t1"]
            solve_saveat = torch.cat([user_saveat, t1.reshape(1)])
        if self.adjoint == "direct":
            # autograd through the eager loop on the modules (the
            # reference's direct scan takes no persistent kernel)
            sol = sdesolve(
                lambda u, t: f(u, t, params), lambda u, t: g(u, t, params),
                x, self.tspan, saveat=solve_saveat, adjoint="direct",
                reservoir=reservoir, **common,
            )
        else:
            sol = sdesolve(
                f, g, x, self.tspan, saveat=solve_saveat, adjoint="stored",
                params=params, persistent_fn=persistent_fn,
                sweep_fn=sweep_fn, reservoir=reservoir, **common,
            )
        agree_counts(sol, group)
        if mode == "none":
            return sol, self._new_state(state, sol, x)
        if mode == "unbiased":
            u1 = sol.ys[-1].detach()
            sol = dataclasses.replace(sol, ys=sol.ys[:-1], ts=user_saveat)
        else:
            u1, t1 = sol.reservoir_u.detach(), sol.reservoir_t.detach()
        reg_val = self._reg_value(u1, t1, draws["reg_noise"], x, group)
        new_state = self._new_state(state, sol, x)
        nf, ng = step_nfe(self.solver, self.noise_dims)
        new_state.update(
            nfe_drift=sol.nfe_drift + nf + 1,  # the step's, the dt probe
            nfe_diffusion=sol.nfe_diffusion + ng,
            reg_val=reg_val,
        )
        return sol, new_state

    def _reg_value(self, u1, t1, z, x, group=None):
        """``eest · dt`` of one step of the layer's solver from the fenced
        ``(u1, t1)`` with the fresh standard normals ``z`` (2, B, F), or
        (2, B, m) with matrix noise, differentiable in the parameters
        only; the modules' products (the dt probe's too) at
        ``forward_tier``, as the reference's step through its ``f`` and
        ``g``. On the global grid (``group``) the dt probe's norms and
        ``eest`` are over every rank's rows."""
        t2 = self.tspan[1]
        tier = self.forward_tier(x.device)

        def f(u, t):
            with product_tier_scope(tier):
                return self.drift(u, self.drift.init_state())[0]

        def g(u, t):
            with product_tier_scope(tier):
                gu = self.diffusion(u, self.diffusion.init_state())[0]
            if self.noise_dims is not None:
                gu = gu.reshape(u.shape + (self.noise_dims,))
            return gu

        with torch.no_grad():
            f0 = f(u1, t1)
            sc = self.atol + torch.abs(u1) * self.rtol
            d0 = internal_norm(u1 / sc, group)
            d1 = internal_norm(f0 / sc, group)
            dt = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6,
                             0.01 * d0 / torch.where(d1 == 0, 1.0, d1))
            dt = torch.minimum(dt, device_scalar(t2, x) - t1)
        sqdt = torch.sqrt(dt)
        noise_shape = None if self.noise_dims is None else tuple(z.shape[1:])
        step = sde_step(self.solver, noise_shape, self.delta, group)(
            f, g, u1, t1, dt, z[0] * sqdt, z[1] * sqdt, self.atol, self.rtol)
        return step.eest * dt

    def _new_state(self, state, sol: SDESolution, x) -> dict:
        new_state = dict(state)
        new_state.update(
            nfe_drift=sol.nfe_drift, nfe_diffusion=sol.nfe_diffusion,
            reg_val=torch.zeros((), device=x.device), success=sol.success,
        )
        return new_state
