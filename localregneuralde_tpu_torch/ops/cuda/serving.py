"""The serving solves as registered PyTorch operators.

Kernel 4 with its start (k1 and the Hairer probe through kernel 1),
kernel 5 with its start (through the plain chain), kernel 10 and kernel 6
are each one operator of the ``lrnde`` namespace
(``torch.library.custom_op``), so that ``torch.export`` records a solve as
one opaque node: their adaptive loops accept steps on the device, inside
the kernel, and neither the eager loop's host reads nor a layer's CPU
generator can enter an exported program. Each operator has one
implementation per device: on CUDA the kernel's launch (which raises if
the kernel does not build or launch), on the CPU the kernel's plain
version; the dispatcher picks by the inputs' device, so a CUDA input never
reaches a plain version. The precision tier is resolved before the call
and passed in, so an exported model runs the tier its live model runs. A
fake implementation gives the outputs' shapes and dtypes from the inputs'
shapes alone.

The conv family has a step kernel (13) and no whole solve: its eval solve,
``lrnde::conv_solve``, is the eager loop itself inside one operator (k1
and the Hairer probe through the plain dynamics, every attempt kernel 13
through ``fused_conv_step``, the accept read on the host), so that the
program records it as one node and runs, when called, the loop the live
model runs. ``fused_conv_step`` launches the kernel on CUDA tensors and
runs its plain version on CPU tensors.

The wrappers ``persistent_tsit5_solve`` and ``persistent_chain_solve``
(without knots or reservoir) and ``persistent_pf_solve``, and the eval
routes of the NeuralDSDE and of the conv family's NeuralODE, call these; a
program exported from them loads after ``import
localregneuralde_tpu_torch.ops.cuda.serving``, which registers the
operators (``utils/export.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor
from torch.library import custom_op

from ...ode.solve import loop_solve
from ...ode.step import Tsit5StepResult
from ...sde.brownian import PhiloxNormals
from .fused_conv import (
    ConvFamilySpec,
    ConvWeights,
    conv_dynamics_plain,
    fused_conv_step,
)
from .fused_mlp import TDMLPWeights, count_launch
from .fused_sde_solve import (
    SDEWeights,
    ScoreChainSpec,
    _launch_sde_solve,
    persistent_sde_solve,
    persistent_sde_solve_plain,
)
from .fused_solve import (
    DenseChainSpec,
    _launch_chain,
    _launch_pf,
    _launch_solve,
    persistent_chain_solve,
    persistent_chain_solve_plain,
    persistent_pf_solve,
    persistent_pf_solve_plain,
    persistent_tsit5_solve,
    persistent_tsit5_solve_plain,
)

# the operators' outputs, in order: ``stats`` is the kernel's int32
# counters (naccept, nreject, success, attempts), sliced outside the
# operator, so that a launch's buffers are returned as they are
ODE_OUTPUTS = ("y_final", "ys", "stats", "success", "nfe", "t_final")
SDE_OUTPUTS = ("y_final", "ys", "stats", "success", "t_final")
_DTYPES = dict(stats=torch.int32, success=torch.bool, nfe=torch.int32,
               t_final=torch.float32)
_STATS = ("naccept", "nreject", "success", "natt")

ODEOut = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]
SDEOut = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]


def noise_source(seed: Tensor, u0: Tensor) -> PhiloxNormals:
    """The normals of the CPU solve's Brownian tree from the seed word
    ``seed``: the Philox tree kernel 10 draws from the same word. (A test
    injects another tree here.)"""
    return PhiloxNormals(seed, u0.shape[0], u0.shape[1], device=u0.device)


def _plain_outputs(out: dict, names, inputs) -> tuple:
    """A plain version's dict as the operator's outputs, at the fake
    implementation's dtypes, none sharing storage with an input or with
    another output (the eager loop can hand back an input or a view)."""
    seen = {t.untyped_storage().data_ptr() for t in inputs
            if isinstance(t, Tensor)}
    vals = dict(out, stats=torch.stack([
        torch.as_tensor(out[k]).reshape(()).to(torch.int32) for k in _STATS]))
    res = []
    for name in names:
        t = torch.as_tensor(vals[name]).to(_DTYPES.get(name, torch.float32))
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen:
            t = t.clone()
            ptr = t.untyped_storage().data_ptr()
        seen.add(ptr)
        res.append(t)
    return tuple(res)


def _fake_outputs(u0: Tensor, saveat: Tensor, names) -> tuple:
    shape = tuple(u0.shape)
    shapes = dict(y_final=shape, ys=(saveat.shape[0],) + shape, stats=(4,))
    return tuple(u0.new_empty(shapes.get(n, ()), dtype=_DTYPES.get(
        n, torch.float32)) for n in names)


def _solve_dict(res, names, saveat_arr: Tensor, *counters) -> dict:
    """An operator's outputs as the wrappers' return dict, with the
    ``counters`` of ``_STATS`` sliced from ``stats``."""
    out = dict(zip(names, res), ts=saveat_arr)
    stats = out.pop("stats")
    out.update({k: stats[_STATS.index(k)] for k in counters})
    return out


# ---------------------------------------------------------------------------
# kernel 4 and its start


@custom_op("lrnde::tsit5_solve", mutates_args=(), device_types="cpu")
def _tsit5_op(w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, u0: Tensor,
              saveat: Tensor, t0: float, t_end: float, rtol: float,
              atol: float, max_steps: int, tier: str) -> ODEOut:
    out = persistent_tsit5_solve_plain(
        TDMLPWeights(w1, b1, w2, b2), u0, (t0, t_end), rtol=rtol, atol=atol,
        saveat_arr=saveat, max_steps=max_steps, tier=tier)
    return _plain_outputs(out, ODE_OUTPUTS, (w1, b1, w2, b2, u0, saveat))


@_tsit5_op.register_kernel("cuda")
def _(w1, b1, w2, b2, u0, saveat, t0, t_end, rtol, atol, max_steps, tier):
    out = _launch_solve(TDMLPWeights(w1, b1, w2, b2), u0, (t0, t_end),
                        rtol=rtol, atol=atol, saveat_arr=saveat,
                        max_steps=max_steps, tier=tier)
    count_launch(persistent_tsit5_solve, tier)
    return tuple(out[n] for n in ODE_OUTPUTS)


@_tsit5_op.register_fake
def _(w1, b1, w2, b2, u0, saveat, t0, t_end, rtol, atol, max_steps, tier):
    return _fake_outputs(u0, saveat, ODE_OUTPUTS)


def tsit5_solve(w: TDMLPWeights, u0: Tensor, tspan, *, rtol: float,
                atol: float, saveat_arr: Tensor, max_steps: int,
                tier: str) -> dict:
    """Kernel 4's serving solve at the resolved ``tier`` through
    ``lrnde::tsit5_solve``: the return dict of ``persistent_tsit5_solve``
    without knots or reservoir."""
    res = _tsit5_op(*w, u0, saveat_arr, float(tspan[0]), float(tspan[1]),
                    float(rtol), float(atol), int(max_steps), tier)
    return _solve_dict(res, ODE_OUTPUTS, saveat_arr, "naccept", "nreject")


# ---------------------------------------------------------------------------
# kernel 10


@custom_op("lrnde::sde_solve", mutates_args=(), device_types="cpu")
def _sde_op(w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, wd: Tensor,
            bd: Tensor, u0: Tensor, seed: Tensor, saveat: Tensor, t0: float,
            t_end: float, rtol: float, atol: float, delta: float, solver: str,
            max_steps: int, brownian_depth: int, tier: str) -> SDEOut:
    out = persistent_sde_solve_plain(
        SDEWeights(w1, b1, w2, b2, wd, bd), u0, (t0, t_end),
        noise=noise_source(seed, u0), rtol=rtol, atol=atol, solver=solver,
        delta=delta, saveat_arr=saveat, max_steps=max_steps,
        brownian_depth=brownian_depth, tier=tier)
    return _plain_outputs(out, SDE_OUTPUTS, (w1, b1, w2, b2, wd, bd, u0,
                                             seed, saveat))


@_sde_op.register_kernel("cuda")
def _(w1, b1, w2, b2, wd, bd, u0, seed, saveat, t0, t_end, rtol, atol, delta,
      solver, max_steps, brownian_depth, tier):
    out = _launch_sde_solve(
        SDEWeights(w1, b1, w2, b2, wd, bd), u0,
        seed.reshape(1).to(device=u0.device, dtype=torch.int32), (t0, t_end),
        rtol=rtol, atol=atol, solver=solver, delta=delta, saveat_arr=saveat,
        max_steps=max_steps, brownian_depth=brownian_depth, tier=tier)
    count_launch(persistent_sde_solve, tier)
    return tuple(out[n] for n in SDE_OUTPUTS)


@_sde_op.register_fake
def _(w1, b1, w2, b2, wd, bd, u0, seed, saveat, t0, t_end, rtol, atol, delta,
      solver, max_steps, brownian_depth, tier):
    return _fake_outputs(u0, saveat, SDE_OUTPUTS)


def sde_solve(w: SDEWeights, u0: Tensor, seed: Tensor, tspan, *, rtol: float,
              atol: float, solver: str, delta: float, saveat_arr: Tensor,
              max_steps: int, tier: str, brownian_depth: int = 24) -> dict:
    """Kernel 10's serving solve from the tree's seed word ``seed`` (the
    one-element int32 tensor a layer's draw stages) at the resolved
    ``tier`` through ``lrnde::sde_solve``: the return dict of
    ``persistent_sde_solve`` without knots or reservoir."""
    res = _sde_op(*w, u0, seed, saveat_arr, float(tspan[0]), float(tspan[1]),
                  float(rtol), float(atol), float(delta), solver,
                  int(max_steps), int(brownian_depth), tier)
    return _solve_dict(res, SDE_OUTPUTS, saveat_arr, "naccept", "nreject",
                       "natt")


# ---------------------------------------------------------------------------
# kernel 6


def _score_spec(dims, acts) -> ScoreChainSpec:
    return ScoreChainSpec(tuple(dims), tuple(acts),
                          tuple(str(i) for i in range(len(acts))))


@custom_op("lrnde::pf_solve", mutates_args=(), device_types="cpu")
def _pf_op(params: list[Tensor], u0: Tensor, saveat: Tensor, dims: list[int],
           acts: list[bool], t0: float, t_end: float, rtol: float,
           atol: float, max_steps: int, beta_min: float, beta_max: float,
           t1: float, tier: str) -> ODEOut:
    out = persistent_pf_solve_plain(
        params, _score_spec(dims, acts), u0, (t0, t_end), rtol=rtol,
        atol=atol, saveat_arr=saveat, max_steps=max_steps, beta_min=beta_min,
        beta_max=beta_max, t1=t1, tier=tier)
    return _plain_outputs(out, ODE_OUTPUTS, (*params, u0, saveat))


@_pf_op.register_kernel("cuda")
def _(params, u0, saveat, dims, acts, t0, t_end, rtol, atol, max_steps,
      beta_min, beta_max, t1, tier):
    out = _launch_pf(params, _score_spec(dims, acts), u0, (t0, t_end),
                     rtol=rtol, atol=atol, saveat_arr=saveat,
                     max_steps=max_steps, beta_min=beta_min,
                     beta_max=beta_max, t1=t1, tier=tier)
    count_launch(persistent_pf_solve, tier)
    return tuple(out[n] for n in ODE_OUTPUTS)


@_pf_op.register_fake
def _(params, u0, saveat, dims, acts, t0, t_end, rtol, atol, max_steps,
      beta_min, beta_max, t1, tier):
    return _fake_outputs(u0, saveat, ODE_OUTPUTS)


def pf_solve(params, chain: ScoreChainSpec, u0: Tensor, tspan, *,
             rtol: float, atol: float, saveat_arr: Tensor, max_steps: int,
             beta_min: float, beta_max: float, t1: float, tier: str) -> dict:
    """Kernel 6's solve at the resolved ``tier`` through ``lrnde::pf_solve``:
    the return dict of ``persistent_pf_solve``."""
    res = _pf_op(list(params), u0, saveat_arr, list(chain.dims),
                 list(chain.acts), float(tspan[0]), float(tspan[1]),
                 float(rtol), float(atol), int(max_steps), float(beta_min),
                 float(beta_max), float(t1), tier)
    return _solve_dict(res, ODE_OUTPUTS, saveat_arr, "naccept", "nreject")


# ---------------------------------------------------------------------------
# kernel 5


@custom_op("lrnde::chain_solve", mutates_args=(), device_types="cpu")
def _chain_op(params: list[Tensor], dims: list[int], acts: list[bool],
              lead: bool, u0: Tensor, saveat: Tensor, t0: float, t_end: float,
              rtol: float, atol: float, max_steps: int, tier: str) -> ODEOut:
    out = persistent_chain_solve_plain(
        params, DenseChainSpec(tuple(dims), tuple(acts), lead), u0,
        (t0, t_end), rtol=rtol, atol=atol, saveat_arr=saveat,
        max_steps=max_steps, tier=tier)
    return _plain_outputs(out, ODE_OUTPUTS, (*params, u0, saveat))


@_chain_op.register_kernel("cuda")
def _(params, dims, acts, lead, u0, saveat, t0, t_end, rtol, atol, max_steps,
      tier):
    out = _launch_chain(params, DenseChainSpec(tuple(dims), tuple(acts), lead),
                        u0, (t0, t_end), rtol=rtol, atol=atol,
                        saveat_arr=saveat, max_steps=max_steps, tier=tier)
    count_launch(persistent_chain_solve, tier)
    return tuple(out[n] for n in ODE_OUTPUTS)


@_chain_op.register_fake
def _(params, dims, acts, lead, u0, saveat, t0, t_end, rtol, atol, max_steps,
      tier):
    return _fake_outputs(u0, saveat, ODE_OUTPUTS)


def chain_solve(params, chain: DenseChainSpec, u0: Tensor, tspan, *,
                rtol: float, atol: float, saveat_arr: Tensor, max_steps: int,
                tier: str) -> dict:
    """Kernel 5's solve at the resolved ``tier`` through
    ``lrnde::chain_solve``: the return dict of ``persistent_chain_solve``
    without knots or reservoir."""
    res = _chain_op(list(params), list(chain.dims), list(chain.acts),
                    bool(chain.lead), u0, saveat_arr, float(tspan[0]),
                    float(tspan[1]), float(rtol), float(atol), int(max_steps),
                    tier)
    return _solve_dict(res, ODE_OUTPUTS, saveat_arr, "naccept", "nreject")


# ---------------------------------------------------------------------------
# the conv family's eval solve, kernel 13 on every attempt


@custom_op("lrnde::conv_solve", mutates_args=(), device_types=("cpu", "cuda"))
def _conv_op(weights: list[Tensor], rstats: list[Tensor], u0: Tensor,
             saveat: Tensor, Cs: int, Ch: int, momentum: float, eps: float,
             eval_stats: str, t0: float, t_end: float, rtol: float,
             atol: float, max_steps: int, tier: str) -> ODEOut:
    """The eager loop (``ode/solve.py::loop_solve``) with k1 and the Hairer
    dt probe from the plain dynamics and every attempt through
    ``fused_conv_step`` (kernel 13 on CUDA tensors), BatchNorm on the
    running stats ``rstats`` or, under ``eval_stats='batch'``, on the
    batch's. The plain dynamics is the module's computation op for op
    (``conv_dynamics_plain``), so this is the live eval route's loop bit
    for bit."""
    w = ConvWeights(*weights)
    spec = ConvFamilySpec(Cs, Ch, momentum, eps, eval_stats, ())
    norm = None if eval_stats == "batch" else tuple(rstats)

    def f(u, t, st):
        return conv_dynamics_plain(w, spec, u, t, norm, tier)[0], st

    def step(fn, u, t, dt, k1, st):
        u_new, utilde, *ks, g6, _ = fused_conv_step(
            w, spec, u.contiguous(), t, dt, k1.contiguous(), training=False,
            rstats=rstats, tier=tier)
        return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, st)

    sol = loop_solve(f, u0, t0, t_end, saveat, f_state=None, rtol=rtol,
                     atol=atol, max_steps=max_steps, step_fn=step)
    out = dict(y_final=sol.y_final, ys=sol.ys, naccept=sol.naccept,
               nreject=sol.nreject, natt=sol.naccept + sol.nreject,
               success=sol.success, nfe=sol.nfe, t_final=sol.t_final)
    return _plain_outputs(out, ODE_OUTPUTS, (*weights, *rstats, u0, saveat))


@_conv_op.register_fake
def _(weights, rstats, u0, saveat, Cs, Ch, momentum, eps, eval_stats, t0,
      t_end, rtol, atol, max_steps, tier):
    return _fake_outputs(u0, saveat, ODE_OUTPUTS)


def conv_solve(w: ConvWeights, spec: ConvFamilySpec, rstats, u0: Tensor,
               tspan, *, rtol: float, atol: float, saveat_arr: Tensor,
               max_steps: int, tier: str) -> dict:
    """The conv family's eval solve at the resolved ``tier`` through
    ``lrnde::conv_solve``: a dict of ``y_final``, ``ys``,
    ``success``, ``nfe``, ``t_final``, ``ts``, ``naccept`` and ``nreject``,
    as the persistent solves return."""
    res = _conv_op(list(w), list(rstats), u0, saveat_arr, int(spec.Cs),
                   int(spec.Ch), float(spec.momentum), float(spec.eps),
                   spec.eval_stats, float(tspan[0]), float(tspan[1]),
                   float(rtol), float(atol), int(max_steps), tier)
    return _solve_dict(res, ODE_OUTPUTS, saveat_arr, "naccept", "nreject")
