"""The whole adaptive SRI/SOSRI solve of the NeuralDSDE family in one CUDA
launch, Brownian tree included.

Counterpart of ``localregneuralde_tpu/ops/pallas/fused_sde_solve.py``
(``persistent_sde_solve``, family ``("mlp", H)``). The family is the MNIST
SDE layer's (reference ``construct.jl:202-210``):

    drift(x)     = tanh(x·W1 + b1)·W2 + b2
    diffusion(x) = x·Wd + bd           (diagonal noise)

The kernel (``csrc/sde_solve.cu``) draws the virtual Brownian tree from the
counter-based Philox source of ``sde/brownian.py`` with the source's seed,
runs the I-controlled accept/reject loop, writes the saveat outputs by
linear interpolation on accepted steps, keeps the reservoir sample when
given uniforms, and with ``record_knots`` records the knots ``u`` and the
increments ``(dW, dZ)`` of the accepted steps into buffers of
``max_steps + 1`` and ``max_steps`` entries, which the stored adjoint's
sweep (``ops/cuda/fused_sde_sweep.py``) reads. The first dt (one drift
evaluation) is computed outside, as in the reference; NFE is drift
1 + 4·attempts, diffusion 4·attempts.

The plain version is the eager loop of ``sde/solve.py`` with the plain
family and any normal source; on a CPU tensor the wrapper runs it. On a CUDA
tensor the noise source must be ``PhiloxNormals``, whose numbers the kernel
draws itself (its uniforms bitwise, its normals to the inverse CDF's
rounding).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...sde.brownian import PhiloxNormals
from ...sde.solve import SRI_SOLVERS, initial_dt, sde_loop
from . import _build
from .fused_mlp import device_scalars
from .fused_solve import check_reservoir, reservoir_operands


class SDEWeights(NamedTuple):
    """Dense weights of the family, ``(in, out)`` layout: ``w1`` (F, H),
    ``b1`` (H), ``w2`` (H, F), ``b2`` (F), ``wd`` (F, F), ``bd`` (F)."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    wd: torch.Tensor
    bd: torch.Tensor


def drift_plain(w: SDEWeights, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ w.w1 + w.b1) @ w.w2 + w.b2


def diffusion_plain(w: SDEWeights, x: torch.Tensor) -> torch.Tensor:
    return x @ w.wd + w.bd


def check_sde_operands(w: SDEWeights, *states: torch.Tensor) -> tuple:
    """Validate kernel operands: float32, contiguous, on one CUDA device,
    states (B, F) and weights of the family at F. Returns (B, F, H)."""
    B, F = states[0].shape
    H = w.b1.shape[0]
    shapes = {"w1": (F, H), "b1": (H,), "w2": (H, F), "b2": (F,),
              "wd": (F, F), "bd": (F,)}
    for name, t in list(zip(w._fields, w)) + [("state", s) for s in states]:
        want = shapes.get(name, (B, F))
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous float32")
        if t.device != states[0].device:
            raise ValueError(f"{name}: on {t.device}, state on {states[0].device}")
    if B < 1:
        raise ValueError("empty batch")
    return B, F, H


def check_smem(lib, query: str, F: int, H: int) -> None:
    """Raise if a CTA's shared memory at (F, H) exceeds what an H100 grants
    a block (227 KB)."""
    need = getattr(lib, query)(F, H) * 4
    if need > 232448:
        raise ValueError(
            f"F={F}, H={H} needs {need} bytes of shared memory per block; "
            "the SDE kernels hold the weights in shared memory (at most "
            "227 KB)"
        )


def persistent_sde_solve_plain(w: SDEWeights, u0, tspan, *, noise, rtol, atol,
                               solver, delta, saveat_arr, max_steps,
                               record_knots=False, reservoir=None,
                               brownian_depth=24):
    """The plain version: the eager loop with the plain family."""
    t0, t_end = float(tspan[0]), float(tspan[1])
    dt_init = initial_dt(u0, drift_plain(w, u0), rtol, atol, t0, t_end)
    out = sde_loop(
        lambda x, t: drift_plain(w, x), lambda x, t: diffusion_plain(w, x),
        u0, t0, t_end, dt_init, noise=noise, saveat=saveat_arr, rtol=rtol,
        atol=atol, solver=solver, delta=delta, max_steps=max_steps,
        reservoir=reservoir, brownian_depth=brownian_depth,
        record_knots=record_knots,
    )
    return dict(out, ts=saveat_arr)


def persistent_sde_solve(w: SDEWeights, u0: torch.Tensor, tspan, *, noise,
                         rtol: float, atol: float, solver: str, delta: float,
                         saveat_arr: torch.Tensor, max_steps: int,
                         record_knots=False, reservoir=None,
                         brownian_depth=24):
    """Run the whole adaptive solve of the family from ``u0``.

    Returns a dict of device tensors (no host sync): ``y_final``, ``ys``
    (n_save, B, F), ``naccept``, ``nreject``, ``natt``, ``success``,
    ``t_final``, ``ts``, ``reservoir_t`` and ``reservoir_u`` (None without
    ``reservoir``), and with ``record_knots`` ``knot_ts`` (max_steps + 1),
    ``knot_us`` (max_steps + 1, B, F), ``knot_dws`` and ``knot_dzs``
    (max_steps, B, F), valid up to ``naccept``. A CUDA tensor launches the
    kernel; a CPU tensor runs ``persistent_sde_solve_plain``.
    """
    kw = dict(noise=noise, rtol=rtol, atol=atol, solver=solver, delta=delta,
              saveat_arr=saveat_arr, max_steps=max_steps,
              record_knots=record_knots, reservoir=reservoir,
              brownian_depth=brownian_depth)
    check_reservoir(reservoir, max_steps)
    if u0.device.type == "cpu":
        return persistent_sde_solve_plain(w, u0, tspan, **kw)
    if solver not in SRI_SOLVERS:
        raise ValueError(f"the SDE kernel runs {SRI_SOLVERS}, not {solver!r}")
    if not isinstance(noise, PhiloxNormals):
        raise ValueError(
            "the SDE kernel draws its own Philox noise: a CUDA solve takes "
            f"a PhiloxNormals source, not {type(noise).__name__}"
        )
    B, F, H = check_sde_operands(w, u0)
    if noise.shape != (B, F):
        raise ValueError(f"noise source of shape {noise.shape}, state {(B, F)}")
    lib = _build.load_library()
    check_smem(lib, "lrnde_sde_solve_smem_floats", F, H)
    t0, t_end = float(tspan[0]), float(tspan[1])
    dt_init = initial_dt(u0, drift_plain(w, u0), rtol, atol, t0, t_end)
    sc = device_scalars([t0, t_end, dt_init], u0)
    saveat = saveat_arr.to(device=u0.device, dtype=torch.float32).contiguous()
    n_save = saveat.shape[0]
    dev = u0.device
    n_blocks = -(-B // lib.lrnde_sde_rows_per_block())
    y_final = torch.empty_like(u0)
    ys = torch.empty((n_save, B, F), device=dev)
    stats_i = torch.empty(4, dtype=torch.int32, device=dev)
    stats_f = torch.empty(2, device=dev)
    unew = torch.empty_like(u0)
    wz = torch.empty((2, 2, B, F), device=dev)
    slots = torch.empty(2 * n_blocks, device=dev)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    rand, res_u = reservoir_operands(reservoir, u0)
    knots = {}
    if record_knots:
        knots = dict(
            knot_ts=torch.empty(max_steps + 1, device=dev),
            knot_us=torch.empty((max_steps + 1, B, F), device=dev),
            knot_dws=torch.empty((max_steps, B, F), device=dev),
            knot_dzs=torch.empty((max_steps, B, F), device=dev),
        )
    p = _build.ptr
    null = ctypes.c_void_p(0)
    opt = lambda t: null if t is None else p(t)  # noqa: E731
    err = lib.lrnde_sde_solve(
        int(solver == "sosri"), p(u0), p(sc), p(saveat), n_save,
        *[p(x) for x in w], noise.seed, int(brownian_depth),
        p(y_final), p(ys), p(stats_i), p(stats_f), p(unew), p(wz[0]),
        p(wz[1]), p(slots), p(barrier), opt(rand), opt(res_u),
        *[opt(knots.get(k)) for k in ("knot_ts", "knot_us", "knot_dws",
                                      "knot_dzs")],
        B, F, H, int(max_steps), float(rtol), float(atol), float(delta),
        1.0 / float(B * F), _build.stream_ptr(dev),
    )
    _build.check(lib, err, "persistent_sde_solve")
    persistent_sde_solve.launches += 1
    return dict(
        y_final=y_final, ys=ys, naccept=stats_i[0], nreject=stats_i[1],
        natt=stats_i[3], success=stats_i[2].bool(), t_final=stats_f[0],
        ts=saveat_arr,
        reservoir_t=stats_f[1] if reservoir is not None else None,
        reservoir_u=res_u, **knots,
    )


persistent_sde_solve.launches = 0
