"""The whole reverse sweep of the stored adjoint for the TD-MLP dynamics in
one CUDA launch: dense (kernel 7) or two-level (kernel 8), one source.

Counterpart of ``localregneuralde_tpu/ops/pallas/fused_solve_bwd.py``
(``persistent_stored_sweep``, ``persistent_two_level_sweep``). The kernel
(``csrc/adjoint_sweep.cu``) carries the state cotangent ``a_u`` and the FSAL
cotangent ``a_k`` through the accepted steps in reverse, recomputes each
step's k1 from its knot ``(u_j, t_j)``, injects the saveat cotangents with
the Tsit5 interpolant's weights, and accumulates the weight gradients. It
reads ``naccept`` on the device. In two-level mode a solve longer than
``dense_cap`` is replayed one W-step window at a time from its checkpoint
with the forward kernel's own attempt code, so the replay repeats the
forward bitwise, and each window is swept after its replay.

The sweep runs on thread-block clusters (``sweep_plan``): a cluster of
``SWEEP_CLUSTER`` CTAs owns ``SWEEP_ROWS`` batch rows, and each CTA a slice
of the features, with its slices of the weights and of their gradients in
shared memory for the whole launch (a TD-MLP too wide for both adds its
gradients into its cluster's partial in global memory).

Returns ``(a_u, a_k, d_w)``: the state cotangent at t0, the cotangent on
k1_0 (the caller closes it through the VJP of f(u0, t0)), and the weight
gradients as ``TDMLPWeights``. The plain versions are the eager sweeps of
``ode/stored_adjoint.py`` with the plain step and its autograd VJP; a
replay repeats the plain forward (``persistent_tsit5_solve_plain``) there.

Kernel 9 (``persistent_chain_sweep``, ``csrc/chain_sweep.cu``) is the same
sweep, dense and two-level, for the autonomous Dense chain of the latent
ODE, a warp a row; its two-level replay runs kernel 5's attempt code. It
returns the gradients of the chain's ``[W_0, b_0, ...]``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ...ode.step import tsit5_step
from ...ode.stored_adjoint import autograd_step_vjp, eager_sweep
from . import _build
from .fused_mlp import TDMLPWeights, check_operands, tdmlp_plain
from .fused_mlp_bwd import (
    fused_step_bwd_plain,
    split_weight_grad,
    weight_grad_size,
)
from .fused_solve import (
    CLUSTER_CTAS,
    CLUSTER_SMEM_BYTES,
    DenseChainSpec,
    chain_eval,
    chain_limits,
    chain_operands,
    chain_param_sizes,
    check_chain_operands,
    plain_step,
    round4,
    vec_ld,
)


# csrc/sweep_cluster.cuh: CTAs per cluster and batch rows per cluster
SWEEP_CLUSTER = CLUSTER_CTAS
SWEEP_ROWS = 36
# csrc/tdmlp.cuh: the replay's row blocking, K split and CTA size
_REPLAY_ROWS, _REPLAY_SPLIT, _THREADS = 8, 16, 1024
# shared memory a CTA can have on an H100 (227 KB), less the kernel's static
# shared memory (the slot-sum buffer, the step weights and the replay's
# controller: under 2.5 KB); csrc/sweep_cluster.cuh::kSweepSmemLimit
SWEEP_SMEM_BYTES = CLUSTER_SMEM_BYTES


class SweepPlan(NamedTuple):
    """The cluster layout of kernels 7 and 8 at (B, F, H), as the CUDA code
    computes it (``csrc/sweep_cluster.cuh``, ``csrc/adjoint_sweep.cu``)."""

    cluster: int            # CTAs per cluster
    rows: int               # batch rows per cluster (a row block)
    row_blocks: tuple       # (row0, nrows) of each row block
    slices: tuple           # (f0, n) of each CTA rank's feature slice
    smem_bytes: int         # dynamic shared memory of a CTA
    scratch_floats: int     # global scratch
    max_partials: int       # clusters at most, one gradient partial each
    grads_shared: bool      # gradient slices in shared memory (else the
                            # CTAs add into their cluster's partial)


def sweep_plan(B: int, F: int, H: int) -> SweepPlan:
    """The cluster plan of the sweep: row blocks of ``SWEEP_ROWS`` rows,
    feature slices of ceil(F / ``SWEEP_CLUSTER``) (the last ones shorter or
    empty), and the shared memory of a CTA: its gradient slices where they
    fit (at F = 784 up to H = 102), then the larger of its weight slices
    with the four work tiles and the window replay's shared memory, which
    lies over them between windows."""
    C, R = SWEEP_CLUSTER, SWEEP_ROWS
    S = -(-F // C)
    ldS, ldW = vec_ld(S), vec_ld(H)
    slices = tuple((min(F, c * S), min(F, (c + 1) * S) - min(F, c * S))
                   for c in range(C))
    row_blocks = tuple((r0, min(R, B - r0)) for r0 in range(0, B, R))
    # the weight slices and the gradient slices have one shape
    slice_floats = S * ldW + (H + 1) * ldS + round4(S) + 2 * round4(H)
    inbox, hrow = C * (-(-(R * H) // C)), R * ldW
    tiles = 2 * R * ldS + round4(max(inbox, hrow)) + hrow
    replay = (F * _REPLAY_ROWS + _REPLAY_SPLIT * H * _REPLAY_ROWS
              + H * _REPLAY_ROWS + _THREADS)
    work = max(slice_floats + tiles, replay)
    shared = 4 * (slice_floats + work) <= SWEEP_SMEM_BYTES
    smem = 4 * ((slice_floats if shared else 0) + work)
    return SweepPlan(C, R, row_blocks, slices, smem,
                     21 * B * F + 6 * B * H, len(row_blocks), shared)


def sweep_layout(B: int, F: int, H: int, name: str):
    """``sweep_plan`` at (B, F, H) for the transposed step's kernels (3, 7
    and 8) and the library, raising where a CTA's shared memory cannot hold
    the plan (before the library loads) or the library lays it out another
    way. Returns (library, plan)."""
    plan = sweep_plan(B, F, H)
    if plan.smem_bytes > SWEEP_SMEM_BYTES:
        raise ValueError(
            f"{name}: (F, H) = ({F}, {H}) needs {plan.smem_bytes} bytes of "
            f"shared memory a CTA, over {SWEEP_SMEM_BYTES}")
    lib = _build.load_library()
    if (lib.lrnde_sweep_cluster(), lib.lrnde_sweep_rows(),
            lib.lrnde_sweep_smem_floats(F, H) * 4,
            lib.lrnde_sweep_scratch_floats(B, F, H)) != (
            plan.cluster, plan.rows, plan.smem_bytes, plan.scratch_floats):
        raise RuntimeError(f"{name}: the library's layout differs from "
                           f"sweep_plan")
    return lib, plan


def _plain_sweep(w: TDMLPWeights, knots, naccept, saveat_arr, ct_ys, ct_y,
                 **two_level):
    def step(params, u, t, dt, k1):
        return plain_step(TDMLPWeights(*params))(None, u, t, dt, k1, None)

    def step_vjp(params, u, t, dt, k1, d_unew, d_ks):
        zero = torch.zeros_like(u)
        d_w, d_u, d_k1 = fused_step_bwd_plain(
            TDMLPWeights(*params), u, t, dt, k1, (d_unew, zero, *d_ks, zero)
        )
        return list(d_w), d_u, d_k1

    a_u, a_k, a_p = eager_sweep(
        step, step_vjp, list(w), knots, naccept, saveat_arr, ct_ys, ct_y,
        two_level=bool(two_level),
        t_end=torch.full((), float(two_level.get("t_end", 1.0)),
                         device=ct_y.device),
        rtol=two_level.get("rtol"), atol=two_level.get("atol"),
        max_steps=two_level.get("max_steps"), stride=two_level.get("stride"),
        dense_cap=two_level.get("dense_cap"),
        k1_of=lambda us, ts, ks, j: tdmlp_plain(w, us[j], ts[j]),
    )
    return a_u, a_k, TDMLPWeights(*a_p)


def persistent_stored_sweep_plain(w, knot_ts, knot_us, naccept, saveat_arr,
                                  ct_ys, ct_y):
    """Plain version of the dense sweep."""
    knots = dict(knot_ts=knot_ts, knot_us=knot_us)
    return _plain_sweep(w, knots, naccept, saveat_arr, ct_ys, ct_y)


def persistent_two_level_sweep_plain(w, knot_ts, knot_us, naccept,
                                     saveat_arr, ct_ys, ct_y, ckpt_ts,
                                     ckpt_us, ckpt_ks, ckpt_dts, ckpt_qolds,
                                     *, t_end, rtol, atol, max_steps, stride,
                                     dense_cap):
    """Plain version of the two-level sweep."""
    knots = dict(knot_ts=knot_ts, knot_us=knot_us, ckpt_ts=ckpt_ts,
                 ckpt_us=ckpt_us, ckpt_ks=ckpt_ks, ckpt_dts=ckpt_dts,
                 ckpt_qolds=ckpt_qolds)
    return _plain_sweep(w, knots, naccept, saveat_arr, ct_ys, ct_y,
                        t_end=t_end, rtol=rtol, atol=atol,
                        max_steps=max_steps, stride=stride,
                        dense_cap=dense_cap)


def _launch(w, knot_ts, knot_us, naccept, saveat_arr, ct_ys, ct_y, tl=None,
            return_replay=False, timing=None):
    """One launch of kernel 7 or 8 (two-level with ``tl``); with ``timing``
    (int64, ``lrnde_sweep_phases() + 1``) the instantiation with the
    compile-time clock, which fills it with CTA 0's nanoseconds per phase
    and the number of steps."""
    ct_ys, ct_y = ct_ys.contiguous(), ct_y.contiguous()
    if not knot_us.is_contiguous():
        raise ValueError("knot_us: needs a contiguous buffer")
    B, F, H = check_operands(w, ct_y, *ct_ys, *knot_us[:1])
    dev = ct_y.device
    lib, plan = sweep_layout(B, F, H, "adjoint_sweep")
    # the window replay's row blocks (slots) are the forward's
    n_blocks = -(-B // lib.lrnde_rows_per_block())
    two_level = tl is not None
    stride = int(tl["stride"]) if two_level else 1
    saveat = saveat_arr.to(device=dev, dtype=torch.float32).contiguous()
    knot_ts = knot_ts.contiguous()
    naccept = naccept.to(device=dev, dtype=torch.int32).reshape(1)
    a_u, a_k = torch.empty_like(ct_y), torch.empty_like(ct_y)
    d_w = torch.empty(weight_grad_size(F, H), device=dev)
    scratch = torch.empty(plan.scratch_floats, device=dev)
    part = torch.empty((plan.max_partials, weight_grad_size(F, H)),
                       device=dev)
    p = _build.ptr
    null = ctypes.c_void_p(0)
    if two_level:
        slots = torch.empty(2 * n_blocks, device=dev)
        barrier = torch.zeros(1, dtype=torch.int32, device=dev)
        local_ts = torch.empty(plan.max_partials * plan.cluster * (stride + 1),
                               device=dev)
        local_us = torch.empty((stride + 1, B, F), device=dev)
        ckpts = [tl[k].contiguous() for k in
                 ("ckpt_ts", "ckpt_us", "ckpt_ks", "ckpt_dts", "ckpt_qolds")]
        ck = [p(c) for c in ckpts]
        extra = [p(slots), p(barrier), p(local_ts), p(local_us)]
        t_end, rtol, atol = float(tl["t_end"]), float(tl["rtol"]), float(tl["atol"])
        max_steps, dense_cap = int(tl["max_steps"]), int(tl["dense_cap"])
    else:
        ck, extra = [null] * 5, [null] * 4
        t_end = rtol = atol = 0.0
        max_steps = dense_cap = 0
    entry = lib.lrnde_adjoint_sweep
    clock = []
    if timing is not None:
        entry, clock = lib.lrnde_adjoint_sweep_timed, [p(timing)]
    err = entry(
        int(two_level), *[p(x) for x in w], p(knot_ts),
        p(knot_us), p(naccept), p(saveat), saveat.shape[0],
        p(ct_ys), p(ct_y), *ck, t_end, rtol, atol, max_steps,
        stride, dense_cap, p(a_u), p(a_k), p(d_w), p(scratch), p(part),
        *extra, B, F, H, 1.0 / float(B * F), *clock, _build.stream_ptr(dev),
    )
    _build.check(lib, err, "adjoint_sweep")
    out = a_u, a_k, split_weight_grad(d_w, F, H)
    return (out, local_us) if return_replay else out


def persistent_stored_sweep(w: TDMLPWeights, knot_ts, knot_us, naccept,
                            saveat_arr, ct_ys, ct_y):
    """The dense sweep over ``naccept`` recorded steps (kernel 7) for CUDA
    tensors; ``persistent_stored_sweep_plain`` for CPU tensors."""
    if ct_y.device.type == "cpu":
        return persistent_stored_sweep_plain(
            w, knot_ts, knot_us, naccept, saveat_arr, ct_ys, ct_y)
    out = _launch(w, knot_ts, knot_us, naccept, saveat_arr, ct_ys, ct_y)
    persistent_stored_sweep.launches += 1
    return out


persistent_stored_sweep.launches = 0


def persistent_two_level_sweep(w: TDMLPWeights, knot_ts, knot_us, naccept,
                               saveat_arr, ct_ys, ct_y, ckpt_ts, ckpt_us,
                               ckpt_ks, ckpt_dts, ckpt_qolds, *, t_end, rtol,
                               atol, max_steps, stride, dense_cap,
                               return_replay=False):
    """The two-level sweep (kernel 8): dense when ``naccept <= dense_cap``,
    windowed replay from the checkpoints otherwise, chosen on the device.
    Valid only against a persistent forward of the same device kind, whose
    arithmetic the replay repeats. ``persistent_two_level_sweep_plain`` for
    CPU tensors. With ``return_replay`` (CUDA only) it also returns the
    replay buffer (stride + 1, B, F), which after a windowed sweep holds the
    states replayed from checkpoint 0."""
    tl = dict(ckpt_ts=ckpt_ts, ckpt_us=ckpt_us, ckpt_ks=ckpt_ks,
              ckpt_dts=ckpt_dts, ckpt_qolds=ckpt_qolds, t_end=t_end,
              rtol=rtol, atol=atol, max_steps=max_steps, stride=stride,
              dense_cap=dense_cap)
    if ct_y.device.type == "cpu":
        return persistent_two_level_sweep_plain(
            w, knot_ts, knot_us, naccept, saveat_arr, ct_ys, ct_y, ckpt_ts,
            ckpt_us, ckpt_ks, ckpt_dts, ckpt_qolds, t_end=t_end, rtol=rtol,
            atol=atol, max_steps=max_steps, stride=stride,
            dense_cap=dense_cap)
    out = _launch(w, knot_ts, knot_us, naccept, saveat_arr, ct_ys, ct_y, tl,
                  return_replay)
    persistent_two_level_sweep.launches += 1
    return out


persistent_two_level_sweep.launches = 0


# ---------------------------------------------------------------------------
# kernel 9: the sweep of the autonomous Dense chain

def chain_sweep_feasible(chain: DenseChainSpec, n_save: int, device) -> bool:
    """Whether kernels 5 and 9 take this chain and saveat count on
    ``device`` (``chain_limits``; on the CPU, where the plain versions run,
    without the shared-memory plan): the recorded forward declines when the
    sweep cannot run, as the reference's ``chain_sweep_feasible`` makes
    it."""
    return chain_limits(chain, n_save,
                        cuda=torch.device(device).type != "cpu") is None


def persistent_chain_sweep_plain(params, chain: DenseChainSpec, knot_ts,
                                 knot_us, naccept, saveat_arr, ct_ys, ct_y, *,
                                 two_level_ctx=None):
    """Plain version of kernel 9: the eager sweep of
    ``ode/stored_adjoint.py`` with the generic Tsit5 step of the plain chain
    and its autograd VJP, k1 recomputed from each knot; two-level when
    ``two_level_ctx`` is given (the replay repeats the plain forward)."""

    def step(ps, u, t, dt, k1):
        return tsit5_step(lambda u_, t_, st: (chain_eval(ps, chain, u_), st),
                          u, t, dt, k1, None)

    c = two_level_ctx or {}
    knots = dict(knot_ts=knot_ts, knot_us=knot_us,
                 **{k: c[k] for k in c if k.startswith("ckpt_")})
    return eager_sweep(
        step, autograd_step_vjp(step), list(params), knots, naccept,
        saveat_arr, ct_ys, ct_y, two_level=bool(c),
        t_end=torch.full((), float(c.get("t_end", 1.0)), device=ct_y.device),
        rtol=c.get("rtol"), atol=c.get("atol"), max_steps=c.get("max_steps"),
        stride=c.get("stride"), dense_cap=c.get("dense_cap"),
        k1_of=lambda us, ts, ks, j: chain_eval(params, chain, us[j]),
    )


def persistent_chain_sweep(params, chain: DenseChainSpec, knot_ts, knot_us,
                           naccept, saveat_arr, ct_ys, ct_y, *,
                           two_level_ctx=None, return_replay=False):
    """The stored-adjoint sweep of the chain (kernel 9), dense and two-level
    in one entry point as in the reference (``fused_solve_bwd.py:850``):
    without ``two_level_ctx`` (or with ``naccept <= dense_cap``, decided on
    the device) it sweeps the dense knots; otherwise it replays each window
    from its checkpoint with kernel 5's attempt code, which repeats a kernel-5
    forward bitwise. ``two_level_ctx`` holds ``ckpt_ts``, ``ckpt_us``,
    ``ckpt_ks``, ``ckpt_dts``, ``ckpt_qolds``, ``t_end``, ``rtol``,
    ``atol``, ``max_steps``, ``stride`` and ``dense_cap``.

    Returns ``(a_u, a_k, d_params)``: the state cotangent at t0, the
    cotangent on k1_0 and the gradients of ``[W_0, b_0, ...]``. With
    ``return_replay`` (CUDA only) it also returns the replay buffer (stride
    + 1, B, F), which after a windowed sweep holds the states replayed from
    checkpoint 0. A CPU tensor runs ``persistent_chain_sweep_plain``.

    Limits (``chain_limits``; it raises outside them): those of
    ``persistent_chain_solve``, at most ``CHAIN_MAX_SAVE`` saveat times, and
    the backward's shared memory (the weights and their transpose, the
    gradient partial and every stage's activations and layer cotangents of
    a 4-row block; 137 KB for the PhysioNet chain) within
    ``CHAIN_SMEM_BYTES``.
    """
    if ct_y.device.type == "cpu":
        return persistent_chain_sweep_plain(
            params, chain, knot_ts, knot_us, naccept, saveat_arr, ct_ys, ct_y,
            two_level_ctx=two_level_ctx)
    a_u, a_k, grads, local_us = _launch_chain_sweep(
        params, chain, knot_ts, knot_us, naccept, saveat_arr, ct_ys, ct_y,
        two_level_ctx=two_level_ctx)
    persistent_chain_sweep.launches += 1
    out = a_u, a_k, grads
    return (out, local_us) if return_replay else out


def _launch_chain_sweep(params, chain, knot_ts, knot_us, naccept, saveat_arr,
                        ct_ys, ct_y, *, two_level_ctx=None, timing=None):
    """One launch of kernel 9 on CUDA tensors: ``(a_u, a_k, grads,
    local_us)``; with ``timing`` (int64, one entry a phase of
    ``lrnde_chain_sweep_phase_names`` and one more) the instantiation with
    the compile-time clock, which fills it with CTA 0's nanoseconds per
    phase and the number of steps."""
    ct_ys, ct_y = ct_ys.contiguous(), ct_y.contiguous()
    if not knot_us.is_contiguous():
        raise ValueError("knot_us: needs a contiguous buffer")
    n_save = ct_ys.shape[0]
    B, F = check_chain_operands(params, chain, ct_y, *ct_ys, *knot_us[:1],
                                n_save=n_save)
    dev = ct_y.device
    lib = _build.load_library()
    chain_args = chain_operands(params, chain)
    tl = two_level_ctx
    grid = _chain_sweep_grid(lib, chain, B, tl is not None)
    n_blocks = -(-B // lib.lrnde_chain_error_rows())
    sizes = chain_param_sizes(chain)
    n_params = sum(math.prod(s) for s in sizes)
    saveat = saveat_arr.to(device=dev, dtype=torch.float32).contiguous()
    naccept = naccept.to(device=dev, dtype=torch.int32).reshape(1)
    a_u, a_k = torch.empty_like(ct_y), torch.empty_like(ct_y)
    d_w = torch.empty(n_params, device=dev)
    part = torch.empty((grid, n_params), device=dev)
    p = _build.ptr
    null = ctypes.c_void_p(0)
    if tl is not None:
        stride = int(tl["stride"])
        slots = torch.empty(2 * n_blocks, device=dev)
        barrier = torch.zeros(1, dtype=torch.int32, device=dev)
        local_ts = torch.empty(grid * (stride + 1), device=dev)
        local_us = torch.empty((stride + 1, B, F), device=dev)
        ckpts = [tl[k].contiguous() for k in
                 ("ckpt_ts", "ckpt_us", "ckpt_ks", "ckpt_dts", "ckpt_qolds")]
        ck = [p(c) for c in ckpts]
        extra = [p(part), p(slots), p(barrier), p(local_ts), p(local_us)]
        scalars = (float(tl["t_end"]), float(tl["rtol"]), float(tl["atol"]),
                   int(tl["max_steps"]), stride, int(tl["dense_cap"]))
    else:
        local_us = None
        ck = [null] * 5
        extra = [p(part), null, null, null, null]
        scalars = (0.0, 0.0, 0.0, 0, 1, 0)
    entry, clock = lib.lrnde_chain_sweep, []
    if timing is not None:
        entry, clock = lib.lrnde_chain_sweep_timed, [p(timing)]
    err = entry(
        int(tl is not None), *chain_args, p(knot_ts.contiguous()),
        p(knot_us), p(naccept), p(saveat), n_save, p(ct_ys), p(ct_y), *ck,
        *scalars, p(a_u), p(a_k), p(d_w), *extra, B, 1.0 / float(B * F),
        *clock, _build.stream_ptr(dev),
    )
    _build.check(lib, err, "persistent_chain_sweep")
    grads, off = [], 0
    for s in sizes:
        n = math.prod(s)
        grads.append(d_w[off:off + n].view(s))
        off += n
    return a_u, a_k, grads, local_us


def _chain_sweep_grid(lib, chain: DenseChainSpec, B: int,
                      two_level: bool) -> int:
    """Kernel 9's CTAs at B rows (one gradient partial each), from the
    library's plan (``lrnde_chain_sweep_grid``)."""
    L = len(chain.dims) - 1
    dims = (ctypes.c_int * (L + 1))(*chain.dims)
    out = (ctypes.c_int * 2)()
    err = lib.lrnde_chain_sweep_grid(ctypes.cast(dims, ctypes.c_void_p), L,
                                     B, int(two_level),
                                     ctypes.cast(out, ctypes.c_void_p))
    _build.check(lib, err, "persistent_chain_sweep: the grid")
    return out[1]


persistent_chain_sweep.launches = 0
