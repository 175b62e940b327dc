"""The whole adaptive Tsit5 solve of the TD-MLP dynamics in one CUDA launch.

Counterpart of ``localregneuralde_tpu/ops/pallas/fused_solve.py``
(``persistent_tsit5_solve``, family ``("tdmlp",)``), for inference and as
the stored adjoint's forward: the accept/reject loop, PI control, the
shared-batch RMS error norm and the speculative saveat output with its
post-loop revert run in one kernel on thread-block clusters
(``csrc/persistent_solve.cu``; ``solve_plan`` sizes it): a cluster of
``CLUSTER_CTAS`` CTAs owns a block of batch rows, each CTA the features
k ≡ rank (mod 8) with its slices of the weights in shared memory, and the
kernel keeps every bit of the one-CTA-per-8-rows kernel it replaced. As
in the reference, the initial derivative k1 and the Hairer initial dt are
computed outside, through the fused dynamics kernel (2 NFE), and NFE = 2
+ 6·attempts.

With ``record_knots`` the kernel also records what the stored adjoint
sweeps (``ops/cuda/fused_solve_bwd.py``): on every accept the committed
state goes to the dense knot buffer while ``naccept < dense_cap``, and with
a stride W > 1 every W-th accept also goes to the checkpoint buffers with
``(t, dt_next, qold)``. No k1 knots are stored (the sweep recomputes k1),
and F is not padded. Recording only copies committed values, so it changes
no accept decision.

With ``reservoir`` (``max_steps`` uniforms, drawn in advance by the caller)
the kernel keeps the biased regulariser's reservoir sample: an accepted
attempt number ``natt`` takes its step start ``(t, u)`` when
``reservoir[natt]·(naccept + 1) < 1`` (``reservoir_t``, ``reservoir_u``).

Kernel 5 (``persistent_chain_solve``, ``csrc/chain_solve.cu``) is the same
solve for the autonomous Dense chain of the latent ODE (the reference's
``persistent_chain_solve``, family ``("chain", dims, acts, lead)``), with
the same recording and reservoir, a warp a row (``chain_plan`` models its
layout); its plain version is the eager loop with the plain chain
(``chain_eval``).

Kernel 6 (``persistent_pf_solve``, ``csrc/pf_solve.cu``) is the same solve
for the probability-flow ODE of the score sampler, du/dτ = ½β(t)·(u +
s_θ(u, t)) with t = t1 − τ (the reference's ``persistent_pf_solve``, family
``("pfode", ...)``), without knots or reservoir; the score network is
kernel 11's (``fused_sde_solve.match_td_score_chain``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ...nn.basic import check_fp32_products
from ...ode.controller import initial_step_size
from ...ode.solve import (
    KNOT_FIELDS,
    device_scalar,
    RESERVOIR_FIELDS,
    adaptive_loop,
    knot_counts,
)
from ...ode.step import Tsit5StepResult
from . import _build
from .fused_mlp import (
    TDMLPWeights,
    check_operands,
    device_scalars,
    fused_tdmlp,
    tdmlp_plain,
    tsit5_step_plain,
)


# CTAs per thread-block cluster (csrc/sweep_cluster.cuh::kSweepCluster), and
# the dynamic shared memory a cluster kernel's CTA may have on an H100
# (227 KB) less its static shared memory (under 2.5 KB;
# csrc/sweep_cluster.cuh::kSweepSmemLimit)
CLUSTER_CTAS = 8
CLUSTER_SMEM_BYTES = 227 * 1024 - 2560
# csrc/persistent_solve.cu: the most rows of a cluster, the old kernel's
# error blocks (csrc/tdmlp.cuh::kRows) and the CTA's threads
SOLVE_ROWS_MAX = 40
SOLVE_ERROR_ROWS = 8
_SOLVE_THREADS = 512


def vec_ld(n: int) -> int:
    """A shared tile's leading dimension: a multiple of 4 floats whose
    quotient by 4 is odd (csrc/sweep_cluster.cuh::vec_ld)."""
    q = -(-n // 4)
    return 4 * (q if q % 2 else q + 1)


def round4(n: int) -> int:
    return (n + 3) // 4 * 4


class SolvePlan(NamedTuple):
    """The cluster layout of kernel 4 at (B, F, H), as the CUDA code
    computes it (``csrc/persistent_solve.cu``)."""

    cluster: int            # CTAs per cluster
    rows: int               # batch rows per cluster (a row block)
    row_blocks: tuple       # (row0, nrows) of each row block
    features: tuple         # per CTA rank: its features in segment order,
                            # the even ones (k ≡ rank mod 16), then the odd
    odd0: int               # offset of the odd features in a segment
    seg: int                # segment width (floats)
    error_blocks: tuple     # per row block: (slot, rank) of its 8-row blocks
    weights_shared: bool    # weight slices in shared memory (else read
                            # from global memory in the same order)
    smem_bytes: int         # dynamic shared memory of a CTA
    scratch_floats: int     # global scratch: u, u_new, k1..k7


def _solve_tiles(H: int, R: int, seg: int) -> int:
    """Floats of the vectors and work tiles of a CTA at R rows: b1, w1t,
    b2 and w2t; the stage input, the hidden rows, the inbox (16 partials of
    each group of 4 hidden units a CTA sums), the residual tile (8 rows of
    every CTA's segment) and the error tree."""
    inbox = 2 * CLUSTER_CTAS * 4 * (-(-(R * (-(-H // 4))) // CLUSTER_CTAS))
    return (2 * round4(H) + 2 * seg + R * vec_ld(seg) + R * vec_ld(H)
            + inbox + SOLVE_ERROR_ROWS * CLUSTER_CTAS * seg + _SOLVE_THREADS)


@functools.lru_cache(maxsize=64)
def solve_plan(B: int, F: int, H: int) -> SolvePlan:
    """The cluster plan of kernel 4: CTA c owns the features k ≡ c (mod
    ``CLUSTER_CTAS``), even ones (k ≡ c mod 16) first; a cluster owns
    ``SOLVE_ROWS_MAX`` rows with the weight slices in shared memory where
    they fit beside the work tiles, otherwise the weights stay in global
    memory and a cluster takes the most rows (a multiple of 8) whose tiles
    fit. Raises ValueError where not even 8 rows fit a CTA."""
    C = CLUSTER_CTAS
    counts = [max(0, -(-(F - c) // C)) for c in range(C)]
    odd0 = round4((counts[0] + 1) // 2)
    seg = odd0 + round4(counts[0] // 2)
    weights = seg * vec_ld(H) + H * vec_ld(seg)
    limit = CLUSTER_SMEM_BYTES // 4
    if weights + _solve_tiles(H, SOLVE_ROWS_MAX, seg) <= limit:
        R, shared = SOLVE_ROWS_MAX, True
    else:
        fits = [r for r in range(SOLVE_ROWS_MAX, 0, -SOLVE_ERROR_ROWS)
                if _solve_tiles(H, r, seg) <= limit]
        if not fits:
            raise ValueError(
                f"persistent_tsit5_solve: (F, H) = ({F}, {H}) needs "
                f"{4 * _solve_tiles(H, SOLVE_ERROR_ROWS, seg)} bytes of "
                f"shared memory a CTA at 8 rows a cluster, over "
                f"{CLUSTER_SMEM_BYTES}")
        R, shared = fits[0], False
    features = tuple(
        tuple(range(c, F, 2 * C)) + tuple(range(c + C, F, 2 * C))
        for c in range(C))
    row_blocks = tuple((r0, min(R, B - r0)) for r0 in range(0, B, R))
    error_blocks = tuple(
        tuple((r0 // SOLVE_ERROR_ROWS + j, j)
              for j in range(-(-n // SOLVE_ERROR_ROWS)))
        for r0, n in row_blocks)
    smem = 4 * ((weights if shared else 0) + _solve_tiles(H, R, seg))
    return SolvePlan(C, R, row_blocks, features, odd0, seg, error_blocks,
                     shared, smem, 9 * B * C * seg)


def _start(f, u0, t0: float, t_end: float, rtol, atol):
    """k1 at t0 and the first step from the Hairer probe, clipped to the
    span: two evaluations of ``f(u, t)``. Returns (k1_0, dt_init, nfe0)."""
    k1_0 = f(u0, t0)
    t0_dev, span = device_scalars([t0, t_end - t0], u0)
    dt_init, extra = initial_step_size(
        f, u0, t0_dev, order=5, rtol=rtol, atol=atol, f0=k1_0,
    )
    return k1_0, torch.minimum(dt_init, span), 1 + extra


def plain_step(w: TDMLPWeights):
    """The plain TD-MLP step in the eager loop's ``step_fn`` contract."""

    def step(fn, u, t, dt, k1, f_st):
        u_new, utilde, *ks, g6 = tsit5_step_plain(w, u, t, dt, k1)
        return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, f_st)

    return step


def persistent_tsit5_solve_plain(w: TDMLPWeights, u0, tspan, *, rtol, atol,
                                 saveat_arr, max_steps, record_knots=False,
                                 knot_dense_cap=None, knot_stride=1,
                                 reservoir=None):
    """The plain version of the persistent solve: the eager loop of
    ``ode/solve.py`` with the plain TD-MLP step, recording as the kernel
    does (no k1 knots)."""
    return _plain_solve(
        lambda u, t: tdmlp_plain(w, u, t), u0, tspan, rtol=rtol, atol=atol,
        saveat_arr=saveat_arr, max_steps=max_steps, step_fn=plain_step(w),
        record_knots=record_knots, knot_dense_cap=knot_dense_cap,
        knot_stride=knot_stride, reservoir=reservoir,
    )


def _plain_solve(f, u0, tspan, *, rtol, atol, saveat_arr, max_steps,
                 step_fn=None, **record):
    """The eager loop from u0 with the dynamics ``f(u, t)`` (and a step
    replacement), in the persistent solves' return contract."""
    check_fp32_products(rtol, u0.device)
    t0, t_end = float(tspan[0]), float(tspan[1])
    k1_0, dt_init, nfe0 = _start(f, u0, t0, t_end, rtol, atol)
    out = adaptive_loop(
        lambda u, t, st: (f(u, t), st), u0, k1_0, None, t0, t_end, dt_init,
        saveat=saveat_arr, rtol=rtol, atol=atol, max_steps=max_steps,
        step_fn=step_fn, **record,
    )
    res = dict(
        y_final=out["y_final"], ys=out["ys"], naccept=out["naccept"],
        nreject=out["nreject"], success=out["success"],
        nfe=nfe0 + 6 * out["natt"], t_final=out["t_final"], ts=saveat_arr,
    )
    res.update({k: out.get(k) for k in KNOT_FIELDS + RESERVOIR_FIELDS
                if k != "knot_ks"})
    return res


def persistent_tsit5_solve(w: TDMLPWeights, u0: torch.Tensor, tspan, *,
                           rtol: float, atol: float, saveat_arr: torch.Tensor,
                           max_steps: int, record_knots=False,
                           knot_dense_cap=None, knot_stride=1,
                           reservoir=None):
    """Run the whole adaptive solve of ``du/dt = tdmlp(u, t)``.

    Returns a dict of ``y_final``, ``ys`` (n_save, B, F), ``naccept``,
    ``nreject``, ``success``, ``nfe``, ``t_final`` and ``ts``, as device
    tensors (no host sync); with ``record_knots`` also ``knot_ts``
    (dense_cap + 1), ``knot_us`` (dense_cap + 1, B, F) and, with a
    ``knot_stride`` W > 1, ``ckpt_ts``, ``ckpt_us``, ``ckpt_ks``,
    ``ckpt_dts`` and ``ckpt_qolds`` (max_steps // W + 1 entries); with
    ``reservoir`` (float32, at least ``max_steps`` uniforms) also
    ``reservoir_t`` and ``reservoir_u``. A CUDA tensor launches the kernel
    (laid out by ``solve_plan``, which raises for a TD-MLP too wide for a
    CTA); a CPU tensor runs ``persistent_tsit5_solve_plain``.
    """
    check_reservoir(reservoir, max_steps)
    rec = dict(record_knots=record_knots, knot_dense_cap=knot_dense_cap,
               knot_stride=knot_stride, reservoir=reservoir)
    if u0.device.type == "cpu":
        return persistent_tsit5_solve_plain(
            w, u0, tspan, rtol=rtol, atol=atol, saveat_arr=saveat_arr,
            max_steps=max_steps, **rec,
        )
    out = _launch_solve(w, u0, tspan, rtol=rtol, atol=atol,
                        saveat_arr=saveat_arr, max_steps=max_steps, **rec)
    persistent_tsit5_solve.launches += 1
    return out


def _solve_layout(B: int, F: int, H: int):
    """``solve_plan`` at (B, F, H) (which raises for a width no CTA can
    take) and the library, raising unless it lays the solve out the same
    way. Returns (library, plan)."""
    plan = solve_plan(B, F, H)
    lib = _build.load_library()
    if (lib.lrnde_solve_rows(F, H), bool(lib.lrnde_solve_weights_shared(F, H)),
            lib.lrnde_solve_smem_floats(F, H) * 4,
            lib.lrnde_solve_scratch_floats(B, F, H)) != (
            plan.rows, plan.weights_shared, plan.smem_bytes,
            plan.scratch_floats):
        raise RuntimeError("persistent_tsit5_solve: the library's layout "
                           "differs from solve_plan")
    return lib, plan


def _launch_solve(w, u0, tspan, *, rtol, atol, saveat_arr, max_steps,
                  record_knots=False, knot_dense_cap=None, knot_stride=1,
                  reservoir=None, timing=None):
    """One launch of kernel 4 on CUDA tensors; with ``timing`` (int64,
    ``lrnde_solve_phases() + 1``) the instantiation with the compile-time
    clock, which fills it with CTA 0's nanoseconds per phase and the number
    of attempts."""
    check_fp32_products(rtol, u0.device)
    B, F, H = check_operands(w, u0)
    lib, plan = _solve_layout(B, F, H)
    t0, t_end = float(tspan[0]), float(tspan[1])
    k1_0, dt_init, nfe0 = _start(lambda u, t: fused_tdmlp(w, u, t), u0, t0,
                                 t_end, rtol, atol)
    sc = device_scalars([t0, t_end, dt_init], u0)
    saveat = saveat_arr.to(device=u0.device, dtype=torch.float32).contiguous()
    n_save = saveat.shape[0]

    n_blocks = -(-B // SOLVE_ERROR_ROWS)
    dev = u0.device
    y_final = torch.empty_like(u0)
    ys = torch.empty((n_save, B, F), dtype=torch.float32, device=dev)
    stats_i = torch.empty(4, dtype=torch.int32, device=dev)
    stats_f = torch.empty(2, dtype=torch.float32, device=dev)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=dev)
    slots = torch.empty(2 * n_blocks, dtype=torch.float32, device=dev)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    knots = _knot_outputs(u0, max_steps, record_knots=record_knots,
                          knot_dense_cap=knot_dense_cap,
                          knot_stride=knot_stride)
    rand, res_u = reservoir_operands(reservoir, u0)
    n_dense = knots["knot_ts"].shape[0] if knots else 0
    n_ckpt = knots["ckpt_ts"].shape[0] if "ckpt_ts" in knots else 0
    stride = max(1, int(knot_stride))
    p = _build.ptr
    null = ctypes.c_void_p(0)
    kp = lambda k: p(knots[k]) if k in knots else null  # noqa: E731
    entry, clock = lib.lrnde_persistent_tsit5, []
    if timing is not None:
        entry, clock = lib.lrnde_persistent_tsit5_timed, [p(timing)]
    err = entry(
        p(u0), p(k1_0), p(sc), p(saveat), n_save,
        p(w.w1), p(w.b1), p(w.w2), p(w.b2),
        p(y_final), p(ys), p(stats_i), p(stats_f), p(scratch), p(slots),
        p(barrier), B, F, H, int(max_steps), float(rtol), float(atol),
        1.0 / float(B * F),
        kp("knot_ts"), kp("knot_us"), n_dense,
        kp("ckpt_ts"), kp("ckpt_us"), kp("ckpt_ks"), kp("ckpt_dts"),
        kp("ckpt_qolds"), n_ckpt, stride,
        p(rand) if rand is not None else null,
        p(res_u) if res_u is not None else null,
        *clock, _build.stream_ptr(dev),
    )
    _build.check(lib, err, "persistent_tsit5_solve")
    return dict(
        y_final=y_final, ys=ys, naccept=stats_i[0], nreject=stats_i[1],
        success=stats_i[2].bool(), nfe=nfe0 + 6 * stats_i[3],
        t_final=stats_f[0], ts=saveat_arr, **knots,
        **(dict(reservoir_t=stats_f[1], reservoir_u=res_u)
           if res_u is not None else {}),
    )


persistent_tsit5_solve.launches = 0


def solve_eval(w: TDMLPWeights, x: torch.Tensor, s) -> torch.Tensor:
    """One dynamics evaluation of CUDA tensors through kernel 4's cluster
    path (the products, the cluster sum of the hidden rows and the
    epilogues of ``csrc/persistent_solve.cu``), for checking it against
    kernel 1 (``fused_tdmlp``), whose arithmetic it repeats bitwise."""
    B, F, H = check_operands(w, x)
    lib, plan = _solve_layout(B, F, H)
    out = torch.empty_like(x)
    scratch = torch.empty(plan.scratch_floats // 9, device=x.device)
    p = _build.ptr
    err = lib.lrnde_solve_eval(
        p(x), p(device_scalars([s], x)), *[p(t) for t in w], p(out),
        p(scratch), B, F, H, _build.stream_ptr(x.device))
    _build.check(lib, err, "solve_eval")
    return out


def check_reservoir(reservoir, max_steps: int) -> None:
    """Raise unless ``reservoir`` is None or holds one uniform per
    attempt."""
    if reservoir is not None and (reservoir.ndim != 1
                                  or reservoir.shape[0] < max_steps):
        raise ValueError(f"reservoir: needs {max_steps} uniforms, got "
                         f"{tuple(reservoir.shape)}")


def reservoir_operands(reservoir, u0):
    """(uniforms, sample buffer) of a kernel solve with a reservoir, or
    (None, None) without one; the caller has checked ``reservoir``."""
    if reservoir is None:
        return None, None
    rand = reservoir.to(device=u0.device, dtype=torch.float32).contiguous()
    return rand, torch.empty_like(u0)


def _knot_outputs(u0, max_steps, *, record_knots, knot_dense_cap,
                  knot_stride):
    """Uninitialised knot and checkpoint buffers for the kernel, which
    fills every entry (the layout of ``ode.solve._knot_buffers``, without
    k1 knots)."""
    if not record_knots:
        return {}
    n_dense, n_ckpt = knot_counts(max_steps, knot_dense_cap, knot_stride)
    B, F = u0.shape
    dev = u0.device
    out = dict(
        knot_ts=torch.empty(n_dense, device=dev),
        knot_us=torch.empty((n_dense, B, F), device=dev),
    )
    if n_ckpt:
        out.update(
            ckpt_ts=torch.empty(n_ckpt, device=dev),
            ckpt_us=torch.empty((n_ckpt, B, F), device=dev),
            ckpt_ks=torch.empty((n_ckpt, B, F), device=dev),
            ckpt_dts=torch.empty(n_ckpt, device=dev),
            ckpt_qolds=torch.empty(n_ckpt, device=dev),
        )
    return out


# ---------------------------------------------------------------------------
# kernel 5: the autonomous Dense chain (the latent ODE's generative dynamics)

# at most this many layers (csrc/chain.cuh::kChainMaxLayers)
CHAIN_MAX_LAYERS = 16
# the dynamic shared memory a CTA may use on Hopper, less the kernels' static
# shared memory (the slot-sum buffer, the controller and the clock: under
# 2.5 KB)
CHAIN_SMEM_BYTES = 227 * 1024 - 2560
# at most this many saveat times in kernel 9 (csrc/chain_sweep.cu::
# kChainMaxSave; the reference's _MAX_NSAVE_CHAIN)
CHAIN_MAX_SAVE = 64
# csrc/chain_rows.cuh: the rows of an error block (a CTA's unit, a warp a
# row) and the most error blocks a CTA of kernel 5 or of kernel 9's
# two-level mode takes (chain_solve.cu::kChainMaxJ,
# chain_sweep.cu::kChainSweepMaxJ)
CHAIN_ROWS = 4
CHAIN_MAX_J = 128
CHAIN_SWEEP_MAX_J = 32


class ChainPlan(NamedTuple):
    """The grid of kernel 5 (or of kernel 9) at B rows, as the CUDA code
    computes it (``csrc/chain_rows.cuh::chain_grid``)."""

    J: int                 # error blocks a CTA
    grid: int              # CTAs (kernel 9: gradient partials)
    blocks: tuple          # per CTA: its error blocks (first, count)
    smem_bytes: int        # dynamic shared memory of a CTA


def _stage_stash(dims) -> int:
    """Floats of kernel 9's stash of one row and stage: a_0..a_{L-1} and
    dz_0..dz_{L-1}, each rounded up to 4 (``chain_sweep.cu::chain_stash``)."""
    L = len(dims) - 1
    return sum(round4(dims[l]) + round4(dims[l + 1]) for l in range(L))


def chain_smem_floats(dims, J: int, sweep: bool = False) -> int:
    """A CTA's dynamic shared memory (floats) at J error blocks: kernel 5's
    (``chain_solve_smem_floats``) or kernel 9's
    (``chain_sweep_smem_floats``). The weights are held as W_lᵀ with b_l
    (the forward) and, in kernel 9, as W_l (the transpose), each row padded
    to ``vec_ld`` (``csrc/chain_rows.cuh::ChainLayout``)."""
    L, F, R = len(dims) - 1, dims[0], CHAIN_ROWS
    n_params = sum(dims[l] * dims[l + 1] + dims[l + 1] for l in range(L))
    fwd = sum(dims[l + 1] * vec_ld(dims[l]) + round4(dims[l + 1])
              for l in range(L))
    aw = round4(max(dims))
    blocks = J * (9 * R * F + R * F)
    if not sweep:
        return fwd + 2 * R * aw + blocks
    rev = sum(dims[l] * vec_ld(dims[l + 1]) for l in range(L))
    return (fwd + rev + round4(n_params)
            + R * (6 * _stage_stash(dims) + 15 * round4(F) + 2 * aw)
            + blocks + 8 * CHAIN_MAX_SAVE)


def chain_plan(B: int, dims, resident, *, sweep=False,
               two_level=True) -> ChainPlan:
    """The grid of kernel 5 (or, with ``sweep``, kernel 9) for B rows:
    CTAs of ``CHAIN_ROWS`` warps, each owning J consecutive error blocks of
    ``CHAIN_ROWS`` rows, J the least that lets every CTA be resident at
    once, where ``resident(smem_bytes)`` is the CTAs an H100 holds at that
    shared memory (the card's occupancy query). Kernel 9's dense mode
    needs no residency: a CTA a block. Raises ValueError where no J fits."""
    n_blk = -(-B // CHAIN_ROWS)
    max_J = CHAIN_SWEEP_MAX_J if sweep else CHAIN_MAX_J
    if sweep and not two_level:
        max_J = 1
    for J in range(1, max_J + 1):
        smem = 4 * chain_smem_floats(dims, J, sweep)
        fits = smem <= CHAIN_SMEM_BYTES and resident(smem) > 0
        if not fits:
            break
        grid = -(-n_blk // J)
        if (sweep and not two_level) or grid <= resident(smem):
            blocks = tuple((g * J, min(J, n_blk - g * J))
                           for g in range(grid))
            return ChainPlan(J, grid, blocks, smem)
    raise ValueError(f"chain {tuple(dims)}: B = {B} does not fit the "
                     f"resident CTAs of kernel {9 if sweep else 5}")


class DenseChainSpec(NamedTuple):
    """The shape of an autonomous Dense chain ``Chain([Lambda(tanh)],
    Dense(d0 → d1, act), ..., Dense(d_{L-1} → d_L, act))`` with d_L = d0:
    the widths ``dims``, a tanh flag per layer ``acts`` and the leading tanh
    ``lead``. Its parameters are the list ``[W_0, b_0, W_1, b_1, ...]``, W_l
    of shape (d_l, d_{l+1})."""

    dims: tuple
    acts: tuple
    lead: bool


def match_dense_chain(model) -> Optional[DenseChainSpec]:
    """The chain's spec when ``model`` is ``Chain([Lambda(tanh)], Dense...)``
    with biases, tanh or identity activations and d_L = d_0; None otherwise
    (the reference's ``fused_solve.py:760-797``; the leading function is
    recognised by identity, ``torch.tanh``)."""
    from ...nn.basic import _ACTIVATIONS, Chain, Dense, Lambda

    if not isinstance(model, Chain):
        return None
    items = list(model.layers.values())
    lead = False
    if items and isinstance(items[0], Lambda):
        if items[0].fn is not torch.tanh:
            return None
        lead = True
        items = items[1:]
    if not items or not all(isinstance(l, Dense) for l in items):
        return None
    ident = (_ACTIVATIONS[None], _ACTIVATIONS["identity"])
    dims, acts = [items[0].in_dim], []
    for layer in items:
        if not layer.use_bias or layer.in_dim != dims[-1]:
            return None
        if layer.activation is torch.tanh:
            acts.append(True)
        elif any(layer.activation is fn for fn in ident):
            acts.append(False)
        else:
            return None
        dims.append(layer.out_dim)
    if dims[0] != dims[-1]:
        return None
    return DenseChainSpec(tuple(dims), tuple(acts), lead)


def chain_eval(params, chain: DenseChainSpec, x: torch.Tensor) -> torch.Tensor:
    """The plain chain evaluation (the reference's ``chain_eval_pure``):
    k1_0, the dt probe, and the plain versions of kernels 5 and 9."""
    a = torch.tanh(x) if chain.lead else x
    for i, act in enumerate(chain.acts):
        z = a @ params[2 * i] + params[2 * i + 1]
        a = torch.tanh(z) if act else z
    return a


def chain_param_sizes(chain: DenseChainSpec):
    """Shapes of the chain's parameters, ``[W_0, b_0, W_1, ...]``."""
    d = chain.dims
    out = []
    for i in range(len(d) - 1):
        out += [(d[i], d[i + 1]), (d[i + 1],)]
    return out


@functools.lru_cache(maxsize=None)
def smem_bytes(dims: tuple, query: str) -> int:
    """A CTA's dynamic shared memory for the network of widths ``dims``
    (the Dense chain's or the score chain's), from the library's C size
    query ``query``; asked once per network."""
    lib = _build.load_library()
    L = len(dims) - 1
    arr = (ctypes.c_int * (L + 1))(*dims)
    return 4 * getattr(lib, query)(ctypes.cast(arr, ctypes.c_void_p), L)


def chain_limits(chain: DenseChainSpec, n_save=None, *,
                 cuda=True) -> Optional[str]:
    """Why the chain kernels cannot take ``chain``, or None when they can:
    kernel 5 alone, or kernels 5 and 9 for a sweep of ``n_save`` saveat
    times. The limits: 1 to ``CHAIN_MAX_LAYERS`` layers, at most
    ``CHAIN_MAX_SAVE`` saveat times in the sweep, and each kernel's shared
    memory within ``CHAIN_SMEM_BYTES`` (left out with ``cuda=False``, where
    the plain versions run)."""
    L = len(chain.dims) - 1
    if not 1 <= L <= CHAIN_MAX_LAYERS:
        return f"chain: {L} layers, the kernels take 1 to {CHAIN_MAX_LAYERS}"
    queries = ["lrnde_chain_solve_smem_floats"]
    if n_save is not None:
        if n_save > CHAIN_MAX_SAVE:
            return (f"{n_save} saveat times, kernel 9 takes at most "
                    f"{CHAIN_MAX_SAVE}")
        queries.append("lrnde_chain_sweep_smem_floats")
    for q in queries if cuda else ():
        need = smem_bytes(chain.dims, q)
        if not 0 < need <= CHAIN_SMEM_BYTES:
            return (f"chain {chain.dims}: needs {need} bytes of shared memory "
                    f"per CTA ({q}), the kernels take at most "
                    f"{CHAIN_SMEM_BYTES}")
    return None


def check_tensors(named, state: torch.Tensor) -> None:
    """Raise unless every ``(name, tensor, shape)`` of ``named`` is a
    contiguous float32 tensor of that shape on ``state``'s device."""
    for name, t, want in named:
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous float32")
        if t.device != state.device:
            raise ValueError(f"{name}: on {t.device}, state on {state.device}")


def check_chain_operands(params, chain: DenseChainSpec, *states,
                         n_save=None) -> tuple:
    """Validate the chain's kernel operands: float32, contiguous, on one
    CUDA device, states (B, F), weights matching ``chain.dims``, and the
    chain (with a sweep's ``n_save``) inside ``chain_limits``. Returns
    (B, F)."""
    B, F = states[0].shape
    reason = chain_limits(chain, n_save)
    if reason is not None:
        raise ValueError(reason)
    shapes = chain_param_sizes(chain)
    if len(params) != len(shapes):
        raise ValueError(f"{len(params)} parameters for a chain of "
                         f"{len(shapes) // 2} layers")
    check_tensors([(f"param {i}", p, want)
                   for i, (p, want) in enumerate(zip(params, shapes))]
                  + [("state", s, (B, F)) for s in states], states[0])
    if B < 1 or F != chain.dims[0]:
        raise ValueError(f"state {(B, F)} for a chain of width "
                         f"{chain.dims[0]}")
    return B, F


def net_operands(params, dims, acts) -> tuple:
    """The C operands of a layered network: the parameter pointer array
    (W_0, b_0, W_1, ...), the dims array, L and the tanh bit mask."""
    L = len(dims) - 1
    dims_arr = (ctypes.c_int * (L + 1))(*dims)
    wb = (ctypes.c_void_p * (2 * L))(*[p.data_ptr() for p in params])
    mask = sum(1 << i for i, a in enumerate(acts) if a)
    return (ctypes.cast(wb, ctypes.c_void_p),
            ctypes.cast(dims_arr, ctypes.c_void_p), L, mask)


def chain_operands(params, chain: DenseChainSpec):
    """The chain's C operands (``net_operands`` and the lead flag);
    ``check_chain_operands`` has checked them."""
    return net_operands(params, chain.dims, chain.acts) + (int(chain.lead),)


def persistent_chain_solve_plain(params, chain: DenseChainSpec, u0, tspan, *,
                                 rtol, atol, saveat_arr, max_steps,
                                 record_knots=False, knot_dense_cap=None,
                                 knot_stride=1, reservoir=None):
    """The plain version of kernel 5: the eager loop of ``ode/solve.py``
    (``adaptive_loop``) with the generic Tsit5 step of the plain chain,
    recording as the kernel does (no k1 knots)."""
    return _plain_solve(
        lambda u, t: chain_eval(params, chain, u), u0, tspan, rtol=rtol,
        atol=atol, saveat_arr=saveat_arr, max_steps=max_steps,
        record_knots=record_knots, knot_dense_cap=knot_dense_cap,
        knot_stride=knot_stride, reservoir=reservoir,
    )


def persistent_chain_solve(params, chain: DenseChainSpec, u0: torch.Tensor,
                           tspan, *, rtol: float, atol: float,
                           saveat_arr: torch.Tensor, max_steps: int,
                           record_knots=False, knot_dense_cap=None,
                           knot_stride=1, reservoir=None):
    """Run the whole adaptive solve of ``du/dt = chain(u)`` (kernel 5).

    The contract and return dict of ``persistent_tsit5_solve``: ``params``
    are the chain's ``[W_0, b_0, ...]`` and ``chain`` its
    ``match_dense_chain`` spec. As in the reference, k1_0 and the Hairer dt
    probe are plain evaluations outside the kernel, so NFE = 2 +
    6·attempts. A CUDA tensor launches the kernel; a CPU tensor runs
    ``persistent_chain_solve_plain``.

    Limits of the kernel (``chain_limits``; it raises outside them): at
    most ``CHAIN_MAX_LAYERS`` layers, and the chain's weights with a CTA's
    rows within ``CHAIN_SMEM_BYTES`` of shared memory (the PhysioNet chain,
    8 layers 20 ↔ 40, takes 31 KB a 4-row block). Any batch size the card
    holds resident (``chain_plan``: a CTA takes more blocks when the grid
    would not fit), any number of saveat times, unsorted; times ≤ t0
    return u0.
    """
    check_reservoir(reservoir, max_steps)
    rec = dict(record_knots=record_knots, knot_dense_cap=knot_dense_cap,
               knot_stride=knot_stride, reservoir=reservoir)
    if u0.device.type == "cpu":
        return persistent_chain_solve_plain(
            params, chain, u0, tspan, rtol=rtol, atol=atol,
            saveat_arr=saveat_arr, max_steps=max_steps, **rec,
        )
    out = _launch_chain(params, chain, u0, tspan, rtol=rtol, atol=atol,
                        saveat_arr=saveat_arr, max_steps=max_steps, **rec)
    persistent_chain_solve.launches += 1
    return out


def _launch_chain(params, chain, u0, tspan, *, rtol, atol, saveat_arr,
                  max_steps, record_knots=False, knot_dense_cap=None,
                  knot_stride=1, reservoir=None, timing=None):
    """One launch of kernel 5 on CUDA tensors; with ``timing`` (int64,
    one entry a phase of ``lrnde_chain_solve_phase_names`` and one more) the
    instantiation with the compile-time clock, which fills it with CTA 0's
    nanoseconds per phase and the number of attempts."""
    check_fp32_products(rtol, u0.device)
    B, F = check_chain_operands(params, chain, u0)
    lib = _build.load_library()
    chain_args = chain_operands(params, chain)
    t0, t_end = float(tspan[0]), float(tspan[1])
    k1_0, dt_init, nfe0 = _start(lambda u, t: chain_eval(params, chain, u),
                                 u0, t0, t_end, rtol, atol)
    sc = device_scalars([t0, t_end, dt_init], u0)
    saveat = saveat_arr.to(device=u0.device, dtype=torch.float32).contiguous()
    n_save = saveat.shape[0]
    n_blocks = -(-B // lib.lrnde_chain_error_rows())
    dev = u0.device
    y_final = torch.empty_like(u0)
    ys = torch.empty((n_save, B, F), dtype=torch.float32, device=dev)
    stats_i = torch.empty(4, dtype=torch.int32, device=dev)
    stats_f = torch.empty(2, dtype=torch.float32, device=dev)
    slots = torch.empty(2 * n_blocks, dtype=torch.float32, device=dev)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    knots = _knot_outputs(u0, max_steps, record_knots=record_knots,
                          knot_dense_cap=knot_dense_cap,
                          knot_stride=knot_stride)
    rand, res_u = reservoir_operands(reservoir, u0)
    n_dense = knots["knot_ts"].shape[0] if knots else 0
    n_ckpt = knots["ckpt_ts"].shape[0] if "ckpt_ts" in knots else 0
    p = _build.ptr
    null = ctypes.c_void_p(0)
    kp = lambda k: p(knots[k]) if k in knots else null  # noqa: E731
    entry, clock = lib.lrnde_persistent_chain, []
    if timing is not None:
        entry, clock = lib.lrnde_persistent_chain_timed, [p(timing)]
    err = entry(
        p(u0), p(k1_0), p(sc), p(saveat), n_save, *chain_args,
        p(y_final), p(ys), p(stats_i), p(stats_f), p(slots),
        p(barrier), B, int(max_steps), float(rtol), float(atol),
        1.0 / float(B * F),
        kp("knot_ts"), kp("knot_us"), n_dense,
        kp("ckpt_ts"), kp("ckpt_us"), kp("ckpt_ks"), kp("ckpt_dts"),
        kp("ckpt_qolds"), n_ckpt, max(1, int(knot_stride)),
        p(rand) if rand is not None else null,
        p(res_u) if res_u is not None else null,
        *clock, _build.stream_ptr(dev),
    )
    _build.check(lib, err, "persistent_chain_solve")
    return dict(
        y_final=y_final, ys=ys, naccept=stats_i[0], nreject=stats_i[1],
        success=stats_i[2].bool(), nfe=nfe0 + 6 * stats_i[3],
        t_final=stats_f[0], ts=saveat_arr, **knots,
        **(dict(reservoir_t=stats_f[1], reservoir_u=res_u)
           if res_u is not None else {}),
    )


persistent_chain_solve.launches = 0


# ---------------------------------------------------------------------------
# kernel 6: the probability-flow ODE of the score sampler


def pf_dynamics(params, chain, beta_min, beta_max, t1):
    """Kernel 6's dynamics on the τ clock, ``f(u, τ)``: with t = t1 − τ and
    β = β_min + t·Δβ, ½β·(u + s_θ(u, t)) (the reference sampler's
    −(−½β·(u + s)), rounded alike)."""
    from .fused_sde_solve import td_score_eval_plain

    d_beta = float(beta_max) - float(beta_min)

    def f(u, tau):
        t = float(t1) - device_scalar(tau, u)
        b = float(beta_min) + t * d_beta
        return (0.5 * b) * (u + td_score_eval_plain(params, chain, u, t))

    return f


def persistent_pf_solve_plain(params, chain, u0, tspan, *, rtol, atol,
                              saveat_arr, max_steps, beta_min, beta_max, t1):
    """The plain version of kernel 6: the eager loop of ``ode/solve.py``
    with the plain score chain."""
    return _plain_solve(
        pf_dynamics(params, chain, beta_min, beta_max, t1), u0, tspan,
        rtol=rtol, atol=atol, saveat_arr=saveat_arr, max_steps=max_steps,
    )


def persistent_pf_solve(params, chain, u0: torch.Tensor, tspan, *,
                        rtol: float, atol: float, saveat_arr: torch.Tensor,
                        max_steps: int, beta_min: float, beta_max: float,
                        t1: float):
    """Run the whole adaptive Tsit5 solve of the probability-flow ODE
    (kernel 6).

    ``params`` are the score chain's ``[W_0, b_0, ...]`` and ``chain`` its
    ``fused_sde_solve.match_td_score_chain`` spec. The return dict of
    ``persistent_tsit5_solve`` without knots or reservoir. As in the
    reference, k1 and the Hairer probe run outside the kernel, so NFE =
    1 + 1 + 6·attempts. A CUDA tensor launches the kernel; a CPU tensor runs
    ``persistent_pf_solve_plain``. Any batch size and number of saveat
    times.
    """
    from .fused_sde_solve import check_score_operands, score_operands

    kw = dict(rtol=rtol, atol=atol, saveat_arr=saveat_arr,
              max_steps=max_steps, beta_min=beta_min, beta_max=beta_max,
              t1=t1)
    if u0.device.type == "cpu":
        return persistent_pf_solve_plain(params, chain, u0, tspan, **kw)
    check_fp32_products(rtol, u0.device)
    B, F = check_score_operands(params, chain, u0,
                                "lrnde_pf_solve_smem_floats")
    lib = _build.load_library()
    t0, t_end = float(tspan[0]), float(tspan[1])
    k1_0, dt_init, nfe0 = _start(
        pf_dynamics(params, chain, beta_min, beta_max, t1), u0, t0, t_end,
        rtol, atol)
    sc = device_scalars([t0, t_end, dt_init], u0)
    saveat = saveat_arr.to(device=u0.device, dtype=torch.float32).contiguous()
    n_save = saveat.shape[0]
    n_blocks = -(-B // lib.lrnde_score_rows_per_block())
    dev = u0.device
    y_final = torch.empty_like(u0)
    ys = torch.empty((n_save, B, F), dtype=torch.float32, device=dev)
    stats_i = torch.empty(4, dtype=torch.int32, device=dev)
    stats_f = torch.empty(1, dtype=torch.float32, device=dev)
    scratch = torch.empty((8, B, F), dtype=torch.float32, device=dev)
    slots = torch.empty(2 * n_blocks, dtype=torch.float32, device=dev)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    p = _build.ptr
    err = lib.lrnde_persistent_pf(
        p(u0), p(k1_0), p(sc), p(saveat), n_save,
        *score_operands(params, chain, beta_min, beta_max, t1),
        p(y_final), p(ys), p(stats_i), p(stats_f), p(scratch), p(slots),
        p(barrier), B, int(max_steps), float(rtol), float(atol),
        1.0 / float(B * F), _build.stream_ptr(dev),
    )
    _build.check(lib, err, "persistent_pf_solve")
    persistent_pf_solve.launches += 1
    return dict(
        y_final=y_final, ys=ys, naccept=stats_i[0], nreject=stats_i[1],
        success=stats_i[2].bool(), nfe=nfe0 + 6 * stats_i[3],
        t_final=stats_f[0], ts=saveat_arr,
    )


persistent_pf_solve.launches = 0
