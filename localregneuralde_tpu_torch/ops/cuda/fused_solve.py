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

``precision`` (the reference's meaning; ``'highest'`` when not given, see
``fused_mlp``) sets the tier of every product, the kernel's and the start's:
on a card the default tier is kernel 4's TF32 instantiation, which refuses
rtol < 1e-4 (``nn.basic.check_product_tier``).

With ``reservoir`` (``max_steps`` uniforms, drawn in advance by the caller)
the kernel keeps the biased regulariser's reservoir sample: an accepted
attempt number ``natt`` takes its step start ``(t, u)`` when
``reservoir[natt]·(naccept + 1) < 1`` (``reservoir_t``, ``reservoir_u``).

Kernel 5 (``persistent_chain_solve``, ``csrc/chain_solve.cu``) is the same
solve for the autonomous Dense chain of the latent ODE (the reference's
``persistent_chain_solve``, family ``("chain", dims, acts, lead)``), with
the same recording and reservoir, a warp a row (``chain_plan`` models its
layout); its plain version is the eager loop with the plain chain
(``chain_eval``). ``precision`` as for kernel 4: at the TF32 tier
(``lrnde_persistent_chain_tf32``, the reference's 'default') every layer's
product rounds its operands to TF32 and accumulates in FP32, the kernel's
on the tensor cores, the plain chain's through ``nn.basic.tier_matmul``.

Kernel 6 (``persistent_pf_solve``, ``csrc/pf_solve.cu``) is the same solve
for the probability-flow ODE of the score sampler, du/dτ = ½β(t)·(u +
s_θ(u, t)) with t = t1 − τ (the reference's ``persistent_pf_solve``, family
``("pfode", ...)``), without knots or reservoir; the score network is
kernel 11's (``fused_sde_solve.match_td_score_chain``), evaluated a warp a
group of ``PF_WARP_ROWS`` rows (``pf_plan`` models its grid); at the TF32
tier (``lrnde_persistent_pf_tf32``, the reference sampler's backend
default) its layers' products as kernel 11's (``fused_sde_solve``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ...nn.basic import (
    check_fp32_products,
    check_product_tier,
    product_tier,
    tier_matmul,
)
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
    count_launch,
    device_scalars,
    tdmlp_at,
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


# ---- the cluster layout of kernels 1, 2 and 4 (csrc/solve_cluster.cuh)


def solve_count(F: int, c: int) -> int:
    """The features of CTA rank c: k = 8m + c, m < solve_count(F, c)."""
    return max(0, -(-(F - c) // CLUSTER_CTAS))


def solve_odd0(F: int) -> int:
    """Offset of the odd features (k ≡ c + 8 mod 16) in a segment."""
    return round4((solve_count(F, 0) + 1) // 2)


def solve_seg(F: int) -> int:
    """The width of a CTA's segment of a row (floats)."""
    return solve_odd0(F) + round4(solve_count(F, 0) // 2)


def solve_local(ne: int, odd0: int, j: int) -> int:
    """The segment position of a CTA's j-th feature, ``ne`` of them even."""
    return j if j < ne else odd0 + (j - ne)


def slice_feature(c: int, odd0: int, l: int) -> int:
    """The feature at segment position l of CTA rank c."""
    return 16 * l + c if l < odd0 else 16 * (l - odd0) + 8 + c


def cta_features(F: int, c: int) -> tuple:
    """CTA c's features in segment order: the even ones, then the odd."""
    n, odd0 = solve_count(F, c), solve_odd0(F)
    return tuple(slice_feature(c, odd0, solve_local((n + 1) // 2, odd0, j))
                 for j in range(n))


def segment_index(F: int) -> torch.Tensor:
    """Each feature's position in a row of the segment layout (the 8
    segments of ``solve_seg(F)`` floats side by side): ``rows[:, idx]``
    reads a (B, 8·seg) segment buffer row-major, and assigning to it writes
    one."""
    idx = torch.empty(F, dtype=torch.long)
    odd0, seg = solve_odd0(F), solve_seg(F)
    for c in range(CLUSTER_CTAS):
        n = solve_count(F, c)
        for j in range(n):
            l = solve_local((n + 1) // 2, odd0, j)
            idx[slice_feature(c, odd0, l)] = c * seg + l
    return idx


def _eval_tiles(H: int, R: int, seg: int) -> int:
    """Floats of the vectors and tiles of one evaluation at R rows: b1,
    w1t, b2 and w2t; the stage input, the hidden rows and the inbox (16
    partials of each group of 4 hidden units a CTA sums)."""
    inbox = 2 * CLUSTER_CTAS * 4 * (-(-(R * (-(-H // 4))) // CLUSTER_CTAS))
    return 2 * round4(H) + 2 * seg + R * vec_ld(seg) + R * vec_ld(H) + inbox


def _solve_tiles(H: int, R: int, seg: int) -> int:
    """The solve's tiles: an evaluation's, the residual tile (8 rows of
    every CTA's segment) and the error tree."""
    return (_eval_tiles(H, R, seg) + SOLVE_ERROR_ROWS * CLUSTER_CTAS * seg
            + _SOLVE_THREADS)


@functools.lru_cache(maxsize=64)
def solve_plan(B: int, F: int, H: int) -> SolvePlan:
    """The cluster plan of kernel 4: CTA c owns the features k ≡ c (mod
    ``CLUSTER_CTAS``), even ones (k ≡ c mod 16) first; a cluster owns
    ``SOLVE_ROWS_MAX`` rows with the weight slices in shared memory where
    they fit beside the work tiles, otherwise the weights stay in global
    memory and a cluster takes the most rows (a multiple of 8) whose tiles
    fit. Raises ValueError where not even 8 rows fit a CTA."""
    C = CLUSTER_CTAS
    odd0, seg = solve_odd0(F), solve_seg(F)
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
    features = tuple(cta_features(F, c) for c in range(C))
    row_blocks = tuple((r0, min(R, B - r0)) for r0 in range(0, B, R))
    error_blocks = tuple(
        tuple((r0 // SOLVE_ERROR_ROWS + j, j)
              for j in range(-(-n // SOLVE_ERROR_ROWS)))
        for r0, n in row_blocks)
    smem = 4 * ((weights if shared else 0) + _solve_tiles(H, R, seg))
    return SolvePlan(C, R, row_blocks, features, odd0, seg, error_blocks,
                     shared, smem, 9 * B * C * seg)


class EvalPlan(NamedTuple):
    """The cluster grid of kernels 1 and 2 at (B, F, H) on a card that keeps
    ``resident`` clusters at once, as ``csrc/tdmlp_cluster.cu`` computes
    it: no error norm, so a cluster may own any count of rows."""

    cluster: int            # CTAs per cluster
    rows_max: int           # the most rows of a cluster (the tiles' size)
    rows: int               # rows of a cluster in this launch
    clusters: int           # clusters launched, at most resident
    row_blocks: tuple       # (row0, nrows) of each row block
    blocks_of: tuple        # per cluster, its row blocks in order
    weights_shared: bool    # weight slices in shared memory
    smem_bytes: int         # dynamic shared memory of a CTA
    scratch_floats: int     # kernel 2's global scratch: u, u_new, g6, k1..k7


def _eval_rows(F: int, H: int) -> tuple:
    """(the most rows of a cluster, whether the weight slices fit) at (F,
    H), as ``solve_cluster.cuh::eval_plan``; raises ValueError where not
    even one row fits a CTA."""
    seg = solve_seg(F)
    weights = seg * vec_ld(H) + H * vec_ld(seg)
    limit = CLUSTER_SMEM_BYTES // 4
    if weights + _eval_tiles(H, SOLVE_ROWS_MAX, seg) <= limit:
        return SOLVE_ROWS_MAX, True
    fits = [r for r in range(SOLVE_ROWS_MAX, 0, -1)
            if _eval_tiles(H, r, seg) <= limit]
    if not fits:
        raise ValueError(
            f"fused_tdmlp: (F, H) = ({F}, {H}) needs "
            f"{4 * _eval_tiles(H, 1, seg)} bytes of shared memory a CTA at "
            f"one row a cluster, over {CLUSTER_SMEM_BYTES}")
    return fits[0], False


def eval_plan(B: int, F: int, H: int, resident: int, rows: int = 0
              ) -> EvalPlan:
    """The grid of kernels 1 and 2: ``rows`` rows a cluster (at most the
    plan's) when positive, else the fewest that fill the ``resident``
    clusters in one wave; never more clusters than are resident (a larger
    batch loops its clusters over the row blocks, cluster c taking blocks
    c, c + clusters, ...). Raises ValueError where not even one row fits a
    CTA."""
    if resident < 1:
        raise ValueError("no cluster can be resident")
    rows_max, shared = _eval_rows(F, H)
    R = (min(rows, rows_max) if rows > 0
         else min(rows_max, -(-B // min(B, resident))))
    row_blocks = tuple((r0, min(R, B - r0)) for r0 in range(0, B, R))
    n = min(len(row_blocks), resident)
    seg = solve_seg(F)
    smem = (seg * vec_ld(H) + H * vec_ld(seg) if shared else 0) + _eval_tiles(
        H, rows_max, seg)
    return EvalPlan(CLUSTER_CTAS, rows_max, R, n, row_blocks,
                    tuple(tuple(range(c, len(row_blocks), n)) for c in range(n)),
                    shared, 4 * smem, 10 * B * CLUSTER_CTAS * seg)


@functools.lru_cache(maxsize=64)
def eval_layout(B: int, F: int, H: int):
    """``eval_plan`` at (B, F, H) with this card's resident clusters (which
    raises for a width no CTA can take, before the library loads), and the
    library, raising unless it lays kernels 1 and 2 out the same way.
    Returns (library, plan)."""
    _eval_rows(F, H)
    lib = _build.load_library()

    def grid(b, rows, step):
        out = (ctypes.c_int * 2)()
        _build.check(lib, lib.lrnde_eval_grid(b, F, H, rows, step, out),
                     "eval_layout")
        return tuple(out)

    plan = eval_plan(B, F, H, grid(1 << 20, 1, 0)[1])
    if ((lib.lrnde_eval_rows(F, H), bool(lib.lrnde_eval_weights_shared(F, H)),
         lib.lrnde_eval_smem_floats(F, H) * 4,
         lib.lrnde_step_scratch_floats(B, F))
            != (plan.rows_max, plan.weights_shared, plan.smem_bytes,
                plan.scratch_floats)
            or {grid(B, 0, 0), grid(B, 0, 1)} != {(plan.rows, plan.clusters)}):
        raise RuntimeError("fused_tdmlp: the library's layout differs from "
                           "eval_plan")
    return lib, plan


def solve_feasible(B: int, F: int, H: int) -> bool:
    """Whether kernel 4 takes (B, F, H): ``solve_plan`` lays it out."""
    try:
        solve_plan(B, F, H)
    except ValueError:
        return False
    return True


def _start(f, u0, t0: float, t_end: float, rtol, atol):
    """k1 at t0 and the first step from the Hairer probe, clipped to the
    span: two evaluations of ``f(u, t)``. Returns (k1_0, dt_init, nfe0)."""
    k1_0 = f(u0, t0)
    t0_dev, span = device_scalars([t0, t_end - t0], u0)
    dt_init, extra = initial_step_size(
        f, u0, t0_dev, order=5, rtol=rtol, atol=atol, f0=k1_0,
    )
    return k1_0, torch.minimum(dt_init, span), 1 + extra


def plain_step(w: TDMLPWeights, tier: str = "fp32"):
    """The plain TD-MLP step at ``tier`` in the eager loop's ``step_fn``
    contract."""

    def step(fn, u, t, dt, k1, f_st):
        u_new, utilde, *ks, g6 = tsit5_step_plain(w, u, t, dt, k1, tier)
        return Tsit5StepResult(u_new, utilde, (k1, *ks), g6, f_st)

    return step


def persistent_tsit5_solve_plain(w: TDMLPWeights, u0, tspan, *, rtol, atol,
                                 saveat_arr, max_steps, record_knots=False,
                                 knot_dense_cap=None, knot_stride=1,
                                 reservoir=None, tier: str = "fp32"):
    """The plain version of the persistent solve: the eager loop of
    ``ode/solve.py`` with the plain TD-MLP step at ``tier``, recording as
    the kernel does (no k1 knots)."""
    check_product_tier(tier, rtol)
    return _plain_solve(
        lambda u, t: tdmlp_plain(w, u, t, tier), u0, tspan, rtol=rtol,
        atol=atol, saveat_arr=saveat_arr, max_steps=max_steps,
        step_fn=plain_step(w, tier), record_knots=record_knots,
        knot_dense_cap=knot_dense_cap, knot_stride=knot_stride,
        reservoir=reservoir,
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
        natt=out["natt"],
    )
    res.update({k: out.get(k) for k in KNOT_FIELDS + RESERVOIR_FIELDS
                if k != "knot_ks"})
    return res


def persistent_tsit5_solve(w: TDMLPWeights, u0: torch.Tensor, tspan, *,
                           rtol: float, atol: float, saveat_arr: torch.Tensor,
                           max_steps: int, record_knots=False,
                           knot_dense_cap=None, knot_stride=1,
                           reservoir=None, precision="highest"):
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
    CTA) at ``precision``'s tier; a CPU tensor runs
    ``persistent_tsit5_solve_plain``. The TF32 tier raises below rtol 1e-4.
    A solve without knots or reservoir (serving) goes through the
    registered operator ``lrnde::tsit5_solve`` (``ops/cuda/serving.py``),
    which dispatches the same way and which ``torch.export`` records.
    """
    check_reservoir(reservoir, max_steps)
    tier = product_tier(precision, u0.device)
    check_product_tier(tier, rtol)
    if not record_knots and reservoir is None:
        from .serving import tsit5_solve

        return tsit5_solve(w, u0, tspan, rtol=rtol, atol=atol,
                           saveat_arr=saveat_arr, max_steps=max_steps,
                           tier=tier)
    rec = dict(record_knots=record_knots, knot_dense_cap=knot_dense_cap,
               knot_stride=knot_stride, reservoir=reservoir)
    if u0.device.type == "cpu":
        return persistent_tsit5_solve_plain(
            w, u0, tspan, rtol=rtol, atol=atol, saveat_arr=saveat_arr,
            max_steps=max_steps, tier=tier, **rec,
        )
    out = _launch_solve(w, u0, tspan, rtol=rtol, atol=atol,
                        saveat_arr=saveat_arr, max_steps=max_steps,
                        tier=tier, **rec)
    count_launch(persistent_tsit5_solve, tier)
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
                  reservoir=None, timing=None, scratch=None, tier="fp32"):
    """One launch of kernel 4 on CUDA tensors at ``tier`` (its start, k1
    and the Hairer probe, through kernel 1 at the same tier); with
    ``timing`` (int64,
    ``lrnde_solve_phases() + 1``) the instantiation with the compile-time
    clock, which fills it with CTA 0's nanoseconds per phase and the number
    of attempts. ``scratch`` (``plan.scratch_floats``), when given, is the
    kernel's global scratch, so that a check can read its buffers after
    the launch: u, u_new and k1..k7 in the segment layout (each (B, 8 ·
    seg); accepting swaps only the kernel's pointers). The dict also holds
    ``stats``, the kernel's int32 counters (naccept, nreject, success,
    attempts), which the serving operator returns whole."""
    check_fp32_products(rtol, u0.device)
    B, F, H = check_operands(w, u0)
    lib, plan = _solve_layout(B, F, H)
    t0, t_end = float(tspan[0]), float(tspan[1])
    k1_0, dt_init, nfe0 = _start(lambda u, t: tdmlp_at(w, u, t, tier), u0,
                                 t0, t_end, rtol, atol)
    sc = device_scalars([t0, t_end, dt_init], u0)
    saveat = saveat_arr.to(device=u0.device, dtype=torch.float32).contiguous()
    n_save = saveat.shape[0]

    n_blocks = -(-B // SOLVE_ERROR_ROWS)
    dev = u0.device
    y_final = torch.empty_like(u0)
    ys = torch.empty((n_save, B, F), dtype=torch.float32, device=dev)
    stats_i = torch.empty(4, dtype=torch.int32, device=dev)
    stats_f = torch.empty(2, dtype=torch.float32, device=dev)
    if scratch is None:
        scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                              device=dev)
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
    if tier == "tf32":
        if timing is not None:
            raise ValueError("the TF32 solve has no clocked instantiation")
        entry = lib.lrnde_persistent_tsit5_tf32
    elif timing is not None:
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
        t_final=stats_f[0], ts=saveat_arr, stats=stats_i, **knots,
        **(dict(reservoir_t=stats_f[1], reservoir_u=res_u)
           if res_u is not None else {}),
    )


persistent_tsit5_solve.tier_launches = {}


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


def frag_floats(M: int, K: int) -> int:
    """Floats of an M × K weight's TF32 fragment copy: 16-row m-tiles by
    8-deep k-steps of 128 floats (``csrc/tf32.cuh::frag_floats``)."""
    return -(-M // 16) * -(-K // 8) * 128


def chain_frag_floats(dims, transposed: bool = False) -> int:
    """Floats of a layered network's fragment copies: the forward's W_lᵀ
    (d_{l+1} × d_l) or the transpose's W_l (``csrc/chain_rows.cuh::
    chain_frag_floats``)."""
    return sum(frag_floats(dims[l], dims[l + 1]) if transposed
               else frag_floats(dims[l + 1], dims[l])
               for l in range(len(dims) - 1))


def chain_smem_floats(dims, J: int, sweep: bool = False,
                      tiers: tuple = ("fp32",) * 3) -> int:
    """A CTA's dynamic shared memory (floats) at J error blocks: kernel 5's
    (``chain_solve_smem_floats``) or kernel 9's
    (``chain_sweep_smem_floats``). The weights are held as W_lᵀ with b_l
    (the forward) and, in kernel 9, as W_l (the transpose), each row padded
    to ``vec_ld`` (``csrc/chain_rows.cuh::ChainLayout``). At the TF32 tiers
    (replay or forward, recompute, gradients; kernel 5 reads the first) the
    fragment copies follow: the forward's for a TF32 forward, replay or
    recompute, the transpose's for TF32 gradients."""
    L, F, R = len(dims) - 1, dims[0], CHAIN_ROWS
    n_params = sum(dims[l] * dims[l + 1] + dims[l + 1] for l in range(L))
    fwd = sum(dims[l + 1] * vec_ld(dims[l]) + round4(dims[l + 1])
              for l in range(L))
    aw = round4(max(dims))
    blocks = J * (9 * R * F + R * F)
    if not sweep:
        n = fwd + 2 * R * aw + blocks
        return (round4(n) + chain_frag_floats(dims) if tiers[0] == "tf32"
                else n)
    rev = sum(dims[l] * vec_ld(dims[l + 1]) for l in range(L))
    n = (fwd + rev + round4(n_params)
         + R * (6 * _stage_stash(dims) + 15 * round4(F) + 2 * aw)
         + blocks + 8 * CHAIN_MAX_SAVE)
    if "tf32" not in tiers:
        return n
    return (round4(n) + ("tf32" in tiers[:2]) * chain_frag_floats(dims)
            + (tiers[2] == "tf32") * chain_frag_floats(dims, True))


def chain_plan(B: int, dims, resident, *, sweep=False,
               two_level=True, tiers: tuple = ("fp32",) * 3) -> ChainPlan:
    """The grid of kernel 5 (or, with ``sweep``, kernel 9) for B rows at
    the product ``tiers`` (``chain_smem_floats``): CTAs of ``CHAIN_ROWS``
    warps, each owning J consecutive error blocks of ``CHAIN_ROWS`` rows, J
    the least that lets every CTA be resident at once, where
    ``resident(smem_bytes)`` is the CTAs an H100 holds at that shared
    memory (the card's occupancy query). Kernel 9's dense mode needs no
    residency: a CTA a block. Raises ValueError where no J fits."""
    n_blk = -(-B // CHAIN_ROWS)
    max_J = CHAIN_SWEEP_MAX_J if sweep else CHAIN_MAX_J
    if sweep and not two_level:
        max_J = 1
    for J in range(1, max_J + 1):
        smem = 4 * chain_smem_floats(dims, J, sweep, tiers)
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


def chain_eval(params, chain: DenseChainSpec, x: torch.Tensor,
               tier: str = "fp32", grad_tier: Optional[str] = None
               ) -> torch.Tensor:
    """The plain chain evaluation (the reference's ``chain_eval_pure``):
    k1_0, the dt probe, and the plain versions of kernels 5 and 9; its
    products at ``tier`` and under autograd their transposes at
    ``grad_tier`` (default ``tier``; ``nn.basic.tier_matmul``)."""
    a = torch.tanh(x) if chain.lead else x
    for i, act in enumerate(chain.acts):
        z = tier_matmul(a, params[2 * i], tier, grad_tier) + params[2 * i + 1]
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
def smem_bytes(dims: tuple, query) -> int:
    """A CTA's dynamic shared memory for the network of widths ``dims``
    (the Dense chain's or the score chain's), from the library's C size
    query ``query`` (or ``(query, tier bits)`` for a tiered one); asked
    once per network."""
    lib = _build.load_library()
    L = len(dims) - 1
    arr = (ctypes.c_int * (L + 1))(*dims)
    lead = ()
    if isinstance(query, tuple):
        query, bits = query
        lead = (bits,)
    return 4 * getattr(lib, query)(*lead, ctypes.cast(arr, ctypes.c_void_p),
                                   L)


def chain_limits(chain: DenseChainSpec, n_save=None, *, cuda=True,
                 tiers: tuple = ("fp32",) * 3) -> Optional[str]:
    """Why the chain kernels cannot take ``chain``, or None when they can:
    kernel 5 alone, or kernels 5 and 9 for a sweep of ``n_save`` saveat
    times, at the product ``tiers`` (replay or forward, recompute,
    gradients). The limits: 1 to ``CHAIN_MAX_LAYERS`` layers, at most
    ``CHAIN_MAX_SAVE`` saveat times in the sweep, and each kernel's shared
    memory within ``CHAIN_SMEM_BYTES`` (left out with ``cuda=False``, where
    the plain versions run)."""
    from .fused_mlp_bwd import tier_bits

    L = len(chain.dims) - 1
    if not 1 <= L <= CHAIN_MAX_LAYERS:
        return f"chain: {L} layers, the kernels take 1 to {CHAIN_MAX_LAYERS}"
    queries = ["lrnde_chain_solve_smem_floats"
               + ("_tf32" if tiers[0] == "tf32" else "")]
    if n_save is not None:
        if n_save > CHAIN_MAX_SAVE:
            return (f"{n_save} saveat times, kernel 9 takes at most "
                    f"{CHAIN_MAX_SAVE}")
        bits = tier_bits(replay=tiers[0], recompute=tiers[1], grad=tiers[2])
        queries.append(("lrnde_chain_sweep_smem_floats_tiered", bits) if bits
                       else "lrnde_chain_sweep_smem_floats")
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
                         n_save=None, tiers=("fp32",) * 3) -> tuple:
    """Validate the chain's kernel operands: float32, contiguous, on one
    CUDA device, states (B, F), weights matching ``chain.dims``, and the
    chain (with a sweep's ``n_save``) inside ``chain_limits`` at
    ``tiers``. Returns (B, F)."""
    B, F = states[0].shape
    reason = chain_limits(chain, n_save, tiers=tiers)
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
                                 knot_stride=1, reservoir=None,
                                 tier: str = "fp32"):
    """The plain version of kernel 5: the eager loop of ``ode/solve.py``
    (``adaptive_loop``) with the generic Tsit5 step of the plain chain at
    the resolved ``tier``, recording as the kernel does (no k1 knots)."""
    check_product_tier(tier, rtol)
    return _plain_solve(
        lambda u, t: chain_eval(params, chain, u, tier), u0, tspan, rtol=rtol,
        atol=atol, saveat_arr=saveat_arr, max_steps=max_steps,
        record_knots=record_knots, knot_dense_cap=knot_dense_cap,
        knot_stride=knot_stride, reservoir=reservoir,
    )


def persistent_chain_solve(params, chain: DenseChainSpec, u0: torch.Tensor,
                           tspan, *, rtol: float, atol: float,
                           saveat_arr: torch.Tensor, max_steps: int,
                           record_knots=False, knot_dense_cap=None,
                           knot_stride=1, reservoir=None,
                           precision="highest"):
    """Run the whole adaptive solve of ``du/dt = chain(u)`` (kernel 5), its
    products (the kernel's and the start's) at ``precision``.

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
    return u0. A TF32 solve below rtol 1e-4 raises
    (``check_product_tier``). A solve without knots or reservoir (the eval
    route, serving) goes through the registered operator
    ``lrnde::chain_solve`` (``ops/cuda/serving.py``), which dispatches the
    same way and which ``torch.export`` records.
    """
    tier = product_tier(precision, u0.device)
    check_product_tier(tier, rtol)
    check_reservoir(reservoir, max_steps)
    if not record_knots and reservoir is None:
        from .serving import chain_solve

        return chain_solve(params, chain, u0, tspan, rtol=rtol, atol=atol,
                           saveat_arr=saveat_arr, max_steps=max_steps,
                           tier=tier)
    rec = dict(record_knots=record_knots, knot_dense_cap=knot_dense_cap,
               knot_stride=knot_stride, reservoir=reservoir)
    if u0.device.type == "cpu":
        return persistent_chain_solve_plain(
            params, chain, u0, tspan, rtol=rtol, atol=atol,
            saveat_arr=saveat_arr, max_steps=max_steps, tier=tier, **rec,
        )
    out = _launch_chain(params, chain, u0, tspan, rtol=rtol, atol=atol,
                        saveat_arr=saveat_arr, max_steps=max_steps, tier=tier,
                        **rec)
    count_launch(persistent_chain_solve, tier)
    return out


def _launch_chain(params, chain, u0, tspan, *, rtol, atol, saveat_arr,
                  max_steps, record_knots=False, knot_dense_cap=None,
                  knot_stride=1, reservoir=None, timing=None, tier="fp32"):
    """One launch of kernel 5 on CUDA tensors at the resolved ``tier``; with
    ``timing`` (int64, one entry a phase of
    ``lrnde_chain_solve_phase_names`` and one more; FP32 only) the
    instantiation with the compile-time clock, which fills it with CTA 0's
    nanoseconds per phase and the number of attempts."""
    check_fp32_products(rtol, u0.device)
    check_product_tier(tier, rtol)
    tf32 = tier == "tf32"
    if tf32 and timing is not None:
        raise ValueError("kernel 5 has no clocked TF32 instantiation")
    B, F = check_chain_operands(params, chain, u0, tiers=(tier,) * 3)
    lib = _build.load_library()
    chain_args = chain_operands(params, chain)
    t0, t_end = float(tspan[0]), float(tspan[1])
    k1_0, dt_init, nfe0 = _start(
        lambda u, t: chain_eval(params, chain, u, tier), u0, t0, t_end, rtol,
        atol)
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
    entry, clock = (lib.lrnde_persistent_chain_tf32 if tf32
                    else lib.lrnde_persistent_chain), []
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
        t_final=stats_f[0], ts=saveat_arr, stats=stats_i, **knots,
        **(dict(reservoir_t=stats_f[1], reservoir_u=res_u)
           if res_u is not None else {}),
    )


persistent_chain_solve.tier_launches = {}


# ---------------------------------------------------------------------------
# kernel 6: the probability-flow ODE of the score sampler

# csrc/pf_solve.cu: the rows of an error block (one slot of the error norm,
# the first port's CTA), the first port's CTA width whose block sum the
# error partial keeps, the rows a warp carries (score_rows.cuh::
# kScoreWarpRows), the warps of a CTA and the most error blocks a CTA takes
PF_ERROR_ROWS = 8
PF_OLD_THREADS = 128
PF_WARP_ROWS = 4
PF_WARPS = 8
PF_THREADS = 32 * PF_WARPS
PF_MAX_J = 128
# streaming multiprocessors of an H100 SXM
H100_SMS = 132


class PfPlan(NamedTuple):
    """The grid of kernel 6 at B rows, as ``csrc/pf_solve.cu::pf_grid``
    computes it: CTAs of ``PF_WARPS`` warps, CTA g owning the J error blocks
    from g·J, warp w of it the 4-row groups q ≡ w (mod ``PF_WARPS``) of
    them (group q: block q // 2, rows 4·(q % 2) ... of it)."""

    J: int                 # error blocks a CTA
    grid: int              # CTAs
    blocks: tuple          # per CTA: its error blocks (first, count)
    threads: int
    smem_bytes: int        # dynamic shared memory of a CTA


def pf_smem_floats(dims, J: int, tier: str = "fp32") -> int:
    """A kernel-6 CTA's dynamic shared memory (floats) at J error blocks:
    the network (W_lᵀ with rows of ``vec_ld(d_l)`` floats, the time row and
    the bias, each padded to 4; ``csrc/score_rows.cuh::score_layout``; at
    the TF32 ``tier`` then the layers' fragment copies), each warp's
    stage-input rows (padded to 4) and two activation buffers (rows of
    ``vec_ld`` of the widest layer), the blocks' state (u, k1..k7, u_new)
    and scaled residuals."""
    L, F = len(dims) - 1, dims[0]
    net = sum(dims[l + 1] * vec_ld(dims[l]) + 2 * round4(dims[l + 1])
              for l in range(L))
    if tier == "tf32":
        net += chain_frag_floats(dims)
    warps = PF_WARPS * PF_WARP_ROWS * (round4(F) + 2 * vec_ld(max(dims)))
    return net + warps + J * 10 * PF_ERROR_ROWS * F


def pf_plan(B: int, dims, resident, n_sm: int = H100_SMS,
            tier: str = "fp32") -> PfPlan:
    """The grid of kernel 6 for B rows at ``tier``: J error blocks a CTA,
    the least that keeps the grid within one CTA an SM (fewer grid arrivals
    an attempt), raised until every CTA is resident at once, where
    ``resident(smem_bytes)`` is the CTAs the card holds at that shared
    memory (the occupancy query). Raises ValueError where no J up to
    ``PF_MAX_J`` fits."""
    n_blk = -(-B // PF_ERROR_ROWS)
    for J in range(max(1, -(-n_blk // n_sm)), PF_MAX_J + 1):
        smem = 4 * pf_smem_floats(dims, J, tier)
        if smem > CHAIN_SMEM_BYTES or resident(smem) <= 0:
            break
        grid = -(-n_blk // J)
        if grid <= resident(smem):
            blocks = tuple((g * J, min(J, n_blk - g * J))
                           for g in range(grid))
            return PfPlan(J, grid, blocks, PF_THREADS, smem)
    raise ValueError(f"score chain {tuple(dims)}: B = {B} does not fit the "
                     f"resident CTAs of kernel 6")


def pf_dynamics(params, chain, beta_min, beta_max, t1, tier: str = "fp32"):
    """Kernel 6's dynamics on the τ clock, ``f(u, τ)``: with t = t1 − τ and
    β = β_min + t·Δβ, ½β·(u + s_θ(u, t)) (the reference sampler's
    −(−½β·(u + s)), rounded alike; the score's products at ``tier``)."""
    from .fused_sde_solve import td_score_eval_plain

    d_beta = float(beta_max) - float(beta_min)

    def f(u, tau):
        t = float(t1) - device_scalar(tau, u)
        b = float(beta_min) + t * d_beta
        return (0.5 * b) * (u + td_score_eval_plain(params, chain, u, t,
                                                     tier))

    return f


def persistent_pf_solve_plain(params, chain, u0, tspan, *, rtol, atol,
                              saveat_arr, max_steps, beta_min, beta_max, t1,
                              tier: str = "fp32"):
    """The plain version of kernel 6: the eager loop of ``ode/solve.py``
    with the plain score chain at the resolved ``tier``."""
    check_product_tier(tier, rtol)
    return _plain_solve(
        pf_dynamics(params, chain, beta_min, beta_max, t1, tier), u0, tspan,
        rtol=rtol, atol=atol, saveat_arr=saveat_arr, max_steps=max_steps,
    )


def persistent_pf_solve(params, chain, u0: torch.Tensor, tspan, *,
                        rtol: float, atol: float, saveat_arr: torch.Tensor,
                        max_steps: int, beta_min: float, beta_max: float,
                        t1: float, precision="highest"):
    """Run the whole adaptive Tsit5 solve of the probability-flow ODE
    (kernel 6), the score's products at ``precision``.

    ``params`` are the score chain's ``[W_0, b_0, ...]`` and ``chain`` its
    ``fused_sde_solve.match_td_score_chain`` spec. The return dict of
    ``persistent_tsit5_solve`` without knots or reservoir. As in the
    reference, k1 and the Hairer probe run outside the kernel, so NFE =
    1 + 1 + 6·attempts. A CUDA tensor launches the kernel; a CPU tensor runs
    ``persistent_pf_solve_plain``, both through the registered operator
    ``lrnde::pf_solve`` (``ops/cuda/serving.py``), which ``torch.export``
    records. Any batch size and number of saveat times. A TF32 solve below
    rtol 1e-4 raises (``check_product_tier``).
    """
    tier = product_tier(precision, u0.device)
    check_product_tier(tier, rtol)
    from .serving import pf_solve

    return pf_solve(params, chain, u0, tspan, rtol=rtol, atol=atol,
                    saveat_arr=saveat_arr, max_steps=max_steps,
                    beta_min=beta_min, beta_max=beta_max, t1=t1, tier=tier)


def _launch_pf(params, chain, u0, tspan, *, rtol, atol, saveat_arr,
               max_steps, beta_min, beta_max, t1, tier="fp32"):
    """One launch of kernel 6 on CUDA tensors at ``tier`` (its start, k1
    and the Hairer probe, through the plain score chain at the same
    tier), with ``stats`` as ``_launch_solve``'s."""
    from .fused_sde_solve import check_score_operands, score_operands

    check_fp32_products(rtol, u0.device)
    check_product_tier(tier, rtol)
    tf32 = tier == "tf32"
    query = "lrnde_pf_solve_smem_floats" + ("_tf32" if tf32 else "")
    B, F = check_score_operands(params, chain, u0, query)
    lib = _build.load_library()
    if (lib.lrnde_pf_error_rows(), lib.lrnde_pf_solve_threads(),
            lib.lrnde_pf_warp_rows(), smem_bytes(chain.dims, query)) != (
            PF_ERROR_ROWS, PF_THREADS, PF_WARP_ROWS,
            4 * pf_smem_floats(chain.dims, 1, tier)):
        raise RuntimeError("persistent_pf_solve: the library's layout "
                           "differs from pf_plan's")
    t0, t_end = float(tspan[0]), float(tspan[1])
    k1_0, dt_init, nfe0 = _start(
        pf_dynamics(params, chain, beta_min, beta_max, t1, tier), u0, t0,
        t_end, rtol, atol)
    sc = device_scalars([t0, t_end, dt_init], u0)
    saveat = saveat_arr.to(device=u0.device, dtype=torch.float32).contiguous()
    n_save = saveat.shape[0]
    n_blocks = -(-B // PF_ERROR_ROWS)
    dev = u0.device
    y_final = torch.empty_like(u0)
    ys = torch.empty((n_save, B, F), dtype=torch.float32, device=dev)
    stats_i = torch.empty(4, dtype=torch.int32, device=dev)
    stats_f = torch.empty(1, dtype=torch.float32, device=dev)
    slots = torch.empty(2 * n_blocks, dtype=torch.float32, device=dev)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    p = _build.ptr
    entry = lib.lrnde_persistent_pf_tf32 if tf32 else lib.lrnde_persistent_pf
    err = entry(
        p(u0), p(k1_0), p(sc), p(saveat), n_save,
        *score_operands(params, chain, beta_min, beta_max, t1),
        p(y_final), p(ys), p(stats_i), p(stats_f), p(slots), p(barrier), B,
        int(max_steps), float(rtol), float(atol), 1.0 / float(B * F),
        _build.stream_ptr(dev),
    )
    _build.check(lib, err, "persistent_pf_solve")
    return dict(
        y_final=y_final, ys=ys, naccept=stats_i[0], nreject=stats_i[1],
        success=stats_i[2].bool(), nfe=nfe0 + 6 * stats_i[3],
        t_final=stats_f[0], ts=saveat_arr, stats=stats_i,
    )


persistent_pf_solve.tier_launches = {}
