"""The whole adaptive Tsit5 solve of the TD-MLP dynamics in one CUDA launch.

Counterpart of ``localregneuralde_tpu/ops/pallas/fused_solve.py``
(``persistent_tsit5_solve``, family ``("tdmlp",)``), for inference and as
the stored adjoint's forward: the accept/reject loop, PI control, the
shared-batch RMS error norm and the speculative saveat output with its
post-loop revert run in one cooperative kernel
(``csrc/persistent_solve.cu``). As in the reference, the initial
derivative k1 and the Hairer initial dt are computed outside, through the
fused dynamics kernel (2 NFE), and NFE = 2 + 6·attempts.

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
"""
from __future__ import annotations

import ctypes

import torch

from ...ode.controller import initial_step_size
from ...ode.solve import (
    KNOT_FIELDS,
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


def _start(tdmlp, w: TDMLPWeights, u0, t0: float, t_end: float, rtol, atol):
    """k1 at t0 and the first step from the Hairer probe, clipped to the
    span: two evaluations of ``tdmlp``. Returns (k1_0, dt_init, nfe0)."""
    k1_0 = tdmlp(w, u0, t0)
    t0_dev, span = device_scalars([t0, t_end - t0], u0)
    dt_init, extra = initial_step_size(
        lambda u, t: tdmlp(w, u, t), u0, t0_dev, order=5, rtol=rtol,
        atol=atol, f0=k1_0,
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
    t0, t_end = float(tspan[0]), float(tspan[1])
    k1_0, dt_init, nfe0 = _start(tdmlp_plain, w, u0, t0, t_end, rtol, atol)
    out = adaptive_loop(
        None, u0, k1_0, None, t0, t_end, dt_init, saveat=saveat_arr,
        rtol=rtol, atol=atol, max_steps=max_steps, step_fn=plain_step(w),
        record_knots=record_knots, knot_dense_cap=knot_dense_cap,
        knot_stride=knot_stride, reservoir=reservoir,
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
    ``reservoir_t`` and ``reservoir_u``. A CUDA tensor launches the kernel;
    a CPU tensor runs ``persistent_tsit5_solve_plain``.
    """
    check_reservoir(reservoir, max_steps)
    rec = dict(record_knots=record_knots, knot_dense_cap=knot_dense_cap,
               knot_stride=knot_stride, reservoir=reservoir)
    if u0.device.type == "cpu":
        return persistent_tsit5_solve_plain(
            w, u0, tspan, rtol=rtol, atol=atol, saveat_arr=saveat_arr,
            max_steps=max_steps, **rec,
        )
    B, F, H = check_operands(w, u0)
    t0, t_end = float(tspan[0]), float(tspan[1])
    k1_0, dt_init, nfe0 = _start(fused_tdmlp, w, u0, t0, t_end, rtol, atol)
    sc = device_scalars([t0, t_end, dt_init], u0)
    saveat = saveat_arr.to(device=u0.device, dtype=torch.float32).contiguous()
    n_save = saveat.shape[0]

    lib = _build.load_library()
    n_blocks = -(-B // lib.lrnde_rows_per_block())
    dev = u0.device
    y_final = torch.empty_like(u0)
    ys = torch.empty((n_save, B, F), dtype=torch.float32, device=dev)
    stats_i = torch.empty(4, dtype=torch.int32, device=dev)
    stats_f = torch.empty(2, dtype=torch.float32, device=dev)
    scratch = torch.empty((8, B, F), dtype=torch.float32, device=dev)
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
    err = lib.lrnde_persistent_tsit5(
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
        _build.stream_ptr(dev),
    )
    _build.check(lib, err, "persistent_tsit5_solve")
    persistent_tsit5_solve.launches += 1
    return dict(
        y_final=y_final, ys=ys, naccept=stats_i[0], nreject=stats_i[1],
        success=stats_i[2].bool(), nfe=nfe0 + 6 * stats_i[3],
        t_final=stats_f[0], ts=saveat_arr, **knots,
        **(dict(reservoir_t=stats_f[1], reservoir_u=res_u)
           if res_u is not None else {}),
    )


persistent_tsit5_solve.launches = 0


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
