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

Returns ``(a_u, a_k, d_w)``: the state cotangent at t0, the cotangent on
k1_0 (the caller closes it through the VJP of f(u0, t0)), and the weight
gradients as ``TDMLPWeights``. The plain versions are the eager sweeps of
``ode/stored_adjoint.py`` with the plain step and its autograd VJP; a
replay repeats the plain forward (``persistent_tsit5_solve_plain``) there.
"""
from __future__ import annotations

import ctypes

import torch

from ...ode.stored_adjoint import eager_sweep
from . import _build
from .fused_mlp import TDMLPWeights, check_operands, tdmlp_plain
from .fused_mlp_bwd import (
    fused_step_bwd_plain,
    split_weight_grad,
    weight_grad_size,
)
from .fused_solve import plain_step


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
            return_replay=False):
    ct_ys, ct_y = ct_ys.contiguous(), ct_y.contiguous()
    if not knot_us.is_contiguous():
        raise ValueError("knot_us: needs a contiguous buffer")
    B, F, H = check_operands(w, ct_y, *ct_ys, *knot_us[:1])
    dev = ct_y.device
    lib = _build.load_library()
    rows = lib.lrnde_rows_per_block()
    n_blocks = -(-B // rows)
    two_level = tl is not None
    stride = int(tl["stride"]) if two_level else 1
    saveat = saveat_arr.to(device=dev, dtype=torch.float32).contiguous()
    knot_ts = knot_ts.contiguous()
    naccept = naccept.to(device=dev, dtype=torch.int32).reshape(1)
    a_u, a_k = torch.empty_like(ct_y), torch.empty_like(ct_y)
    d_w = torch.empty(weight_grad_size(F, H), device=dev)
    scratch = torch.empty(lib.lrnde_sweep_scratch_floats(B, F, H),
                          device=dev)
    part = torch.empty((n_blocks, weight_grad_size(F, H)), device=dev)
    p = _build.ptr
    null = ctypes.c_void_p(0)
    if two_level:
        slots = torch.empty(2 * n_blocks, device=dev)
        barrier = torch.zeros(1, dtype=torch.int32, device=dev)
        local_ts = torch.empty(n_blocks * (stride + 1), device=dev)
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
    err = lib.lrnde_adjoint_sweep(
        int(two_level), *[p(x) for x in w], p(knot_ts),
        p(knot_us), p(naccept), p(saveat), saveat.shape[0],
        p(ct_ys), p(ct_y), *ck, t_end, rtol, atol, max_steps,
        stride, dense_cap, p(a_u), p(a_k), p(d_w), p(scratch), p(part),
        *extra, B, F, H, 1.0 / float(B * F), _build.stream_ptr(dev),
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
