"""The whole stored-adjoint sweep of the NeuralDSDE family in one CUDA
launch.

Counterpart of ``localregneuralde_tpu/ops/pallas/fused_sde_sweep.py``
(``persistent_sde_sweep``). The kernel (``csrc/sde_sweep.cu``) transposes
the ``naccept`` recorded SRI steps in reverse, reading ``naccept`` on the
device: per step it recomputes the stages from the knot ``(u, dW, dZ)``,
splits the saveat cotangents linearly, reverses through the stage structure
and adds the stage-batched weight gradients to a per-CTA partial; a second
kernel sums the partials in CTA order. Any forward's knots will do, since
the increments are recorded. ``sde_sweep_plan`` mirrors its CTA layout: a
CTA a block of ``SDE_ROWS`` rows, twelve warps in two groups (the H-wide
outputs of a product on one, the diffusion outputs beside them on the
other), and its shared memory.

Returns ``(a_u, d_w)``: the state cotangent at t0 and the weight gradients
as ``SDEWeights``. The plain version is the eager sweep of
``sde/stored_adjoint.py`` with the autograd VJP of the plain step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...sde.stored_adjoint import autograd_step_vjp, eager_sde_sweep
from . import _build
from .fused_sde_solve import (
    SDE_HID_THREADS,
    SDE_ROWS,
    SDE_SMEM_BYTES,
    SDE_THREADS,
    SDEWeights,
    check_sde_operands,
    diffusion_plain,
    drift_plain,
)




class SdeSweepPlan(NamedTuple):
    """Kernel 12's CTA layout at (B, F, H), as ``csrc/sde_sweep.cu`` lays it
    out: one CTA a block of ``rows`` rows; thread ``t`` of the hidden group
    takes the H-wide outputs ``i ≡ t (mod hid_threads)`` of a product, the
    diffusion group's thread ``t`` the F-wide diffusion outputs ``i ≡ t −
    hid_threads (mod threads − hid_threads)``, and every thread the drift
    outputs and gradient elements ``i ≡ t (mod threads)``."""

    rows: int
    ctas: int
    threads: int
    hid_threads: int
    smem_bytes: int
    grad_floats: int


def sde_grad_floats(F: int, H: int) -> int:
    """Floats of one flat weight gradient (dW1, db1, dW2, db2, dWd, dbd)."""
    return F * H + H + H * F + F + F * F + F


def sde_sweep_plan(B: int, F: int, H: int) -> SdeSweepPlan:
    """The CTA layout of kernel 12; raises ValueError where a CTA's shared
    memory (the weights, the gradient partial, the row block's stage
    buffers) exceeds an H100's block."""
    R = SDE_ROWS
    smem = 4 * (F * (H + 1) + H + H * (F + 1) + F + F * (F + 1) + F
                + sde_grad_floats(F, H) + 7 * R * F + 24 * R * F + 8 * R * H)
    if smem > SDE_SMEM_BYTES:
        raise ValueError(
            f"persistent_sde_sweep: F={F}, H={H} needs {smem} bytes of "
            f"shared memory a CTA, over {SDE_SMEM_BYTES} (the weights and "
            f"the gradient partial stay in shared memory)")
    return SdeSweepPlan(R, -(-B // R), SDE_THREADS, SDE_HID_THREADS, smem,
                        sde_grad_floats(F, H))


def persistent_sde_sweep_plain(w: SDEWeights, knot_ts, knot_us, knot_dws,
                               knot_dzs, naccept, saveat_arr, ct_ys, ct_y, *,
                               solver, delta):
    """The plain version: the eager sweep with the plain family."""
    step_vjp = autograd_step_vjp(
        lambda u, t, p: drift_plain(SDEWeights(*p), u),
        lambda u, t, p: diffusion_plain(SDEWeights(*p), u),
        solver=solver, delta=delta, atol=1.0, rtol=1.0,
    )
    a_u, a_p = eager_sde_sweep(step_vjp, list(w), knot_ts, knot_us, knot_dws,
                               knot_dzs, naccept, saveat_arr, ct_ys, ct_y)
    return a_u, SDEWeights(*a_p)


def split_sde_grad(d_w: torch.Tensor, F: int, H: int) -> SDEWeights:
    """The flat gradient (dW1, db1, dW2, db2, dWd, dbd) as SDEWeights."""
    sizes = [F * H, H, H * F, F, F * F, F]
    shapes = [(F, H), (H,), (H, F), (F,), (F, F), (F,)]
    parts = torch.split(d_w, sizes)
    return SDEWeights(*(x.reshape(s) for x, s in zip(parts, shapes)))


def persistent_sde_sweep(w: SDEWeights, knot_ts, knot_us, knot_dws, knot_dzs,
                         naccept, saveat_arr, ct_ys, ct_y, *, solver, delta):
    """The sweep over ``naccept`` recorded steps (kernel 12) for CUDA
    tensors; ``persistent_sde_sweep_plain`` for CPU tensors."""
    if ct_y.device.type == "cpu":
        return persistent_sde_sweep_plain(
            w, knot_ts, knot_us, knot_dws, knot_dzs, naccept, saveat_arr,
            ct_ys, ct_y, solver=solver, delta=delta)
    ct_ys, ct_y = ct_ys.contiguous(), ct_y.contiguous()
    B, F, H = check_sde_operands(w, ct_y, *ct_ys)
    for name, k in (("knot_us", knot_us), ("knot_dws", knot_dws),
                    ("knot_dzs", knot_dzs)):
        if not k.is_contiguous() or tuple(k.shape[1:]) != (B, F):
            raise ValueError(f"{name}: needs a contiguous (n, {B}, {F}) buffer")
    dev = ct_y.device
    plan = sde_sweep_plan(B, F, H)
    lib = _build.load_library()
    if (lib.lrnde_sde_rows_per_block(), lib.lrnde_sde_sweep_threads(),
            lib.lrnde_sde_sweep_hid_threads(),
            4 * lib.lrnde_sde_sweep_smem_floats(F, H),
            lib.lrnde_sde_grad_floats(F, H)) != (
            plan.rows, plan.threads, plan.hid_threads, plan.smem_bytes,
            plan.grad_floats):
        raise RuntimeError("persistent_sde_sweep: the library's layout "
                           "differs from sde_sweep_plan")
    saveat = saveat_arr.to(device=dev, dtype=torch.float32).contiguous()
    naccept = naccept.to(device=dev, dtype=torch.int32).reshape(1)
    a_u = torch.empty_like(ct_y)
    d_w = torch.empty(plan.grad_floats, device=dev)
    part = torch.empty((plan.ctas, plan.grad_floats), device=dev)
    knot_ts = knot_ts.contiguous()
    p = _build.ptr
    err = lib.lrnde_sde_sweep(
        int(solver == "sosri"), *[p(x) for x in w], p(knot_ts),
        p(knot_us), p(knot_dws), p(knot_dzs), p(naccept), p(saveat),
        saveat.shape[0], p(ct_ys), p(ct_y), p(a_u), p(d_w), p(part), B, F, H,
        _build.stream_ptr(dev),
    )
    _build.check(lib, err, "persistent_sde_sweep")
    persistent_sde_sweep.launches += 1
    return a_u, split_sde_grad(d_w, F, H)


persistent_sde_sweep.launches = 0
