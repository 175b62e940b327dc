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

Tiers, as the reference's ``persistent_sde_sweep``: ``precision`` is the
stage recompute's, ``grad_precision`` the eight transposed products' and
the three weight-gradient contractions' (``'match'``: ``precision``'s;
``fused_mlp_bwd.step_bwd_tiers``). ``NeuralDSDE`` passes its forward's
precision and ``grad_precision=None``, the default tier, whatever the
forward's, as the reference does. The defaults keep the FP32 kernel. The
kernel takes every pair of tiers (``lrnde_sde_sweep``'s first argument,
``fused_mlp_bwd.tier_bits``); ``persistent_sde_sweep.tier_launches``
counts its launches by ``recompute/gradients`` tier.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...sde.stored_adjoint import autograd_step_vjp, eager_sde_sweep
from . import _build
from .fused_mlp import count_launch
from .fused_mlp_bwd import step_bwd_tiers, tier_bits
from .fused_sde_solve import (
    SDE_HID_THREADS,
    SDE_ROWS,
    SDE_SMEM_BYTES,
    SDE_THREADS,
    SDEWeights,
    check_sde_operands,
    diffusion_plain,
    drift_plain,
    frag_set_floats,
)
from .fused_solve import round4


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


def sde_sweep_plan(B: int, F: int, H: int, tier: str = "fp32",
                   grad_tier: str = "fp32") -> SdeSweepPlan:
    """The CTA layout of kernel 12 at the recompute's ``tier`` and the
    gradients' ``grad_tier``; raises ValueError where a CTA's shared memory
    (the weights, the gradient partial, the row block's stage buffers, and
    one set of TF32 fragment copies for each TF32 tier, 16-byte aligned
    after them) exceeds an H100's block."""
    R = SDE_ROWS
    floats = (F * (H + 1) + H + H * (F + 1) + F + F * (F + 1) + F
              + sde_grad_floats(F, H) + 7 * R * F + 24 * R * F + 8 * R * H)
    n_sets = (tier == "tf32") + (grad_tier == "tf32")
    if n_sets:
        floats = round4(floats) + n_sets * frag_set_floats(F, H)
    smem = 4 * floats
    if smem > SDE_SMEM_BYTES:
        raise ValueError(
            f"persistent_sde_sweep: F={F}, H={H} needs {smem} bytes of "
            f"shared memory a CTA, over {SDE_SMEM_BYTES} (the weights and "
            f"the gradient partial stay in shared memory)")
    return SdeSweepPlan(R, -(-B // R), SDE_THREADS, SDE_HID_THREADS, smem,
                        sde_grad_floats(F, H))


def persistent_sde_sweep_plain(w: SDEWeights, knot_ts, knot_us, knot_dws,
                               knot_dzs, naccept, saveat_arr, ct_ys, ct_y, *,
                               solver, delta, tier: str = "fp32",
                               grad_tier=None):
    """The plain version: the eager sweep with the plain family, each
    step's recompute at the resolved ``tier`` and its ``autograd_step_vjp``
    products (the transposes and the weight gradients) at ``grad_tier``
    (default ``tier``)."""
    step_vjp = autograd_step_vjp(
        lambda u, t, p: drift_plain(SDEWeights(*p), u, tier, grad_tier),
        lambda u, t, p: diffusion_plain(SDEWeights(*p), u, tier, grad_tier),
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
                         naccept, saveat_arr, ct_ys, ct_y, *, solver, delta,
                         precision="highest", grad_precision="match"):
    """The sweep over ``naccept`` recorded steps (kernel 12) for CUDA
    tensors, its recompute at ``precision`` and its transposed and
    weight-gradient products at ``grad_precision``;
    ``persistent_sde_sweep_plain`` for CPU tensors."""
    rec, grad = step_bwd_tiers(precision, grad_precision, ct_y.device)
    if ct_y.device.type == "cpu":
        return persistent_sde_sweep_plain(
            w, knot_ts, knot_us, knot_dws, knot_dzs, naccept, saveat_arr,
            ct_ys, ct_y, solver=solver, delta=delta, tier=rec,
            grad_tier=grad)
    ct_ys, ct_y = ct_ys.contiguous(), ct_y.contiguous()
    B, F, H = check_sde_operands(w, ct_y, *ct_ys)
    for name, k in (("knot_us", knot_us), ("knot_dws", knot_dws),
                    ("knot_dzs", knot_dzs)):
        if not k.is_contiguous() or tuple(k.shape[1:]) != (B, F):
            raise ValueError(f"{name}: needs a contiguous (n, {B}, {F}) buffer")
    dev = ct_y.device
    plan = sde_sweep_plan(B, F, H, rec, grad)
    bits = tier_bits(recompute=rec, grad=grad)
    lib = _build.load_library()
    if (lib.lrnde_sde_rows_per_block(), lib.lrnde_sde_sweep_threads(),
            lib.lrnde_sde_sweep_hid_threads(),
            4 * lib.lrnde_sde_sweep_smem_floats(bits, F, H),
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
        bits, int(solver == "sosri"), *[p(x) for x in w], p(knot_ts),
        p(knot_us), p(knot_dws), p(knot_dzs), p(naccept), p(saveat),
        saveat.shape[0], p(ct_ys), p(ct_y), p(a_u), p(d_w), p(part), B, F, H,
        _build.stream_ptr(dev),
    )
    _build.check(lib, err, "persistent_sde_sweep")
    count_launch(persistent_sde_sweep, f"{rec}/{grad}")
    return a_u, split_sde_grad(d_w, F, H)


persistent_sde_sweep.tier_launches = {}
