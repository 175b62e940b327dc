"""Hand-written CUDA kernel for the VJP of one Tsit5 step of the TD-MLP
dynamics, and the autograd function that makes the step kernel
differentiable.

Counterpart of ``localregneuralde_tpu/ops/pallas/fused_mlp_bwd.py``
(``fused_step_bwd``). Per stage evaluation at time s:

    z = x·W1 + b1 + s·w1t ;  h = tanh(z) ;  k = h·W2 + b2 + s·w2t
    dh = dk·W2ᵀ ; dz = dh·(1−h²) ; dx = dz·W1ᵀ
    dW1 += xᵀ·dz ; db1 += Σ_rows dz ; dw1t += s·Σ_rows dz
    dW2 += hᵀ·dk ; db2 += Σ_rows dk ; dw2t += s·Σ_rows dk

The kernel (``csrc/tsit5_step_bwd.cu``) runs on thread-block clusters
through the transposed step of the stored-adjoint sweep (laid out by
``fused_solve_bwd.sweep_plan``): it recomputes the six stages, runs the
reverse pass seeded with the nine cotangents, adds the weight gradients
into each cluster's slices, and reduces the clusters' partials in a fixed
order, so its gradients are the same from run to run.

The cotangents of t and dt are zero: inside the solver both come from the
controller under a fence, so their true cotangents are dropped upstream and
zeros are exact for every gradient the package exposes.
"""
from __future__ import annotations

import torch

from . import _build
from .fused_mlp import (
    TDMLPWeights,
    check_operands,
    device_scalars,
    fused_tsit5_step,
    tsit5_step_plain,
)


def fused_step_bwd_plain(w: TDMLPWeights, u, t, dt, k1, cts):
    """The plain version: the autograd VJP of ``tsit5_step_plain`` for the
    nine cotangents ``(d_unew, d_utilde, d_k2..d_k7, d_g6)``; returns
    ``(d_w, d_u, d_k1)`` with ``d_w`` a ``TDMLPWeights``."""
    with torch.enable_grad():
        ins = [x.detach().requires_grad_() for x in (*w, u, k1)]
        outs = tsit5_step_plain(TDMLPWeights(*ins[:4]), ins[4],
                                torch.as_tensor(t), torch.as_tensor(dt), ins[5])
        grads = torch.autograd.grad(outs, ins, list(cts), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, ins)]
    return TDMLPWeights(*grads[:4]), grads[4], grads[5]


def weight_grad_size(F: int, H: int) -> int:
    """Floats of one flat weight gradient: w1 (F+1, H), b1 (H), w2 (H+1, F),
    b2 (F), in that order."""
    return (F + 1) * H + H + (H + 1) * F + F


def split_weight_grad(flat: torch.Tensor, F: int, H: int) -> TDMLPWeights:
    """Views of a flat weight gradient as ``TDMLPWeights``."""
    sizes = [(F + 1) * H, H, (H + 1) * F, F]
    w1, b1, w2, b2 = torch.split(flat, sizes)
    return TDMLPWeights(w1.view(F + 1, H), b1, w2.view(H + 1, F), b2)


def fused_step_bwd(w: TDMLPWeights, u, t, dt, k1, cts):
    """VJP of one Tsit5 step: ``cts`` are the cotangents of the nine step
    outputs ``(u_new, utilde, k2..k7, g6)``; returns ``(d_w, d_u, d_k1)``.
    The CUDA kernel for CUDA tensors, ``fused_step_bwd_plain`` for CPU
    tensors."""
    if u.device.type == "cpu":
        return fused_step_bwd_plain(w, u, t, dt, k1, cts)
    from .fused_solve_bwd import sweep_layout

    B, F, H = check_operands(w, u, k1, *cts)
    sc = device_scalars([t, dt], u)
    lib, plan = sweep_layout(B, F, H, "tsit5_step_bwd")
    d_u, d_k1 = torch.empty_like(u), torch.empty_like(u)
    d_w = torch.empty(weight_grad_size(F, H), dtype=torch.float32,
                      device=u.device)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=u.device)
    part = torch.empty((plan.max_partials, weight_grad_size(F, H)),
                       dtype=torch.float32, device=u.device)
    p = _build.ptr
    err = lib.lrnde_tsit5_step_bwd(
        p(u), p(k1), p(sc), *[p(x) for x in w], *[p(c) for c in cts],
        p(d_u), p(d_k1), p(d_w), p(scratch), p(part), B, F, H,
        _build.stream_ptr(u.device),
    )
    _build.check(lib, err, "tsit5_step_bwd")
    fused_step_bwd.launches += 1
    return split_weight_grad(d_w, F, H), d_u, d_k1


fused_step_bwd.launches = 0


class FusedTsit5Step(torch.autograd.Function):
    """``(u, t, dt, k1, w1, b1, w2, b2) -> (u_new, utilde, k2..k7, g6)``
    through the step kernel, with the backward kernel as its VJP (the
    counterpart of the reference's ``jax.custom_vjp`` around the fused
    step). On CPU tensors both directions run their plain versions."""

    @staticmethod
    def forward(ctx, u, t, dt, k1, w1, b1, w2, b2):
        w = TDMLPWeights(w1, b1, w2, b2)
        ctx.save_for_backward(u, t, dt, k1, w1, b1, w2, b2)
        return fused_tsit5_step(w, u.contiguous(), t, dt, k1.contiguous())

    @staticmethod
    def backward(ctx, *cts):
        u, t, dt, k1, *w = ctx.saved_tensors
        cts = [c.contiguous() for c in cts]
        d_w, d_u, d_k1 = fused_step_bwd(TDMLPWeights(*w), u, t, dt, k1, cts)
        return (d_u, None, None, d_k1, *d_w)


def differentiable_step(w: TDMLPWeights, u, t, dt, k1):
    """One differentiable Tsit5 step of the TD-MLP through ``FusedTsit5Step``
    (``t`` and ``dt`` get no gradient)."""
    t, dt = device_scalars([t, dt], u).detach()
    return FusedTsit5Step.apply(u, t, dt, k1, *w)
