"""Hand-written CUDA kernel for the VJP of one training-mode Tsit5 step of
the CIFAR conv dynamics (kernel 14), and the autograd function that makes
kernel 13 differentiable.

Counterpart of ``localregneuralde_tpu/ops/pallas/fused_conv_bwd.py``
(``fused_conv_step_bwd``). The kernel (``csrc/conv_step_bwd.cu``) recomputes
the six evaluations with batch statistics, then per evaluation in reverse
transposes conv3 → BatchNorm 2 and gelu′ → conv2 → BatchNorm 1 and gelu′ →
conv1, carrying the stage-chain cotangents as kernel 3 does:

    dconv: data gradient over the flipped taps; dW[tap] += Σ_p src[p+δ]ᵀ dy[p]
    BN:    dg = da·gelu′(g); dγ += Σ dg·x̂; dβ += Σ dg;
           dz = inv·(γdg − γΣdg/N − x̂·γΣ(dg·x̂)/N)

The weight gradients come out in the HWIO layout, time channel included.
The cotangents of t and dt are zero (the controller fence), and the
running-stat outputs of the step get no cotangent.

Tiers, as the reference's ``fused_conv_step_bwd``: ``precision`` is the
recompute's, ``grad_precision`` the data-gradient, weight-gradient and
time-row products' (``'match'``: the recompute's). Both of the reference's
callers leave ``grad_precision`` at None, so the model's routes take the
default tier (TF32 on a card) for the gradients whatever the forward's:
``FusedConvStep`` recomputes at the forward's tier, the stored adjoint's
step VJP at ``bwd_precision``. The kernel takes every pair of tiers
(``lrnde_conv_step_bwd``'s first argument, ``fused_mlp_bwd.tier_bits``);
``fused_conv_step_bwd.tier_launches``
counts its launches by ``recompute/gradients`` tier.
"""
from __future__ import annotations

import torch

from . import _build
from .fused_conv import (
    ConvFamilySpec,
    ConvWeights,
    check_conv_operands,
    conv_step_plain,
    fused_conv_step,
)
from .fused_mlp import count_launch, device_scalars
from .fused_mlp_bwd import step_bwd_tiers, tier_bits


def fused_conv_step_bwd_plain(w: ConvWeights, spec: ConvFamilySpec, u, t, dt,
                              k1, cts, tier: str = "fp32", grad_tier=None):
    """The plain version: the autograd VJP of ``conv_step_plain`` in
    training mode for the nine cotangents ``(d_unew, d_utilde, d_k2..d_k7,
    d_g6)``, the recompute's convs at ``tier`` and their transposes at
    ``grad_tier`` (default ``tier``); returns ``(d_w, d_u, d_k1)`` with
    ``d_w`` a ``ConvWeights``."""
    with torch.enable_grad():
        ins = [x.detach().requires_grad_() for x in (*w, u, k1)]
        outs = conv_step_plain(ConvWeights(*ins[:7]), spec, ins[7],
                               torch.as_tensor(t), torch.as_tensor(dt), ins[8],
                               training=True, tier=tier,
                               grad_tier=grad_tier)[:9]
        grads = torch.autograd.grad(outs, ins, list(cts), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, ins)]
    return ConvWeights(*grads[:7]), grads[7], grads[8]


def fused_conv_step_bwd(w: ConvWeights, spec: ConvFamilySpec, u, t, dt, k1,
                        cts, precision="highest", grad_precision="match"):
    """VJP of one training-mode step: ``cts`` are the cotangents of the
    nine outputs ``(u_new, utilde, k2..k7, g6)``; returns ``(d_w, d_u,
    d_k1)``. The recompute runs at ``precision``, the data-gradient,
    weight-gradient and time-row products at ``grad_precision``. The CUDA
    kernel for CUDA tensors, ``fused_conv_step_bwd_plain`` for CPU
    tensors."""
    rec, grad = step_bwd_tiers(precision, grad_precision, u.device)
    if u.device.type == "cpu":
        return fused_conv_step_bwd_plain(w, spec, u, t, dt, k1, cts, rec, grad)
    B, H, W = check_conv_operands(w, spec, u, k1, *cts)
    sc = device_scalars([t, dt], u)
    lib = _build.load_library()
    d_u, d_k1 = torch.empty_like(u), torch.empty_like(u)
    d_w = ConvWeights(*[torch.empty_like(x) for x in w])
    scratch = torch.empty(
        lib.lrnde_conv_step_bwd_scratch_floats(B, H, W, spec.Cs, spec.Ch),
        dtype=torch.float32, device=u.device)
    p = _build.ptr
    err = lib.lrnde_conv_step_bwd(
        tier_bits(recompute=rec, grad=grad), p(u), p(k1), p(sc),
        *[p(x) for x in w], *[p(c) for c in cts], p(d_u), p(d_k1),
        *[p(g) for g in d_w], p(scratch), spec.eps, B, H, W, spec.Cs,
        spec.Ch, _build.stream_ptr(u.device),
    )
    _build.check(lib, err, "conv_step_bwd")
    count_launch(fused_conv_step_bwd, f"{rec}/{grad}")
    return d_w, d_u, d_k1


fused_conv_step_bwd.tier_launches = {}


class FusedConvStep(torch.autograd.Function):
    """``(spec, tiers, u, t, dt, k1, rstats, *w) -> (u_new, utilde, k2..k7,
    g6, stats)`` through kernel 13 in training mode at ``tiers[0]``, with
    kernel 14 as its VJP (the counterpart of the reference's ``core_train``
    custom VJP), recomputing at ``tiers[0]`` with its gradient products at
    ``tiers[1]`` (precisions, saved at the forward: the backward runs on
    autograd's thread). ``stats``, the running stats after the EMA chain
    (4, Ch), is fenced. On CPU tensors both directions run their plain
    versions."""

    @staticmethod
    def forward(ctx, spec, tiers, u, t, dt, k1, rstats, *w):
        ctx.spec, ctx.tiers = spec, tiers
        ctx.save_for_backward(u, t, dt, k1, *w)
        *outs, stats = fused_conv_step(ConvWeights(*w), spec, u.contiguous(), t,
                                       dt, k1.contiguous(), training=True,
                                       rstats=tuple(rstats.unbind(0)),
                                       precision=tiers[0])
        stats = torch.stack(stats)
        ctx.mark_non_differentiable(stats)
        return (*outs, stats)

    @staticmethod
    def backward(ctx, *cts):
        u, t, dt, k1, *w = ctx.saved_tensors
        cts = [torch.zeros_like(u) if c is None else c.contiguous()
               for c in cts[:9]]
        d_w, d_u, d_k1 = fused_conv_step_bwd(ConvWeights(*w), ctx.spec, u, t,
                                             dt, k1, cts, *ctx.tiers)
        return (None, None, d_u, None, None, d_k1, None, *d_w)


def differentiable_conv_step(w: ConvWeights, spec: ConvFamilySpec, u, t, dt,
                             k1, rstats, precision="highest",
                             grad_precision="match"):
    """One differentiable training-mode step through ``FusedConvStep`` at
    ``precision``, its VJP recomputing at ``precision`` with the gradient
    products at ``grad_precision`` (the reference's fused step passes its
    forward's precision and leaves the gradients at the default tier, None,
    as the model's routes do; ``t`` and ``dt`` get no gradient); returns
    ``(u_new, utilde, k2, ..., k7, g6, stats)`` with ``stats`` the running
    stats after the step."""
    t, dt = device_scalars([t, dt], u).detach()
    rs = torch.stack([r.detach() for r in rstats])
    *outs, stats = FusedConvStep.apply(spec, (precision, grad_precision), u,
                                       t, dt, k1, rs, *w)
    return (*outs, tuple(stats.unbind(0)))
