"""Hand-written CUDA kernels for the time-dependent MLP dynamics: one
dynamics evaluation and one whole Tsit5 step.

Counterpart of ``localregneuralde_tpu/ops/pallas/fused_mlp.py``. The
dynamics is ``TDChain(Dense(F+1 → H, tanh), Dense(H+1 → F))``:

    y = tanh(x·W1 + b1 + s·w1t)·W2 + b2 + s·w2t

with the weights in the reference layout, ``(in, out)``, whose last input
row is the time channel. Both kernels (``csrc/tdmlp_cluster.cu``) run on
the thread-block clusters of the persistent solve (kernel 4,
``csrc/solve_cluster.cuh``): its evaluation, and for the step its six
stages, bitwise the first port's one-CTA-per-8-rows kernels; they read the
full Dense weights in place. ``fused_solve.eval_plan`` models their grid
and refuses (ValueError) only a width whose tiles overflow a CTA at one
row a cluster, far past any the first port took.

Each wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its kernel for a CUDA tensor; there is no fallback between the
two. ``<wrapper>.tier_launches`` counts the kernel launches by product
tier (``launch_counts`` sums them). ``FusedTDMLP``
makes the evaluation differentiable: its backward is the autograd VJP of
``tdmlp_plain`` at the same tier, recomputed, as the reference's
``custom_vjp`` transposes its pure twin (``fused_mlp.py:196-216`` there).

``precision`` has the reference's meaning (``'highest'``, ``'high'``, or
None/``'default'``, the backend default) and ``nn.basic.product_tier`` maps
it to what the products compute on the tensor's device: on a card the
default is TF32 (the kernels' TF32 instantiations, ``csrc/
solve_cluster.cuh``), on the CPU FP32. The wrappers default to
``'highest'``, where the reference defaults to None: a call that names no
tier keeps the FP32 kernels, and the model's routes name theirs. The plain
versions take the resolved tier (``"fp32"`` or ``"tf32"``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...nn.basic import product_tier, tier_matmul
from ...ode.solve import device_scalar
from ...ode.step import tsit5_step
from . import _build


class TDMLPWeights(NamedTuple):
    """Full Dense weights of the TD-MLP: ``w1`` (F+1, H), ``b1`` (H),
    ``w2`` (H+1, F), ``b2`` (F); the last input row is the time channel."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def tdmlp_plain(w: TDMLPWeights, x: torch.Tensor, s, tier: str = "fp32",
                grad_tier=None) -> torch.Tensor:
    """One dynamics evaluation in plain PyTorch, its two products at
    ``tier`` and, under autograd, their transposes at ``grad_tier``
    (default ``tier``; ``nn.basic.tier_matmul``)."""
    F, H = x.shape[-1], w.b1.shape[0]
    h = torch.tanh(tier_matmul(x, w.w1[:F], tier, grad_tier) + w.b1
                   + s * w.w1[F])
    return tier_matmul(h, w.w2[:H], tier, grad_tier) + w.b2 + s * w.w2[H]


def tsit5_step_plain(w: TDMLPWeights, u, t, dt, k1, tier: str = "fp32",
                     grad_tier=None):
    """One Tsit5 step of the TD-MLP in plain PyTorch (the generic step of
    ``ode/step.py`` on ``tdmlp_plain`` at ``tier``); returns ``(u_new,
    utilde, k2, k3, k4, k5, k6, k7, g6)``."""
    res = tsit5_step(
        lambda x, s, st: (tdmlp_plain(w, x, s, tier, grad_tier), st),
        u, t, dt, k1, None)
    return (res.u_new, res.utilde, *res.ks[1:], res.g6)


def check_operands(w: TDMLPWeights, *states: torch.Tensor) -> tuple:
    """Validate kernel operands: float32, contiguous, on one CUDA device,
    states (B, F) with B ≥ 1 and weights matching F. Returns (B, F, H)."""
    B, F = states[0].shape
    H = w.b1.shape[0]
    shapes = {
        "w1": (F + 1, H), "b1": (H,), "w2": (H + 1, F), "b2": (F,),
    }
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


def device_scalars(values, like: torch.Tensor) -> torch.Tensor:
    """Floats and 0-d tensors stacked into one float32 tensor on ``like``'s
    device, without waiting for the device (``ode.solve.device_scalar``)."""
    return torch.stack([device_scalar(v, like).reshape(()) for v in values])


def count_launch(wrapper, tier: str) -> None:
    """One more launch of ``wrapper``'s kernel, at ``tier`` (a tier name, or
    the tiers of a kernel that mixes them joined by ``/``)."""
    wrapper.tier_launches[tier] = wrapper.tier_launches.get(tier, 0) + 1


def fused_tdmlp(w: TDMLPWeights, x: torch.Tensor, s,
                precision="highest") -> torch.Tensor:
    """One dynamics evaluation ``x (B, F) → dx (B, F)`` at time ``s``, its
    products at ``precision``: the CUDA kernel for a CUDA tensor,
    ``tdmlp_plain`` for a CPU tensor."""
    return tdmlp_at(w, x, s, product_tier(precision, x.device))


def tdmlp_at(w: TDMLPWeights, x: torch.Tensor, s, tier: str) -> torch.Tensor:
    """``fused_tdmlp`` at the resolved ``tier``."""
    if x.device.type == "cpu":
        return tdmlp_plain(w, x, s, tier)
    from .fused_solve import eval_layout

    B, F, H = check_operands(w, x)
    lib, _ = eval_layout(B, F, H)
    s_dev = device_scalars([s], x)
    out = torch.empty_like(x)
    p = _build.ptr
    entry = lib.lrnde_tdmlp_tf32 if tier == "tf32" else lib.lrnde_tdmlp
    err = entry(
        p(x), p(s_dev), p(w.w1), p(w.b1), p(w.w2), p(w.b2), p(out),
        B, F, H, 0, _build.stream_ptr(x.device),
    )
    _build.check(lib, err, "tdmlp")
    count_launch(fused_tdmlp, tier)
    return out


fused_tdmlp.tier_launches = {}


def fused_tsit5_step(w: TDMLPWeights, u, t, dt, k1, precision="highest"):
    """One whole Tsit5 step of the TD-MLP, its products at ``precision``:
    returns ``(u_new, utilde, k2, k3, k4, k5, k6, k7, g6)``. The CUDA
    kernel for CUDA tensors, ``tsit5_step_plain`` for CPU tensors."""
    tier = product_tier(precision, u.device)
    if u.device.type == "cpu":
        return tsit5_step_plain(w, u, t, dt, k1, tier)
    from .fused_solve import eval_layout

    B, F, H = check_operands(w, u, k1)
    lib, plan = eval_layout(B, F, H)
    sc = device_scalars([t, dt], u)
    outs = [torch.empty_like(u) for _ in range(9)]
    scratch = torch.empty(plan.scratch_floats, device=u.device)
    p = _build.ptr
    args = [p(u), p(k1), p(sc), p(w.w1), p(w.b1), p(w.w2), p(w.b2),
            *[p(o) for o in outs], p(scratch), B, F, H, 0]
    if tier == "tf32":
        err = lib.lrnde_tsit5_step_tf32(*args, _build.stream_ptr(u.device))
    else:
        err = lib.lrnde_tsit5_step(*args, None, _build.stream_ptr(u.device))
    _build.check(lib, err, "tsit5_step")
    count_launch(fused_tsit5_step, tier)
    return tuple(outs)


fused_tsit5_step.tier_launches = {}


class FusedTDMLP(torch.autograd.Function):
    """``(x, s, w1, b1, w2, b2, tier) -> dx`` through kernel 1 at ``tier``,
    with the VJP of ``tdmlp_plain`` at the same tier recomputed as its
    backward (the time ``s`` gets no gradient: inside the solver it comes
    from the fenced controller). On CPU tensors both directions run the
    plain version."""

    @staticmethod
    def forward(ctx, x, s, w1, b1, w2, b2, tier="fp32"):
        ctx.save_for_backward(x, s, w1, b1, w2, b2)
        ctx.tier = tier
        return tdmlp_at(TDMLPWeights(w1, b1, w2, b2), x.contiguous(), s, tier)

    @staticmethod
    def backward(ctx, ct):
        x, s, *w = ctx.saved_tensors
        with torch.enable_grad():
            ins = [a.detach().requires_grad_() for a in (x, *w)]
            out = tdmlp_plain(TDMLPWeights(*ins[1:]), ins[0], s, ctx.tier)
            grads = torch.autograd.grad(out, ins, ct, allow_unused=True)
        grads = [torch.zeros_like(a) if g is None else g
                 for g, a in zip(grads, ins)]
        return (grads[0], None, *grads[1:], None)


def differentiable_tdmlp(w: TDMLPWeights, x: torch.Tensor, s,
                         precision="highest") -> torch.Tensor:
    """One differentiable dynamics evaluation through ``FusedTDMLP``
    (kernel 1 on a CUDA tensor) at ``precision``."""
    s = device_scalar(s, x).detach()
    return FusedTDMLP.apply(x, s, *w, product_tier(precision, x.device))
