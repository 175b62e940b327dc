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
two. ``<wrapper>.launches`` counts the kernel launches. ``FusedTDMLP``
makes the evaluation differentiable: its backward is the autograd VJP of
``tdmlp_plain``, recomputed, as the reference's ``custom_vjp`` transposes
its pure twin (``fused_mlp.py:196-216`` there).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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


def tdmlp_plain(w: TDMLPWeights, x: torch.Tensor, s) -> torch.Tensor:
    """One dynamics evaluation in plain PyTorch."""
    F, H = x.shape[-1], w.b1.shape[0]
    h = torch.tanh(x @ w.w1[:F] + w.b1 + s * w.w1[F])
    return h @ w.w2[:H] + w.b2 + s * w.w2[H]


def tsit5_step_plain(w: TDMLPWeights, u, t, dt, k1):
    """One Tsit5 step of the TD-MLP in plain PyTorch (the generic step of
    ``ode/step.py`` on ``tdmlp_plain``); returns ``(u_new, utilde, k2, k3,
    k4, k5, k6, k7, g6)``."""
    res = tsit5_step(lambda x, s, st: (tdmlp_plain(w, x, s), st),
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


def fused_tdmlp(w: TDMLPWeights, x: torch.Tensor, s) -> torch.Tensor:
    """One dynamics evaluation ``x (B, F) → dx (B, F)`` at time ``s``: the
    CUDA kernel for a CUDA tensor, ``tdmlp_plain`` for a CPU tensor."""
    if x.device.type == "cpu":
        return tdmlp_plain(w, x, s)
    from .fused_solve import eval_layout

    B, F, H = check_operands(w, x)
    lib, _ = eval_layout(B, F, H)
    s_dev = device_scalars([s], x)
    out = torch.empty_like(x)
    p = _build.ptr
    err = lib.lrnde_tdmlp(
        p(x), p(s_dev), p(w.w1), p(w.b1), p(w.w2), p(w.b2), p(out),
        B, F, H, 0, _build.stream_ptr(x.device),
    )
    _build.check(lib, err, "tdmlp")
    fused_tdmlp.launches += 1
    return out


fused_tdmlp.launches = 0


def fused_tsit5_step(w: TDMLPWeights, u, t, dt, k1):
    """One whole Tsit5 step of the TD-MLP: returns ``(u_new, utilde, k2,
    k3, k4, k5, k6, k7, g6)``. The CUDA kernel for CUDA tensors,
    ``tsit5_step_plain`` for CPU tensors."""
    if u.device.type == "cpu":
        return tsit5_step_plain(w, u, t, dt, k1)
    from .fused_solve import eval_layout

    B, F, H = check_operands(w, u, k1)
    lib, plan = eval_layout(B, F, H)
    sc = device_scalars([t, dt], u)
    outs = [torch.empty_like(u) for _ in range(9)]
    scratch = torch.empty(plan.scratch_floats, device=u.device)
    p = _build.ptr
    err = lib.lrnde_tsit5_step(
        p(u), p(k1), p(sc), p(w.w1), p(w.b1), p(w.w2), p(w.b2),
        *[p(o) for o in outs], p(scratch), B, F, H, 0, None,
        _build.stream_ptr(u.device),
    )
    _build.check(lib, err, "tsit5_step")
    fused_tsit5_step.launches += 1
    return tuple(outs)


fused_tsit5_step.launches = 0


class FusedTDMLP(torch.autograd.Function):
    """``(x, s, w1, b1, w2, b2) -> dx`` through ``fused_tdmlp``, with the
    VJP of ``tdmlp_plain`` recomputed as its backward (the time ``s`` gets
    no gradient: inside the solver it comes from the fenced controller). On
    CPU tensors both directions run the plain version."""

    @staticmethod
    def forward(ctx, x, s, w1, b1, w2, b2):
        ctx.save_for_backward(x, s, w1, b1, w2, b2)
        return fused_tdmlp(TDMLPWeights(w1, b1, w2, b2), x.contiguous(), s)

    @staticmethod
    def backward(ctx, ct):
        x, s, *w = ctx.saved_tensors
        with torch.enable_grad():
            ins = [a.detach().requires_grad_() for a in (x, *w)]
            out = tdmlp_plain(TDMLPWeights(*ins[1:]), ins[0], s)
            grads = torch.autograd.grad(out, ins, ct, allow_unused=True)
        grads = [torch.zeros_like(a) if g is None else g
                 for g, a in zip(grads, ins)]
        return (grads[0], None, *grads[1:])


def differentiable_tdmlp(w: TDMLPWeights, x: torch.Tensor, s) -> torch.Tensor:
    """One differentiable dynamics evaluation through ``FusedTDMLP``
    (kernel 1 on a CUDA tensor)."""
    s = device_scalar(s, x).detach()
    return FusedTDMLP.apply(x, s, *w)
