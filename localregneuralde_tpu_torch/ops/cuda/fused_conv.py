"""Hand-written CUDA kernel for one Tsit5 step of the CIFAR conv dynamics
(kernel 13), its plain PyTorch version and the family's helpers.

Counterpart of ``localregneuralde_tpu/ops/pallas/fused_conv.py``. The
dynamics (``harness/construct.py::_construct_cifar10_cnn``) is::

    TDChain(
        Chain(Conv3x3 Cs+1 → Ch (no bias), BatchNorm(Ch, gelu)),
        Chain(Conv3x3 Ch+1 → Ch (no bias), BatchNorm(Ch, gelu)),
        Conv3x3 Ch+1 → Cs (no bias),
    )

on NHWC states ``(B, H, W, Cs)`` with HWIO weights whose last input channel
is the time channel. The kernel (``csrc/conv_step.cu``, ``csrc/conv.cuh``)
runs the six evaluations of one step, the stage sums and ũ, with the
convolutions as implicit GEMMs, the time channel concat-free (``s·tmap``)
and BatchNorm either on batch statistics (training: the running-stat EMA
chain of the six evaluations comes out too; eval with
``eval_stats='batch'``) or on the running stats (eval). The batch
statistics come from the convs' epilogue: per-tile sums and M2 folded in
tile order (Chan's combination), where the plain version takes torch's
two-pass mean and variance, so the two agree to float32 rounding, not
bitwise. The weights are read in place.

The wrapper runs the plain version for a tensor on the CPU and launches the
kernel for a CUDA tensor; ``fused_conv_step.tier_launches`` counts the
launches by product tier.

``precision`` has the reference's meaning (``'highest'``, ``'high'``, or
None/``'default'``, the backend default, which on a card is TF32:
``nn.basic.product_tier``). At TF32 every conv product, the time maps' taps
included, runs on rounded operands (``lrnde_conv_step_tf32``; the plain
version rounds them with ``nn.basic.round_tf32`` and convolves in FP32);
the BatchNorm statistics and apply, gelu, ``s·tmap`` and the stage algebra
stay FP32. The wrapper defaults to ``'highest'``, where the reference
defaults to None: a call that names no tier keeps the FP32 kernel, and the
model's routes name theirs. The plain versions take the resolved tier.

One deviation from the reference: its fused step normalises with the running
stats in eval mode whatever ``BatchNorm.eval_stats`` says
(``fused_conv.py:466-482``), while its XLA path honours ``'batch'``. The port
follows the layer: with ``eval_stats='batch'`` kernel 13 uses the batch's
statistics and leaves the running stats alone (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ...nn.basic import (
    _ACTIVATIONS, BatchNorm, Chain, Conv, conv2d_nhwc_td, product_tier,
)
from ...ode.step import tsit5_step
from . import _build
from .fused_mlp import count_launch, device_scalars


class ConvFamilySpec(NamedTuple):
    Cs: int            # state channels
    Ch: int            # hidden channels
    momentum: float
    eps: float
    eval_stats: str    # 'running' or 'batch'
    bn_keys: tuple     # state paths of the two BatchNorms: ((l0, bn0), (l1, bn1))


class ConvWeights(NamedTuple):
    """The family's parameters, in the dynamics' parameter order."""

    w1: torch.Tensor  # (3, 3, Cs + 1, Ch)
    g1: torch.Tensor  # (Ch) BatchNorm 1 scale
    b1: torch.Tensor  # (Ch) BatchNorm 1 bias
    w2: torch.Tensor  # (3, 3, Ch + 1, Ch)
    g2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor  # (3, 3, Ch + 1, Cs)


def _conv3x3_same(layer) -> bool:
    return (isinstance(layer, Conv) and layer.kernel_size == (3, 3)
            and not layer.use_bias)


def match_conv_family(model) -> Optional[ConvFamilySpec]:
    """The CIFAR conv dynamics pattern on a TDChain (reference
    ``fused_conv.py:87-136``), or None."""
    from ...models.common import TDChain

    if not isinstance(model, TDChain):
        return None
    children = list(model.named_children())
    if len(children) != 3:
        return None

    def conv_bn(layer):
        if not isinstance(layer, Chain):
            return None
        sub = list(layer.named_children())
        if len(sub) != 2:
            return None
        (_, conv), (bn_key, bn) = sub
        ok = (_conv3x3_same(conv) and isinstance(bn, BatchNorm)
              and bn.activation is _ACTIVATIONS["gelu"])
        return (conv, bn, bn_key) if ok else None

    a, b = conv_bn(children[0][1]), conv_bn(children[1][1])
    last = children[2][1]
    if a is None or b is None or not _conv3x3_same(last):
        return None
    (c1, bn1, k1), (c2, bn2, k2) = a, b
    Cs, Ch = last.out_channels, c1.out_channels
    if not (c1.in_channels == Cs + 1 and c2.in_channels == Ch + 1
            and c2.out_channels == Ch and last.in_channels == Ch + 1):
        return None
    if (bn1.momentum, bn1.eps, bn1.eval_stats) != (bn2.momentum, bn2.eps,
                                                   bn2.eval_stats):
        return None
    return ConvFamilySpec(Cs, Ch, float(bn1.momentum), float(bn1.eps),
                          bn1.eval_stats,
                          ((children[0][0], k1), (children[1][0], k2)))


def running_stats(spec: ConvFamilySpec, state) -> tuple:
    """``(mean1, var1, mean2, var2)`` of the dynamics' layer state."""
    (l0, n0), (l1, n1) = spec.bn_keys
    s0, s1 = state[l0][n0], state[l1][n1]
    return s0["mean"], s0["var"], s1["mean"], s1["var"]


def with_running_stats(spec: ConvFamilySpec, state, stats) -> dict:
    """A copy of the dynamics' layer state with the BatchNorm running stats
    ``(mean1, var1, mean2, var2)``."""
    (l0, n0), (l1, n1) = spec.bn_keys
    new = dict(state)
    new[l0] = dict(state[l0])
    new[l0][n0] = {"mean": stats[0], "var": stats[1]}
    new[l1] = dict(state[l1])
    new[l1][n1] = {"mean": stats[2], "var": stats[3]}
    return new


# ---------------------------------------------------------------------------
# the plain version


def _batch_stats(z):
    axes = tuple(range(z.ndim - 1))
    mean = z.mean(dim=axes)
    return mean, torch.square(z - mean).mean(dim=axes)


def _bn_gelu(z, gamma, beta, mean, var, eps):
    y = (z - mean) * torch.rsqrt(var + eps) * gamma + beta
    return nn.functional.gelu(y, approximate="tanh")


def conv_dynamics_plain(w: ConvWeights, spec: ConvFamilySpec, x, s,
                        norm=None, tier: str = "fp32", grad_tier=None):
    """One dynamics evaluation in plain PyTorch, its three convs at
    ``tier`` and, under autograd, their transposes at ``grad_tier``
    (default ``tier``; ``nn.basic.conv2d_nhwc_td``). ``norm`` gives the
    BatchNorm statistics ``(mean1, var1, mean2, var2)`` to normalise with;
    None normalises with the batch's. Returns ``(k, stats)`` with the
    statistics used."""
    tiers = (tier, grad_tier)
    z1 = conv2d_nhwc_td(x, w.w1, s, *tiers)
    m1, v1 = _batch_stats(z1) if norm is None else norm[:2]
    z2 = conv2d_nhwc_td(_bn_gelu(z1, w.g1, w.b1, m1, v1, spec.eps), w.w2, s,
                        *tiers)
    m2, v2 = _batch_stats(z2) if norm is None else norm[2:]
    k = conv2d_nhwc_td(_bn_gelu(z2, w.g2, w.b2, m2, v2, spec.eps), w.w3, s,
                       *tiers)
    return k, (m1, v1, m2, v2)


def default_rstats(spec: ConvFamilySpec, like: torch.Tensor) -> tuple:
    """BatchNorm's initial running stats: zero means, unit variances."""
    z = torch.zeros(spec.Ch, device=like.device)
    return z, torch.ones_like(z), z, torch.ones_like(z)


def conv_step_plain(w: ConvWeights, spec: ConvFamilySpec, u, t, dt, k1, *,
                    training: bool, rstats=None, tier: str = "fp32",
                    grad_tier=None):
    """One Tsit5 step of the conv dynamics in plain PyTorch (the generic
    step of ``ode/step.py``), its convs at ``tier`` and under autograd at
    ``grad_tier`` (``conv_dynamics_plain``). Training normalises with batch
    statistics and runs the running stats ``rstats`` through the EMA chain
    of the six evaluations; eval normalises with ``rstats``, or with batch
    statistics under ``eval_stats='batch'``. Returns ``(u_new, utilde, k2,
    ..., k7, g6, stats)``, ``stats`` the new running stats in training,
    else None."""
    if rstats is None:
        rstats = default_rstats(spec, u)
    batch = training or spec.eval_stats == "batch"
    m = spec.momentum

    def f(x, s, st):
        k, used = conv_dynamics_plain(w, spec, x, s, None if batch else st,
                                      tier, grad_tier)
        if training:
            st = tuple((1 - m) * r + m * b.detach() for r, b in zip(st, used))
        return k, st

    res = tsit5_step(f, u, t, dt, k1, tuple(rstats))
    return (res.u_new, res.utilde, *res.ks[1:], res.g6,
            res.f_state if training else None)


# ---------------------------------------------------------------------------
# kernel 13


def check_conv_operands(w: ConvWeights, spec: ConvFamilySpec, *states):
    """Validate kernel operands: float32, contiguous, on one CUDA device,
    states (B, H, W, Cs) and weights of the spec's widths. Returns (B, H,
    W)."""
    B, H, W, Cs = states[0].shape
    Ch = spec.Ch
    shapes = {"w1": (3, 3, Cs + 1, Ch), "w2": (3, 3, Ch + 1, Ch),
              "w3": (3, 3, Ch + 1, Cs)}
    if Cs != spec.Cs or max(Cs, Ch) > 256:
        raise ValueError(f"state channels {Cs}, hidden {Ch}: the kernel takes "
                         f"the spec's Cs = {spec.Cs} and at most 256 channels")
    for name, t in list(zip(w._fields, w)) + [("state", s) for s in states]:
        want = shapes.get(name, (Ch,) if name[0] in "gb" else (B, H, W, Cs))
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous float32")
        if t.device != states[0].device:
            raise ValueError(f"{name}: on {t.device}, state on {states[0].device}")
    if B * H * W < 1:
        raise ValueError("empty batch")
    return B, H, W


def fused_conv_step(w: ConvWeights, spec: ConvFamilySpec, u, t, dt, k1, *,
                    training: bool, rstats=None, precision="highest",
                    tier: Optional[str] = None):
    """One whole Tsit5 step of the conv dynamics, its products at
    ``precision`` (or at ``tier``, already resolved, where the caller gives
    one: the serving solve's operator), the contract of
    ``conv_step_plain``: ``(u_new, utilde, k2, ..., k7, g6, stats)``. The
    CUDA kernel for CUDA tensors, ``conv_step_plain`` for CPU tensors."""
    if tier is None:
        tier = product_tier(precision, u.device)
    if u.device.type == "cpu":
        return conv_step_plain(w, spec, u, t, dt, k1, training=training,
                               rstats=rstats, tier=tier)
    B, H, W = check_conv_operands(w, spec, u, k1)
    mode = 0 if training else (2 if spec.eval_stats == "batch" else 1)
    if rstats is None:
        if mode == 1:
            raise ValueError("eval with running stats needs rstats")
        rstats = default_rstats(spec, u)
    rs = torch.stack([r.detach().float() for r in rstats]).contiguous()
    rs_out = torch.empty_like(rs) if training else None
    sc = device_scalars([t, dt], u)
    outs = [torch.empty_like(u) for _ in range(9)]
    lib = _build.load_library()
    scratch = torch.empty(
        lib.lrnde_conv_step_scratch_floats(B, H, W, spec.Cs, spec.Ch),
        dtype=torch.float32, device=u.device)
    p = _build.ptr
    entry = lib.lrnde_conv_step_tf32 if tier == "tf32" else lib.lrnde_conv_step
    err = entry(
        p(u), p(k1), p(sc), *[p(x) for x in w], *[p(o) for o in outs], p(rs),
        None if rs_out is None else p(rs_out), p(scratch), mode,
        spec.momentum, 1.0 - spec.momentum, spec.eps, B, H, W, spec.Cs,
        spec.Ch, _build.stream_ptr(u.device),
    )
    _build.check(lib, err, "conv_step")
    count_launch(fused_conv_step, tier)
    return (*outs, None if rs_out is None else tuple(rs_out.unbind(0)))


fused_conv_step.tier_launches = {}
