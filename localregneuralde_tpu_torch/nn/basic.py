"""Basic layers: Dense, Conv, BatchNorm, Flatten, WrappedFunction (alias
Lambda), Chain.

Counterpart of ``localregneuralde_tpu/nn/basic.py``. Layout is the
reference's: batch-major ``(B, F)``, a Dense weight is ``(in, out)`` (not
``nn.Linear``'s ``(out, in)``), images are NHWC and a Conv weight is HWIO
``(kh, kw, in, out)``, so parameters carry over unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Optional

import torch
from torch import nn

from .module import Module

_ACTIVATIONS = {
    None: lambda x: x,
    "identity": lambda x: x,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "gelu": lambda x: nn.functional.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "softplus": nn.functional.softplus,
    "swish": nn.functional.silu,
}


def resolve_activation(act) -> Callable:
    if callable(act):
        return act
    try:
        return _ACTIVATIONS[act]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}") from None


def resolve_solver_precision(precision, rtol: float):
    """Matmul precision tier of the solver path, as the reference names it:
    'auto' is 'highest' iff rtol < 1e-4, else None (the backend default).
    ``product_tier`` says what each computes on a device.
    """
    if precision == "auto":
        return "highest" if rtol < 1e-4 else None
    if precision in (None, "default"):
        return None
    if precision in ("high", "highest"):
        return precision
    raise ValueError(
        f"unknown precision {precision!r}; one of auto/default/high/highest"
    )


def product_tier(precision, device) -> str:
    """What the products of a resolved ``precision`` compute on ``device``:
    ``"tf32"`` exactly when it is the backend default (None or 'default',
    which 'auto' resolves to at rtol ≥ 1e-4) and the device is CUDA, where
    the backend default of an FP32 product is TF32 on the tensor cores;
    ``"fp32"`` otherwise ('highest', 'high', and every tier on the CPU,
    where JAX also computes FP32). The TF32 tier rounds each operand with
    ``round_tf32`` and accumulates in FP32. Inside ``tiers_of(d)`` the
    device is ``d``."""
    if precision == "auto":
        raise ValueError("product_tier takes a resolved precision: "
                         "resolve_solver_precision('auto', rtol) first")
    if precision not in (None, "default", "high", "highest"):
        raise ValueError(
            f"unknown precision {precision!r}; one of default/high/highest")
    device = _TIER_DEVICE.get() or device
    if precision in (None, "default") and torch.device(device).type == "cuda":
        return "tf32"
    return "fp32"


_TIER_DEVICE = contextvars.ContextVar("tier_device", default=None)


@contextlib.contextmanager
def tiers_of(device):
    """Inside the block ``product_tier`` answers for ``device`` whatever
    device a call's tensors lie on: a CPU run inside ``tiers_of("cuda")``
    computes every product at the tier the card computes it at (the TF32
    tier's operands rounded by ``round_tf32``, bitwise the card's), so it
    is a plain reference at the card's tiers. Tiers are resolved where a
    product is set up: keep the backward inside the block too."""
    token = _TIER_DEVICE.set(device)
    try:
        yield
    finally:
        _TIER_DEVICE.reset(token)


def check_product_tier(tier: str, rtol: float) -> None:
    """Raise for a forward solve at the TF32 tier below rtol 1e-4: TF32's
    rounding noise in the embedded error estimate ũ then makes acceptance
    impossible. The reference lets such a solve saturate ``max_steps``;
    the port refuses it (README, documented deviations)."""
    if tier == "tf32" and rtol < 1e-4:
        raise ValueError(
            f"rtol {rtol:g} < 1e-4 needs FP32 products, but the precision "
            "resolves to the TF32 'default' tier on this device: pass "
            "precision='highest' (or 'auto') or loosen the tolerance")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it:
    to the nearest value with 10 mantissa bits, ties away from zero (the low
    13 bits cleared). Bitwise on finite inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _at(x: torch.Tensor, tier: str) -> torch.Tensor:
    """An operand of a product at ``tier``: rounded with ``round_tf32`` at
    ``"tf32"`` (float32 only), as it is at ``"fp32"``."""
    if tier != "tf32":
        return x
    if x.dtype != torch.float32:
        raise ValueError(f"the TF32 tier takes float32 operands, not {x.dtype}")
    return round_tf32(x)


def _product(a, b, tier: str):
    return _at(a, tier) @ _at(b, tier)


class TierMatmul(torch.autograd.Function):
    """``a @ b`` of 2-D float32 operands at the product tier ``tier``, with
    the two products of its backward at ``grad_tier``: at ``"tf32"`` each
    product's operands are rounded with ``round_tf32`` and multiplied in
    FP32. The tiers are saved at the forward: the backward runs later, on
    autograd's own thread, where no scope around the forward reaches."""

    @staticmethod
    def forward(ctx, a, b, tier, grad_tier):
        ctx.save_for_backward(a, b)
        ctx.grad_tier = grad_tier
        return _product(a, b, tier)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _product(g, b.t(), ctx.grad_tier)
        if ctx.needs_input_grad[1]:
            gb = _product(a.t(), g, ctx.grad_tier)
        return ga, gb, None, None


def tier_matmul(a, b, tier: str = "fp32", grad_tier: Optional[str] = None):
    """``a @ b`` (2-D) at ``tier``, its backward at ``grad_tier`` (default:
    ``tier``); both FP32 is the plain product."""
    grad_tier = tier if grad_tier is None else grad_tier
    if tier == grad_tier == "fp32":
        return a @ b
    return TierMatmul.apply(a, b, tier, grad_tier)


_TIER = contextvars.ContextVar("product_tier", default="fp32")


@contextlib.contextmanager
def product_tier_scope(tier: str):
    """Dense and Conv layers (and a TDChain's concat-free convs) called
    inside the block compute their products at ``tier`` (the counterpart of
    the reference's ``jax.default_matmul_precision`` around its dynamics);
    their backward keeps the tier they saved."""
    token = _TIER.set(tier)
    try:
        yield
    finally:
        _TIER.reset(token)


def scope_tier(x: torch.Tensor) -> str:
    """The tier of a product of ``x`` inside ``product_tier_scope``: the
    scope's for a float32 ``x``, FP32 for another dtype (the bfloat16
    dynamics)."""
    return _TIER.get() if x.dtype == torch.float32 else "fp32"


# A Dense or Conv layer's ``precision`` that follows ``product_tier_scope``
SCOPE = "scope"


def layer_tier(precision, x: torch.Tensor) -> str:
    """The tier of a Dense or Conv layer's product of ``x`` at the layer's
    ``precision``: ``SCOPE``, the enclosing ``product_tier_scope``'s
    (``scope_tier``); a resolved precision, ``product_tier(precision,
    x.device)`` for a float32 ``x`` (None is the reference's backend
    default: TF32 on a card, FP32 on the CPU), FP32 for another dtype."""
    if precision == SCOPE:
        return scope_tier(x)
    if x.dtype != torch.float32:
        return "fp32"
    return product_tier(precision, x.device)


def check_fp32_products(rtol: float, device) -> None:
    """Raise if a solve at ``rtol`` below 1e-4 on a CUDA ``device`` would
    run its cuBLAS or cuDNN products in TF32.

    Importing the package turns TF32 off, but only through PyTorch's
    process-wide flags, which a caller may turn on again (directly, or
    through ``torch.set_float32_matmul_precision``). TF32's rounding
    swamps the solver's embedded error estimate below rtol 1e-4, where the
    reference forces full FP32 (``resolve_solver_precision``'s 'highest').
    Every solve entry point calls this for its device.
    """
    if torch.device(device).type != "cuda" or rtol >= 1e-4:
        return
    on = [name for name, flag in (
        ("torch.backends.cuda.matmul.allow_tf32",
         torch.backends.cuda.matmul.allow_tf32),
        ("torch.backends.cudnn.allow_tf32", torch.backends.cudnn.allow_tf32),
    ) if flag]
    if on:
        raise RuntimeError(
            f"rtol {rtol:g} < 1e-4 needs FP32 products, but {' and '.join(on)} "
            "is True: set it to False (importing localregneuralde_tpu_torch "
            "does) or loosen the tolerance"
        )


def glorot_uniform(shape, generator: Optional[torch.Generator] = None,
                   fan_in: Optional[int] = None, fan_out: Optional[int] = None):
    """Glorot (Xavier) uniform on the CPU from ``generator``:
    U(−l, l) with l = sqrt(6 / (fan_in + fan_out)); the fans default to
    ``shape[0]`` and ``shape[1]``."""
    fan_in = shape[0] if fan_in is None else fan_in
    fan_out = shape[1] if fan_out is None else fan_out
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


class Dense(Module):
    """Affine layer ``y = act(x @ w + b)``, ``w`` of shape (in, out).
    Glorot-uniform weight from ``generator``, zero bias (Lux defaults).
    Its product (and under autograd its transposes) runs at
    ``layer_tier(precision, x)``: with ``precision=SCOPE``, the default,
    the tier of the enclosing ``product_tier_scope`` (FP32 outside one),
    where the DE layers' dynamics and the families whose tier is not yet
    ported compute; with the reference's ``precision=None`` the backend
    default, TF32 on a card (``tier_matmul``), FP32 on the CPU."""

    def __init__(self, in_dim: int, out_dim: int, activation=None, *,
                 use_bias: bool = True, precision=SCOPE, generator=None,
                 device=None):
        super().__init__()
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.activation = resolve_activation(activation)
        self.use_bias = use_bias
        self.precision = precision
        self.w = nn.Parameter(
            glorot_uniform((in_dim, out_dim), generator).to(device)
        )
        if use_bias:
            self.b = nn.Parameter(torch.zeros(out_dim, device=device))

    def apply_layer(self, x, state, *, training: bool = False):
        tier = layer_tier(self.precision, x)
        # one product over the rows flattened, whatever the weight's
        # requires_grad: ``torch.matmul`` folds a batched, non-contiguous
        # input into one product only for a weight that does not require
        # grad, so a program with the weights baked (utils/export.py) would
        # part from the live layer by rounding
        rows = x.reshape(-1, self.in_dim)
        if tier != "fp32":
            y = tier_matmul(rows, self.w, tier)
        else:
            y = rows @ self.w
        y = y.reshape(x.shape[:-1] + (self.out_dim,))
        if self.use_bias:
            y = y + self.b
        return self.activation(y), state


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, with ``benchmark`` off, for the
    block only; the caller's flags are restored after it."""
    flags = torch.backends.cudnn
    saved = flags.deterministic, flags.benchmark
    flags.deterministic, flags.benchmark = True, False
    try:
        yield
    finally:
        flags.deterministic, flags.benchmark = saved


class _DeterministicConv(torch.autograd.Function):
    """A SAME, stride-1 NCHW convolution at the product tier ``tier``, the
    two products of its backward at ``grad_tier``: at ``"tf32"`` each
    product's operands are rounded with ``round_tf32`` and convolved in
    FP32 (never cuDNN's own TF32, whose operand rounding is the library's:
    the CPU could not reproduce it). On the card both directions run inside
    ``deterministic_cudnn``, entered in each: the backward runs later, on
    autograd's own thread, outside any block around the forward, which is
    also why the tiers are saved at the forward."""

    @staticmethod
    def forward(ctx, x, w, tier, grad_tier):
        ctx.save_for_backward(x, w)
        ctx.grad_tier = grad_tier
        with _cudnn_scope(x):
            return nn.functional.conv2d(_at(x, tier), _at(w, tier),
                                        padding="same")

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        t = ctx.grad_tier
        kh, kw = w.shape[-2:]
        with _cudnn_scope(x):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                _at(gy, t), _at(x, t), _at(w, t), None, [1, 1],
                [(kh - 1) // 2, (kw - 1) // 2], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


def _cudnn_scope(x):
    return deterministic_cudnn() if x.is_cuda else contextlib.nullcontext()


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, tier: str = "fp32",
                grad_tier: Optional[str] = None) -> torch.Tensor:
    """SAME, stride-1 convolution of an NHWC ``x`` with an HWIO ``w`` (odd
    kernel sizes), in PyTorch's NCHW convolution, at the product tier
    ``tier`` and under autograd at ``grad_tier`` (default ``tier``): FP32
    (the package turns cuDNN's TF32 off when it is imported), or at
    ``"tf32"`` on operands rounded with ``round_tf32``
    (``_DeterministicConv``). On the card it takes cuDNN's deterministic
    algorithms, forward and backward, so that a CIFAR training step repeats
    bitwise run to run with no process-wide flag; on the CPU at FP32 it is
    the plain convolution."""
    grad_tier = tier if grad_tier is None else grad_tier
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if x.is_cuda or tier != "fp32" or grad_tier != "fp32":
        y = _DeterministicConv.apply(xc, wc, tier, grad_tier)
    else:
        y = nn.functional.conv2d(xc, wc, padding="same")
    return y.permute(0, 2, 3, 1)


class _TimeChannel(torch.autograd.Function):
    """``t·conv(1, w_t)`` over a batch of NHWC ``shape`` at the tiers:
    forward the FP32 sum of the time taps rounded to ``tier`` (a ones image
    is exact in TF32) times t unrounded; backward, at ``grad_tier``, ``w_t``'s
    gradient t·Σ of the output cotangent rounded to ``grad_tier`` over the
    pixels each tap reaches (the reference's ``s·(m ·_N dy)`` at
    ``grad_precision``, ``fused_conv_bwd.py:144-148`` there, which rounds dy
    before the sum). The output is the whole batch's, so the backward sees
    each pixel's cotangent."""

    @staticmethod
    def forward(ctx, wt, t, shape, tier, grad_tier):
        ones = wt.new_ones((1,) + tuple(shape[1:-1]) + (1,))
        tmap = conv2d_nhwc(ones, _at(wt, tier))
        is_tensor = isinstance(t, torch.Tensor)
        ctx.save_for_backward(wt, tmap, t if is_tensor else None)
        ctx.t, ctx.grad_tier = None if is_tensor else t, grad_tier
        out = (t * tmap).expand(tuple(shape[:-1]) + (wt.shape[-1],))
        return out.contiguous()

    @staticmethod
    def backward(ctx, g):
        wt, tmap, t = ctx.saved_tensors
        t = ctx.t if t is None else t
        d_wt = d_t = None
        if ctx.needs_input_grad[0]:
            gs = _at(g, ctx.grad_tier).sum(0, keepdim=True).permute(0, 3, 1, 2)
            ones = gs.new_ones((1, 1) + gs.shape[2:])
            kh, kw = wt.shape[:2]
            with _cudnn_scope(g):
                _, gw, _ = torch.ops.aten.convolution_backward(
                    gs, ones, wt.permute(3, 2, 0, 1), None, [1, 1],
                    [(kh - 1) // 2, (kw - 1) // 2], [1, 1], False, [0, 0], 1,
                    [False, True, False])
            d_wt = t * gw.permute(2, 3, 1, 0)
        if ctx.needs_input_grad[1]:
            d_t = (g * tmap).sum().reshape(t.shape)
        return d_wt, d_t, None, None, None


def conv2d_nhwc_td(x: torch.Tensor, w: torch.Tensor, t, tier: str = "fp32",
                   grad_tier: Optional[str] = None) -> torch.Tensor:
    """``conv2d_nhwc(concat(x, t·1), w)`` without the concat: by linearity
    ``conv(x, W[:, :, :C]) + t·conv(1, W[:, :, C:])``, the time channel a
    one-channel conv of a ones image (reference ``models/common.py:18-77``),
    at the tiers of ``conv2d_nhwc``: the time map at ``tier`` is the FP32
    sum of the rounded time taps, multiplied by t unrounded
    (``_TimeChannel``). ``w``'s last input channel is the time channel."""
    c = x.shape[-1]
    grad_tier = tier if grad_tier is None else grad_tier
    if tier == grad_tier == "fp32":
        tmap = conv2d_nhwc(x.new_ones((1,) + x.shape[1:-1] + (1,)),
                           w[:, :, c:, :])
        return conv2d_nhwc(x, w[:, :, :c, :]) + t * tmap
    return (conv2d_nhwc(x, w[:, :, :c, :], tier, grad_tier)
            + _TimeChannel.apply(w[:, :, c:, :], t, x.shape, tier, grad_tier))


class Conv(Module):
    """2-D convolution in NHWC with an HWIO weight ``w`` of shape (kh, kw,
    in, out) and an optional bias ``b``; SAME padding, stride 1 (the
    reference's ``pad=(1, 1)`` 3×3 convolutions, ``construct.jl:212-228``).
    Glorot-uniform weight with the fan over (kh, kw, in) → out, as the
    reference's ``glorot_uniform(in_axis=(0, 1, 2), out_axis=3)``; zero
    bias. ``precision`` as ``Dense``'s (``layer_tier``). The reference's
    ``padding`` and ``stride`` options are not carried: every conv of the
    model zoo is SAME with stride 1."""

    def __init__(self, kernel_size, in_channels: int, out_channels: int,
                 activation=None, *, use_bias: bool = True, precision=SCOPE,
                 generator=None, device=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.activation = resolve_activation(activation)
        self.use_bias = use_bias
        self.precision = precision
        kh, kw = self.kernel_size
        self.w = nn.Parameter(glorot_uniform(
            (kh, kw, in_channels, out_channels), generator,
            fan_in=kh * kw * in_channels, fan_out=out_channels).to(device))
        if use_bias:
            self.b = nn.Parameter(torch.zeros(out_channels, device=device))

    def apply_layer(self, x, state, *, training: bool = False):
        y = conv2d_nhwc(x, self.w, layer_tier(self.precision, x))
        if self.use_bias:
            y = y + self.b
        return self.activation(y), state


# the layer-state key under which the global grid of data parallelism
# (``parallel/sharded_train.py``) gives a layer its ``DPGroup``
GROUP = "dp_group"


class BatchNorm(Module):
    """Batch normalisation over every axis but the last (the channels).

    Parameters ``scale`` and ``bias``; state ``mean`` and ``var``, updated
    in training as ``(1 − m)·old + m·batch`` with the **biased** batch
    variance (``torch.nn.BatchNorm2d`` keeps the unbiased one, so it is not
    wrapped). Eval mode normalises with the running stats, or with
    ``eval_stats='batch'`` with the batch's own (the reference's escape
    hatch for BatchNorm inside ODE dynamics; running stats kept). The
    reference's ``affine=False`` is not carried: no model uses it.

    On the global grid of data parallelism the state carries a
    ``DPGroup`` under ``GROUP`` (``group_moments``): the input is then one
    rank's rows of a batch spread over the group's ranks, and the batch's
    moments are over all their rows, each the rank mean of the ranks'
    moments in the same two passes (``parallel.mesh.group_mean``: added in
    rank order, the cotangents summed over the ranks in the backward). Every
    rank then normalises with the same bytes and writes the same running
    stats. The returned state carries no group."""

    # the global grid gives the layer its group (``parallel.sharded_train``)
    group_moments = True

    def __init__(self, features: int, activation=None, *,
                 momentum: float = 0.1, eps: float = 1e-5,
                 eval_stats: str = "running", device=None):
        super().__init__()
        if eval_stats not in ("running", "batch"):
            raise ValueError(
                f"eval_stats must be 'running' or 'batch', got {eval_stats!r}")
        self.features = features
        self.activation = resolve_activation(activation)
        self.momentum = momentum
        self.eps = eps
        self.eval_stats = eval_stats
        self.device = device
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def init_state(self) -> dict:
        return {"mean": torch.zeros(self.features, device=self.device),
                "var": torch.ones(self.features, device=self.device)}

    def apply_layer(self, x, state, *, training: bool = False):
        axes = tuple(range(x.ndim - 1))
        group = state.get(GROUP)
        if group is not None:
            state = {k: v for k, v in state.items() if k != GROUP}
        if training or self.eval_stats == "batch":
            mean = x.mean(dim=axes)
            if group is not None:
                from ..parallel.mesh import group_mean

                mean = group_mean(mean, group)
            var = torch.square(x - mean).mean(dim=axes)
            if group is not None:
                var = group_mean(var, group)
        else:
            mean, var = state["mean"], state["var"]
        new_state = state
        if training:
            m = self.momentum
            new_state = {"mean": (1 - m) * state["mean"] + m * mean.detach(),
                         "var": (1 - m) * state["var"] + m * var.detach()}
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return self.activation(y), new_state


class Flatten(Module):
    """(B, ...) → (B, prod(...))."""

    def apply_layer(self, x, state, *, training: bool = False):
        return x.reshape(x.shape[0], -1), state


class WrappedFunction(Module):
    """Lift a pure function into a parameterless layer."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def apply_layer(self, x, state, *, training: bool = False):
        return self.fn(x), state


# the reference's name for a function layer (``nn/basic.py:238``)
Lambda = WrappedFunction


class Chain(Module):
    """Sequential container of named sublayers (``layer_0``, ``layer_1``, ...
    when given positionally). Parameter names join the layer names with
    dots, e.g. ``neural_ode.model.layer_0.w``, which is the reference's
    parameter tree flattened."""

    time_aware = True  # containers pass ArrayAndTime through to sublayers

    def __init__(self, *layers: Module, **named_layers: Module):
        super().__init__()
        if layers and named_layers:
            raise ValueError("pass either positional or named layers, not both")
        named = named_layers or {f"layer_{i}": l for i, l in enumerate(layers)}
        for name, layer in named.items():
            self.add_module(name, layer)

    @property
    def layers(self) -> dict:
        return dict(self.named_children())

    def init_state(self) -> dict:
        return {name: layer.init_state() for name, layer in self.named_children()}

    def apply_layer(self, x, state, *, training: bool = False):
        new_state = {}
        for name, layer in self.named_children():
            x, new_state[name] = layer(x, state[name], training=training)
        return x, new_state
