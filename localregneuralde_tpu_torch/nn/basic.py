"""Basic layers: Dense, Conv, BatchNorm, Flatten, WrappedFunction (alias
Lambda), Chain.

Counterpart of ``localregneuralde_tpu/nn/basic.py``. Layout is the
reference's: batch-major ``(B, F)``, a Dense weight is ``(in, out)`` (not
``nn.Linear``'s ``(out, in)``), images are NHWC and a Conv weight is HWIO
``(kh, kw, in, out)``, so parameters carry over unchanged.
"""
from __future__ import annotations

import contextlib
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

    On the H100 every tier computes in true FP32 in this port: the package
    turns TF32 off, and the kernels use FP32 FFMA. A TF32 'default' tier is
    later work, and must never run below rtol 1e-4.
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
    Glorot-uniform weight from ``generator``, zero bias (Lux defaults)."""

    def __init__(self, in_dim: int, out_dim: int, activation=None, *,
                 use_bias: bool = True, generator=None, device=None):
        super().__init__()
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.activation = resolve_activation(activation)
        self.use_bias = use_bias
        self.w = nn.Parameter(
            glorot_uniform((in_dim, out_dim), generator).to(device)
        )
        if use_bias:
            self.b = nn.Parameter(torch.zeros(out_dim, device=device))

    def apply_layer(self, x, state, *, training: bool = False):
        y = x @ self.w
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
    """A SAME, stride-1 NCHW convolution whose forward and backward both run
    inside ``deterministic_cudnn``. The scope has to be entered in each
    direction: the backward runs later, on autograd's own thread, outside
    any block around the forward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with deterministic_cudnn():
            return nn.functional.conv2d(x, w, padding="same")

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        kh, kw = w.shape[-2:]
        with deterministic_cudnn():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [1, 1], [(kh - 1) // 2, (kw - 1) // 2],
                [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME, stride-1 convolution of an NHWC ``x`` with an HWIO ``w`` (odd
    kernel sizes), in PyTorch's NCHW convolution. It runs in FP32 on the
    card: the package turns cuDNN's TF32 off when it is imported. On the
    card it takes cuDNN's deterministic algorithms, forward and backward
    (``_DeterministicConv``), so that a CIFAR training step repeats
    bitwise run to run with no process-wide flag; on the CPU it is the
    plain convolution."""
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if x.is_cuda:
        y = _DeterministicConv.apply(xc, wc)
    else:
        y = nn.functional.conv2d(xc, wc, padding="same")
    return y.permute(0, 2, 3, 1)


def conv2d_nhwc_td(x: torch.Tensor, w: torch.Tensor, t) -> torch.Tensor:
    """``conv2d_nhwc(concat(x, t·1), w)`` without the concat: by linearity
    ``conv(x, W[:, :, :C]) + t·conv(1, W[:, :, C:])``, the time channel a
    one-channel conv of a ones image (reference ``models/common.py:18-77``).
    ``w``'s last input channel is the time channel."""
    c = x.shape[-1]
    tmap = conv2d_nhwc(x.new_ones((1,) + x.shape[1:-1] + (1,)), w[:, :, c:, :])
    return conv2d_nhwc(x, w[:, :, :c, :]) + t * tmap


class Conv(Module):
    """2-D convolution in NHWC with an HWIO weight ``w`` of shape (kh, kw,
    in, out) and an optional bias ``b``; SAME padding, stride 1 (the
    reference's ``pad=(1, 1)`` 3×3 convolutions, ``construct.jl:212-228``).
    Glorot-uniform weight with the fan over (kh, kw, in) → out, as the
    reference's ``glorot_uniform(in_axis=(0, 1, 2), out_axis=3)``; zero
    bias. The reference's ``padding`` and ``stride`` options are not
    carried: every conv of the model zoo is SAME with stride 1."""

    def __init__(self, kernel_size, in_channels: int, out_channels: int,
                 activation=None, *, use_bias: bool = True, generator=None,
                 device=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.activation = resolve_activation(activation)
        self.use_bias = use_bias
        kh, kw = self.kernel_size
        self.w = nn.Parameter(glorot_uniform(
            (kh, kw, in_channels, out_channels), generator,
            fan_in=kh * kw * in_channels, fan_out=out_channels).to(device))
        if use_bias:
            self.b = nn.Parameter(torch.zeros(out_channels, device=device))

    def apply_layer(self, x, state, *, training: bool = False):
        y = conv2d_nhwc(x, self.w)
        if self.use_bias:
            y = y + self.b
        return self.activation(y), state


class BatchNorm(Module):
    """Batch normalisation over every axis but the last (the channels).

    Parameters ``scale`` and ``bias``; state ``mean`` and ``var``, updated
    in training as ``(1 − m)·old + m·batch`` with the **biased** batch
    variance (``torch.nn.BatchNorm2d`` keeps the unbiased one, so it is not
    wrapped). Eval mode normalises with the running stats, or with
    ``eval_stats='batch'`` with the batch's own (the reference's escape
    hatch for BatchNorm inside ODE dynamics; running stats kept). The
    reference's ``affine=False`` is not carried: no model uses it."""

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
        if training or self.eval_stats == "batch":
            mean = x.mean(dim=axes)
            var = torch.square(x - mean).mean(dim=axes)
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
