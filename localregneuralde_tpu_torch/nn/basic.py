"""Basic layers: Dense, Flatten, WrappedFunction (alias Lambda), Chain.

Counterpart of ``localregneuralde_tpu/nn/basic.py``. Layout is the
reference's: batch-major ``(B, F)``, and a Dense weight is ``(in, out)``
(not ``nn.Linear``'s ``(out, in)``), so parameters carry over unchanged.
Conv and BatchNorm are not ported yet.
"""
from __future__ import annotations

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


def glorot_uniform(shape, generator: Optional[torch.Generator] = None):
    """Glorot (Xavier) uniform on the CPU from ``generator``:
    U(−l, l) with l = sqrt(6 / (fan_in + fan_out))."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
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
