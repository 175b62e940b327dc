"""TDChain, AugmenterLayer, ReparameterizeLayer and the solution→tensor
adapters.

Counterpart of ``localregneuralde_tpu/models/common.py`` (reference
``src/layers/common.jl`` and ``src/utils.jl:37-46``). Batch-major: the
time channel is concatenated along the last axis, and a time series is
``(B, T, F)``.
"""
from __future__ import annotations

import torch

from ..core.containers import ArrayAndTime, get_array
from ..nn.basic import Chain, Conv, conv2d_nhwc_td, scope_tier
from ..nn.module import Module
from ..ode.solve import host_to_device
from .draws import pop_draws, to_device


def _conv_split(conv: Conv, x, t):
    """``conv(concat(x, t·1))`` without the concat (``conv2d_nhwc_td``), at
    the tier of ``nn.basic.product_tier_scope`` (the reference passes the
    conv's precision to both of its convs); the parameter layout is the
    concat's, the last input channel time. None when the weight's input
    count is not C + 1."""
    if conv.w.shape[2] != x.shape[-1] + 1:
        return None
    y = conv2d_nhwc_td(x, conv.w, t, scope_tier(x))
    if conv.use_bias:
        y = y + conv.b
    return conv.activation(y)


def _apply_time_dependent(layer, arr, state, t, training):
    """The concat-free path of a conv sublayer of a TDChain (a ``Conv``, or
    a ``Chain`` that starts with one); None where the generic concat
    applies."""
    if isinstance(layer, Conv):
        y = _conv_split(layer, arr, t)
        return None if y is None else (y, state)
    if isinstance(layer, Chain):
        children = list(layer.named_children())
        if not children or not isinstance(children[0][1], Conv):
            return None
        y = _conv_split(children[0][1], arr, t)
        if y is None:
            return None
        new_state = {children[0][0]: state[children[0][0]]}
        for name, sub in children[1:]:
            y, new_state[name] = sub(y, state[name], training=training)
        return y, new_state
    return None


class TDChain(Chain):
    """Time-dependent chain: every sublayer's input gets a ``ones·t``
    channel appended along the last axis, which is why the reference's
    widths read ``Dense(F+1 → H), Dense(H+1 → F)``. A conv sublayer takes
    the concat-free path (``_conv_split``). Takes ``ArrayAndTime`` or an
    ``(x, t)`` tuple and returns the same kind."""

    def apply_layer(self, x, state, *, training: bool = False):
        if isinstance(x, ArrayAndTime):
            arr, t = x.array, x.scalar
        elif isinstance(x, tuple):
            arr, t = x
        else:
            raise TypeError("TDChain expects ArrayAndTime or an (x, t) tuple")
        new_state = {}
        for name, layer in self.named_children():
            out = _apply_time_dependent(layer, arr, state[name], t, training)
            if out is None:
                t_channel = arr.new_ones(arr.shape[:-1] + (1,)) * t
                out = layer(torch.cat([arr, t_channel], dim=-1), state[name],
                            training=training)
            arr, new_state[name] = out
            arr = get_array(arr)
        if isinstance(x, ArrayAndTime):
            return ArrayAndTime(arr, t), new_state
        return (arr, t), new_state


class AugmenterLayer(Module):
    """ANODE-style augmentation (reference ``src/layers/common.jl:79-93``):
    run ``augment`` and concatenate its output to the input along the
    channels (the last axis; the reference's ``axis`` option is not carried,
    no model sets it). The sublayer's parameters sit under ``augment.``."""

    def __init__(self, augment: Module):
        super().__init__()
        self.augment = augment

    def init_state(self) -> dict:
        return self.augment.init_state()

    def apply_layer(self, x, state, *, training: bool = False):
        y, st = self.augment(x, state, training=training)
        return torch.cat([x, y], dim=-1), st


def reparam_noise(generator: torch.Generator, shape, like: torch.Tensor):
    """ε ~ N(0, 1) of the reparameterisation, drawn from the layer's CPU
    generator and moved to ``like``'s device without waiting for it. Tests
    replace this function to inject the reference's normals."""
    return host_to_device(torch.randn(shape, generator=generator), like)


class ReparameterizeLayer(Module):
    """VAE reparameterisation (reference ``src/layers/common.jl:47-77``).

    Splits the last axis into (μ₀, logσ²). In training mode it returns
    ``μ₀ + exp(logσ²/2)·ε`` with ε drawn from the layer state's generator
    (``reparam_noise``, through ``draw``), in eval mode μ₀. μ₀ and logσ² go
    into the returned state for the KL term of the latent-ODE loss; in eval
    mode the state's ``logvar`` holds μ₀, as the reference's does
    (``common.py:184``). ``latent_dims``, the width of μ₀, lets a train
    step stage ε before the call (``models/draws.py``)."""

    # ε has the batch's rows on its first axis (models/draws.py::rows_of)
    draw_row_axes = {"eps": 0}

    def __init__(self, rng_seed: int = 0, latent_dims: int = None):
        super().__init__()
        self.rng_seed = int(rng_seed)
        self.latent_dims = latent_dims

    def draw(self, state, rows: int, width: int = None) -> dict:
        """A training call's ε, ``(rows, width)`` standard normals on the
        host (``width`` defaults to ``latent_dims``)."""
        width = self.latent_dims if width is None else width
        if width is None:
            raise ValueError("ReparameterizeLayer.draw needs latent_dims to "
                             "stage ε ahead of the call")
        cpu = torch.empty(0)
        return {"eps": reparam_noise(state["rng"], (rows, width), cpu)}

    def init_state(self) -> dict:
        return {
            "rng": torch.Generator().manual_seed(self.rng_seed),
            "mu": torch.zeros((1, 1)),
            "logvar": torch.zeros((1, 1)),
        }

    def apply_layer(self, x, state, *, training: bool = False):
        draws, state = pop_draws(state)
        latent = x.shape[-1] // 2
        mu, logvar = x[..., :latent], x[..., latent:]
        if training:
            if draws is None:
                draws = to_device(self.draw(state, mu.shape[0], latent), mu)
            y = mu + torch.exp(logvar / 2) * draws["eps"]
            return y, {"rng": state["rng"], "mu": mu, "logvar": logvar}
        return mu, {"rng": state["rng"], "mu": mu, "logvar": mu}


def diffeqsol_to_array(sol):
    """Last saved state of a solve (reference ``src/utils.jl:37-40``)."""
    if hasattr(sol, "ys"):
        return sol.ys[-1]
    return get_array(sol)


def diffeqsol_to_timeseries(sol):
    """The saved states stacked along a time axis, ``(B, T, F)``
    (reference ``src/utils.jl:42-46``; batch-major here)."""
    if hasattr(sol, "ys"):
        return sol.ys.movedim(0, 1)
    return sol
