"""TDChain, ReparameterizeLayer and the solution→tensor adapters.

Counterpart of ``localregneuralde_tpu/models/common.py`` (reference
``src/layers/common.jl`` and ``src/utils.jl:37-46``). Batch-major: the
time channel is concatenated along the last axis, and a time series is
``(B, T, F)``.
"""
from __future__ import annotations

import torch

from ..core.containers import ArrayAndTime, get_array
from ..nn.basic import Chain
from ..nn.module import Module
from ..ode.solve import host_to_device


class TDChain(Chain):
    """Time-dependent chain: every sublayer's input gets a ``ones·t``
    channel appended along the last axis, which is why the reference's
    widths read ``Dense(F+1 → H), Dense(H+1 → F)``. Takes ``ArrayAndTime`` or
    an ``(x, t)`` tuple and returns the same kind."""

    def apply_layer(self, x, state, *, training: bool = False):
        if isinstance(x, ArrayAndTime):
            arr, t = x.array, x.scalar
        elif isinstance(x, tuple):
            arr, t = x
        else:
            raise TypeError("TDChain expects ArrayAndTime or an (x, t) tuple")
        new_state = {}
        for name, layer in self.named_children():
            t_channel = arr.new_ones(arr.shape[:-1] + (1,)) * t
            arr, new_state[name] = layer(
                torch.cat([arr, t_channel], dim=-1), state[name],
                training=training,
            )
            arr = get_array(arr)
        if isinstance(x, ArrayAndTime):
            return ArrayAndTime(arr, t), new_state
        return (arr, t), new_state


def reparam_noise(generator: torch.Generator, shape, like: torch.Tensor):
    """ε ~ N(0, 1) of the reparameterisation, drawn from the layer's CPU
    generator and moved to ``like``'s device without waiting for it. Tests
    replace this function to inject the reference's normals."""
    return host_to_device(torch.randn(shape, generator=generator), like)


class ReparameterizeLayer(Module):
    """VAE reparameterisation (reference ``src/layers/common.jl:47-77``).

    Splits the last axis into (μ₀, logσ²). In training mode it returns
    ``μ₀ + exp(logσ²/2)·ε`` with ε drawn from the layer state's generator
    (``reparam_noise``), in eval mode μ₀. μ₀ and logσ² go into the returned
    state for the KL term of the latent-ODE loss; in eval mode the state's
    ``logvar`` holds μ₀, as the reference's does (``common.py:184``)."""

    def __init__(self, rng_seed: int = 0):
        super().__init__()
        self.rng_seed = int(rng_seed)

    def init_state(self) -> dict:
        return {
            "rng": torch.Generator().manual_seed(self.rng_seed),
            "mu": torch.zeros((1, 1)),
            "logvar": torch.zeros((1, 1)),
        }

    def apply_layer(self, x, state, *, training: bool = False):
        latent = x.shape[-1] // 2
        mu, logvar = x[..., :latent], x[..., latent:]
        if training:
            eps = reparam_noise(state["rng"], tuple(mu.shape), mu)
            y = mu + torch.exp(logvar / 2) * eps
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
