"""TDChain and the solution→tensor adapter.

Counterpart of ``localregneuralde_tpu/models/common.py`` (reference
``src/layers/common.jl:1-45`` and ``src/utils.jl:37-40``). Batch-major: the
time channel is concatenated along the last axis.
"""
from __future__ import annotations

import torch

from ..core.containers import ArrayAndTime, get_array
from ..nn.basic import Chain


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


def diffeqsol_to_array(sol):
    """Last saved state of a solve (reference ``src/utils.jl:37-40``)."""
    if hasattr(sol, "ys"):
        return sol.ys[-1]
    return get_array(sol)
