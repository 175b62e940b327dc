"""Module base: ``torch.nn.Module`` with explicit layer state.

Counterpart of ``localregneuralde_tpu/nn/module.py``. Parameters live in the
module as ``nn.Parameter``s; layer state (NFE counters, solver flags) is an
explicit nested dict that a call takes and returns, keyed like the
reference's, so that ``state["neural_ode"]["nfe"]`` reads the same::

    state = layer.init_state()
    y, new_state = layer(x, state, training=False)

The ``ArrayAndTime`` lift (reference ``src/utils.jl:20-23``) lives in
``forward``: a layer that is not time-aware unwraps the tensor, applies
itself and rewraps, so time rides through to the layers that consume it.
"""
from __future__ import annotations

from torch import nn

from ..core.containers import ArrayAndTime


class Module(nn.Module):
    """Base class of the port's layers; subclasses implement ``apply_layer``."""

    #: time-aware layers receive the full ArrayAndTime container
    time_aware: bool = False

    def init_state(self) -> dict:
        return {}

    def apply_layer(self, x, state, *, training: bool = False):
        raise NotImplementedError

    def forward(self, x, state=None, *, training: bool = False):
        if state is None:
            state = self.init_state()
        if isinstance(x, ArrayAndTime) and not self.time_aware:
            y, st = self.apply_layer(x.array, state, training=training)
            return ArrayAndTime(y, x.scalar), st
        return self.apply_layer(x, state, training=training)
