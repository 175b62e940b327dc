"""Recurrence: run an RNN cell over the time axis.

Counterpart of ``localregneuralde_tpu/nn/recurrence.py`` (the Latent-ODE
encoder, reference ``experiments/src/construct.jl:231``). The reference
scans with ``lax.scan``; here it is a Python loop over the T time slices
(49 for PhysioNet), each one eager evaluation of the cell.

Input is batch-major ``(B, T, F)``; the cell sees ``(B, F)`` slices::

    carry0 = cell.initial_carry(x_t)          # from the first time slice
    (y, carry), st = cell((x_t, carry), st, training=...)

The last ``y`` is returned (sequence to vector, as in the reference).
"""
from __future__ import annotations

from .module import Module


class Recurrence(Module):
    def __init__(self, cell: Module):
        super().__init__()
        self.cell = cell

    def init_state(self) -> dict:
        return self.cell.init_state()

    def apply_layer(self, x, state, *, training: bool = False):
        carry = self.cell.initial_carry(x[:, 0])
        y = None
        for t in range(x.shape[1]):
            (y, carry), state = self.cell((x[:, t], carry), state,
                                          training=training)
        return y, state
