"""``ArrayAndTime``: a value tensor paired with a scalar time.

Counterpart of ``localregneuralde_tpu/core/containers.py`` (reference
``src/utils.jl:12-23``): the integration time rides through arbitrary layers
so that time-dependent layers (``TDChain``) can consume it while plain layers
ignore it.
"""
from __future__ import annotations

from typing import Any, NamedTuple


class ArrayAndTime(NamedTuple):
    array: Any   # torch.Tensor
    scalar: Any  # scalar time: float or 0-d tensor


def get_array(x):
    """Return the payload tensor (reference ``src/utils.jl:17``)."""
    return x.array if isinstance(x, ArrayAndTime) else x
