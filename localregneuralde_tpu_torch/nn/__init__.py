from .basic import (
    Chain,
    Dense,
    Flatten,
    Lambda,
    WrappedFunction,
    glorot_uniform,
    resolve_activation,
    resolve_solver_precision,
)
from .module import Module
from .recurrence import Recurrence

__all__ = [
    "Chain",
    "Dense",
    "Flatten",
    "Lambda",
    "Module",
    "Recurrence",
    "WrappedFunction",
    "glorot_uniform",
    "resolve_activation",
    "resolve_solver_precision",
]
