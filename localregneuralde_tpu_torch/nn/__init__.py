from .basic import (
    Chain,
    Dense,
    Flatten,
    WrappedFunction,
    glorot_uniform,
    resolve_activation,
    resolve_solver_precision,
)
from .module import Module

__all__ = [
    "Chain",
    "Dense",
    "Flatten",
    "Module",
    "WrappedFunction",
    "glorot_uniform",
    "resolve_activation",
    "resolve_solver_precision",
]
