from .basic import (
    BatchNorm,
    Chain,
    Conv,
    Dense,
    Flatten,
    Lambda,
    WrappedFunction,
    conv2d_nhwc,
    glorot_uniform,
    resolve_activation,
    resolve_solver_precision,
)
from .module import Module
from .recurrence import Recurrence

__all__ = [
    "BatchNorm",
    "Chain",
    "Conv",
    "Dense",
    "Flatten",
    "Lambda",
    "Module",
    "Recurrence",
    "WrappedFunction",
    "conv2d_nhwc",
    "glorot_uniform",
    "resolve_activation",
    "resolve_solver_precision",
]
