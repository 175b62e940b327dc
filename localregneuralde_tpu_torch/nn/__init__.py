from .basic import (
    BatchNorm,
    Chain,
    Conv,
    Dense,
    Flatten,
    Lambda,
    WrappedFunction,
    check_fp32_products,
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
    "check_fp32_products",
    "conv2d_nhwc",
    "glorot_uniform",
    "resolve_activation",
    "resolve_solver_precision",
]
