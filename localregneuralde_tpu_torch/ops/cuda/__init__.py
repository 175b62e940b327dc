"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

Every wrapper keeps a plain-integer ``launches`` counter of kernel launches;
``launch_counts`` reads them and ``reset_launch_counts`` zeroes them.
"""
from .fused_mlp import (
    TDMLPWeights,
    fused_tdmlp,
    fused_tsit5_step,
    tdmlp_plain,
    tsit5_step_plain,
)
from .fused_solve import persistent_tsit5_solve, persistent_tsit5_solve_plain

KERNELS = {
    "tdmlp": fused_tdmlp,
    "tsit5_step": fused_tsit5_step,
    "persistent_tsit5_solve": persistent_tsit5_solve,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "TDMLPWeights",
    "fused_tdmlp",
    "fused_tsit5_step",
    "launch_counts",
    "persistent_tsit5_solve",
    "persistent_tsit5_solve_plain",
    "reset_launch_counts",
    "tdmlp_plain",
    "tsit5_step_plain",
]
