"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

Every wrapper counts its kernel launches: a plain-integer ``launches``, or,
for the TD-MLP and conv families' wrappers, which launch at the FP32 or the
TF32 tier, ``tier_launches`` by tier (``tier_launch_counts``).
``launch_counts`` reads them (a tiered wrapper's sum) and
``reset_launch_counts`` zeroes them.
"""
from .conv_orient import conv_orient_im2col, conv_orient_plain, conv_orient_tap
from .fused_conv import (
    ConvFamilySpec,
    ConvWeights,
    conv_dynamics_plain,
    conv_step_plain,
    fused_conv_step,
    match_conv_family,
)
from .fused_conv_bwd import (
    FusedConvStep,
    differentiable_conv_step,
    fused_conv_step_bwd,
    fused_conv_step_bwd_plain,
)
from .fused_mlp import (
    FusedTDMLP,
    TDMLPWeights,
    differentiable_tdmlp,
    fused_tdmlp,
    fused_tsit5_step,
    tdmlp_plain,
    tsit5_step_plain,
)
from .fused_mlp_bwd import (
    FusedTsit5Step,
    differentiable_step,
    fused_step_bwd,
    fused_step_bwd_plain,
)
from .fused_sde_solve import (
    SDEWeights,
    ScoreChainSpec,
    match_td_score_chain,
    persistent_sde_solve,
    persistent_sde_solve_plain,
    persistent_vpsde_solve,
    persistent_vpsde_solve_plain,
    score_chain_params,
    td_score_eval_plain,
)
from .fused_sde_sweep import persistent_sde_sweep, persistent_sde_sweep_plain
from .fused_solve import (
    DenseChainSpec,
    chain_eval,
    match_dense_chain,
    persistent_chain_solve,
    persistent_chain_solve_plain,
    persistent_pf_solve,
    persistent_pf_solve_plain,
    persistent_tsit5_solve,
    persistent_tsit5_solve_plain,
    solve_feasible,
)
from .fused_solve_bwd import (
    chain_sweep_feasible,
    persistent_chain_sweep,
    persistent_chain_sweep_plain,
    persistent_stored_sweep,
    persistent_stored_sweep_plain,
    persistent_two_level_sweep,
    persistent_two_level_sweep_plain,
    step_bwd_feasible,
    sweep_feasible,
)

KERNELS = {
    "tdmlp": fused_tdmlp,
    "tsit5_step": fused_tsit5_step,
    "persistent_tsit5_solve": persistent_tsit5_solve,
    "tsit5_step_bwd": fused_step_bwd,
    "persistent_stored_sweep": persistent_stored_sweep,
    "persistent_two_level_sweep": persistent_two_level_sweep,
    "persistent_sde_solve": persistent_sde_solve,
    "persistent_sde_sweep": persistent_sde_sweep,
    "persistent_chain_solve": persistent_chain_solve,
    "persistent_chain_sweep": persistent_chain_sweep,
    "fused_conv_step": fused_conv_step,
    "fused_conv_step_bwd": fused_conv_step_bwd,
    "persistent_vpsde_solve": persistent_vpsde_solve,
    "persistent_pf_solve": persistent_pf_solve,
    "conv_orient_tap": conv_orient_tap,
    "conv_orient_im2col": conv_orient_im2col,
}


def launch_counts() -> dict:
    return {name: (sum(fn.tier_launches.values())
                   if hasattr(fn, "tier_launches") else fn.launches)
            for name, fn in KERNELS.items()}


def tier_launch_counts() -> dict:
    """Launches by product tier, for the wrappers that count them: a tier,
    or for the VJPs and the sweeps their tiers joined by ``/`` (the step
    VJPs' recompute/gradients, kernels 3 and 14; kernel 7's the same;
    kernel 8's replay/recompute/gradients)."""
    return {name: dict(fn.tier_launches) for name, fn in KERNELS.items()
            if hasattr(fn, "tier_launches")}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        if hasattr(fn, "tier_launches"):
            fn.tier_launches.clear()
        else:
            fn.launches = 0


__all__ = [
    "ConvFamilySpec",
    "ConvWeights",
    "DenseChainSpec",
    "FusedConvStep",
    "FusedTDMLP",
    "FusedTsit5Step",
    "KERNELS",
    "SDEWeights",
    "ScoreChainSpec",
    "TDMLPWeights",
    "chain_eval",
    "chain_sweep_feasible",
    "solve_feasible",
    "step_bwd_feasible",
    "sweep_feasible",
    "conv_dynamics_plain",
    "conv_orient_im2col",
    "conv_orient_plain",
    "conv_orient_tap",
    "conv_step_plain",
    "differentiable_conv_step",
    "differentiable_step",
    "differentiable_tdmlp",
    "fused_conv_step",
    "fused_conv_step_bwd",
    "fused_conv_step_bwd_plain",
    "fused_step_bwd",
    "fused_step_bwd_plain",
    "fused_tdmlp",
    "fused_tsit5_step",
    "launch_counts",
    "match_conv_family",
    "match_dense_chain",
    "match_td_score_chain",
    "persistent_chain_solve",
    "persistent_chain_solve_plain",
    "persistent_chain_sweep",
    "persistent_chain_sweep_plain",
    "persistent_pf_solve",
    "persistent_pf_solve_plain",
    "persistent_sde_solve",
    "persistent_sde_solve_plain",
    "persistent_sde_sweep",
    "persistent_sde_sweep_plain",
    "persistent_stored_sweep",
    "persistent_stored_sweep_plain",
    "persistent_tsit5_solve",
    "persistent_tsit5_solve_plain",
    "persistent_two_level_sweep",
    "persistent_two_level_sweep_plain",
    "persistent_vpsde_solve",
    "persistent_vpsde_solve_plain",
    "reset_launch_counts",
    "score_chain_params",
    "tier_launch_counts",
    "td_score_eval_plain",
    "tdmlp_plain",
    "tsit5_step_plain",
]
