"""Carry parameters over from the JAX package.

The JAX package keeps parameters as a nested dict of arrays
(``{"neural_ode": {"model": {"layer_0": {"w", "b"}, ...}}, "classifier":
{...}}``). The port's modules use the same names and layouts, so a parameter
path joined with dots is the port's parameter name
(``neural_ode.model.layer_0.w``) and the values carry over unchanged.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(tree, *, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a JAX parameter tree (nested dicts of numpy-convertible
    arrays) into ``{dotted name: float32 tensor}``; empty dicts (layers
    without parameters) contribute nothing."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(params_from_jax(value, prefix=name + "."))
        else:
            out[name] = torch.tensor(np.asarray(value, dtype=np.float32))
    return out


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, tree) -> None:
    """Copy a JAX parameter tree into ``model``; every parameter of the
    model must be present with the same shape, and nothing else."""
    params = params_from_jax(tree)
    own = dict(model.named_parameters())
    if set(params) != set(own):
        raise KeyError(
            f"parameter names differ: only in JAX {sorted(set(params) - set(own))}, "
            f"only in the port {sorted(set(own) - set(params))}"
        )
    for name, value in params.items():
        if own[name].shape != value.shape:
            raise ValueError(
                f"{name}: JAX shape {tuple(value.shape)}, port "
                f"{tuple(own[name].shape)}"
            )
        own[name].copy_(value)


def latent_tree(tree) -> dict:
    """The JAX latent ODE's parameter tree (``construct_time_series``) in
    the port's names: the reference's ``Recurrence`` returns its cell's
    parameters at its own level, the port's keeps them under ``cell``
    (``gru.update_gate...`` → ``gru.cell.update_gate...``). The three GRU
    gate chains, ``rec_to_gen``, the eight Dense layers of the generative
    chain and ``gen_to_data`` then load with ``load_jax_params``, in the
    ``(in, out)`` layout."""
    return {**tree, "gru": {"cell": tree["gru"]}}
