"""Carry parameters and layer state over from the JAX package.

The JAX package keeps parameters as a nested dict of arrays
(``{"neural_ode": {"model": {"layer_0": {"w", "b"}, ...}}, "classifier":
{...}}``). The port's modules use the same names and layouts (Dense
``(in, out)``, Conv HWIO, BatchNorm ``scale``/``bias``), so a parameter
path joined with dots is the port's parameter name
(``neural_ode.model.layer_0.w``) and the values carry over unchanged. Layer
state (BatchNorm's running ``mean`` and ``var``) has the same paths in both
trees and carries over with ``state_from_jax``.
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


def numpy_tree(tree):
    """A JAX parameter tree as nested dicts of float32 numpy arrays, to
    feed the same values to both packages. The trees of the matrix-noise
    diffusion (``Dense(d, d·m)`` under ``diffusion``) and of the multistep
    models (``NeuralODE`` with ``solver='vcab3'``/``'vcabm3'``) have the
    port's names and layouts, so ``load_jax_params`` takes them as they
    are."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


def latent_tree(tree) -> dict:
    """The JAX latent ODE's parameter tree (``construct_time_series``) in
    the port's names: the reference's ``Recurrence`` returns its cell's
    parameters at its own level, the port's keeps them under ``cell``
    (``gru.update_gate...`` → ``gru.cell.update_gate...``). The three GRU
    gate chains, ``rec_to_gen``, the eight Dense layers of the generative
    chain and ``gen_to_data`` then load with ``load_jax_params``, in the
    ``(in, out)`` layout."""
    return {**tree, "gru": {"cell": tree["gru"]}}


def cifar_tree(tree) -> dict:
    """The JAX CIFAR model's parameter tree (``_construct_cifar10_cnn``) in
    the port's names: the reference's ``AugmenterLayer`` returns its conv's
    parameters at its own level, the port's keeps them under ``augment``
    (``augment.w`` → ``augment.augment.w``)."""
    return {**tree, "augment": {"augment": tree["augment"]}}


def state_from_jax(state, tree):
    """A copy of the port's layer state ``state`` with every tensor leaf
    that JAX's state tree holds at the same path (BatchNorm's running
    ``mean`` and ``var``; NFE counters and flags) taken from it, on the
    leaf's device. Generators and leaves JAX lacks are kept."""
    if isinstance(state, dict):
        return {k: state_from_jax(v, tree[k]) if isinstance(tree, dict)
                and k in tree else v for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        value = torch.tensor(np.asarray(tree), dtype=state.dtype)
        if value.shape != state.shape:
            raise ValueError(f"state shape {tuple(value.shape)} from JAX, "
                             f"{tuple(state.shape)} in the port")
        return value.to(state.device)
    return state
