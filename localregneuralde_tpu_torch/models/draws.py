"""A training step's random draws, staged ahead of the step.

The stochastic layers (``NeuralODE``: the unbiased t1 or the biased
reservoir's uniforms; ``NeuralDSDE``: the Brownian tree's seed, t1 or the
reservoir, the regulariser's noise; ``ReparameterizeLayer``: ε) draw from
CPU generators in their layer state. Each has one method that draws a
call's values, ``draw(state, rows) -> {name: CPU tensor}``, through the
module-level ``sample_*`` and ``reparam_noise`` functions, in the order the
call uses them. The call reads the values from device tensors: given under
the layer state's ``"draws"`` key, or, when the key is absent, drawn there
and then by the same method.

A train step stages the draws of the whole model before it runs
(``stage_draws``), moves them to the device and inserts them into the
state (``with_draws``). The step itself then issues device work only, so
the K-step call can capture K steps in one CUDA graph and feed each replay
new draws, with the arithmetic of the eager step. The generators advance as
the eager calls would have advanced them: the same draws, in the same
order.

A draw with a row of the batch on an axis (the reparameterisation's ε,
the SDE regulariser's normals) is named in its layer's ``draw_row_axes``.
The global grid of data parallelism stages the whole batch's draws on
every rank, the same from the same replicated generators, and gives each
rank its rows of them (``rows_of``): a rank's rows draw what the
single-device step's would.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ode.solve import host_to_device

DRAWS = "draws"

Staged = Dict[Tuple[str, ...], Dict[str, torch.Tensor]]


def pop_draws(state: dict):
    """``(draws, state without them)``; draws is None when the state
    carries none."""
    if DRAWS not in state:
        return None, state
    state = dict(state)
    return state.pop(DRAWS), state


def layers_with(model, state, attr, path=()):
    """``(path, layer, layer state)`` of every layer of ``model`` with the
    attribute ``attr`` (or one of a tuple of them), found by walking the
    children whose names key the state tree; a layer found is not walked
    into."""
    attrs = (attr,) if isinstance(attr, str) else tuple(attr)
    if any(hasattr(model, a) for a in attrs):
        yield path, model, state
        return
    if not isinstance(state, dict):
        return
    for name, child in model.named_children():
        if name in state:
            yield from layers_with(child, state[name], attr, path + (name,))


def stochastic_layers(model, state):
    """``(path, layer, layer state)`` of every layer with a ``draw``
    method."""
    return layers_with(model, state, "draw")


def stage_draws(model, state, rows: int) -> Staged:
    """One training call's draws of every stochastic layer for a batch of
    ``rows``, on the host; advances the layers' generators."""
    return {path: layer.draw(st, rows)
            for path, layer, st in stochastic_layers(model, state)}


def rows_of(model, state, staged: Staged, piece: slice) -> Staged:
    """``staged`` with each draw a layer names in its ``draw_row_axes``
    (draw name → the axis of the batch's rows) cut to the rows ``piece``;
    the other draws as they are."""
    axes = {path: getattr(layer, "draw_row_axes", {})
            for path, layer, _ in stochastic_layers(model, state)}
    out = {}
    for path, draws in staged.items():
        out[path] = {}
        for k, v in draws.items():
            if k in axes[path]:
                idx = (slice(None),) * axes[path][k] + (piece,)
                v = v[idx].contiguous()
            out[path][k] = v
    return out


def to_device(draws, like: torch.Tensor):
    """A layer's draws (or a whole ``Staged``) on ``like``'s device,
    copied through pinned memory without blocking."""
    if isinstance(draws, torch.Tensor):
        return host_to_device(draws, like)
    return {k: to_device(v, like) for k, v in draws.items()}


def with_draws(state, staged: Staged):
    """The state tree with each layer's draws under its ``"draws"`` key;
    the dicts on the way are copied, the tensors shared."""
    for path, draws in staged.items():
        state = with_key(state, path, DRAWS, draws)
    return state


def with_key(tree, path, key: str, value):
    """The state tree with ``value`` under ``key`` in the layer state at
    ``path``; the dicts on the way are copied."""
    tree = dict(tree)
    if not path:
        tree[key] = value
        return tree
    tree[path[0]] = with_key(tree[path[0]], path[1:], key, value)
    return tree


def cloned_generators(state):
    """``state`` with each ``torch.Generator`` replaced by a copy at the
    same position (``get_state``/``set_state``), and each tensor by a
    copy: draws staged from it, or a call on it, leave ``state`` as it
    was."""
    if isinstance(state, torch.Generator):
        g = torch.Generator(device=state.device)
        g.set_state(state.get_state())
        return g
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, dict):
        return {k: cloned_generators(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(cloned_generators(v) for v in state)
    return state


def stage_eval_draws(model, state, rows: int) -> Staged:
    """One eval call's draws of every stochastic layer for a batch of
    ``rows``, on the host; advances the layers' generators. Only the
    layers whose ``draw`` takes ``training`` draw in eval (the NeuralDSDE's
    Brownian seed); the NeuralODE's t1 or reservoir and the
    reparameterisation's ε are training draws."""
    import inspect

    return {path: layer.draw(st, rows, training=False)
            for path, layer, st in stochastic_layers(model, state)
            if "training" in inspect.signature(layer.draw).parameters}
