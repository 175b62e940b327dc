"""Train state, the train step, warmup and the eval step (reference
``experiments/src/utils.jl:104-153``); counterpart of
``localregneuralde_tpu/harness/train.py`` for single steps (no
microbatching, EMA or K-step calls yet).

PyTorch runs eagerly, so the step is forward, ``torch.autograd.grad`` and
the optimizer update in turn; the parameters are updated in place.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch


@dataclass
class TrainState:
    """``params`` maps parameter names (``neural_ode.model.layer_0.w``, ...)
    to leaf tensors; ``state`` is the model's nested layer state;
    ``opt_state`` the ``torch.optim`` optimizer bound to ``params`` (None
    without an optimizer); ``step`` counts optimizer steps."""

    params: Dict[str, torch.Tensor]
    state: Any
    opt_state: Any = None
    step: int = 0


def create_train_state(model, optimizer=None) -> TrainState:
    """The model's parameters as trainable leaves, its initial layer state
    and, given an ``OptimizerSpec``, the optimizer bound to them."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.named_parameters()}
    opt_state = None if optimizer is None else optimizer.init(params)
    return TrainState(params=params, state=model.init_state(),
                      opt_state=opt_state)


def _detached(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree


def make_train_step(model, loss_fn, optimizer) -> Callable:
    """``train_step(ts, (x, y), w_reg, lr) -> (ts', loss, stats)``: one
    forward, the gradient of the loss with respect to ``ts.params`` and one
    optimizer update at learning rate ``lr``. The parameters and optimizer
    state are updated in place; ``ts'`` carries the new layer state."""

    def train_step(ts: TrainState, data, w_reg, lr):
        loss, st_, stats = loss_fn(
            model, ts.params, ts.state, data, w_reg, training=True
        )
        params = list(ts.params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        optimizer.apply(ts.opt_state, params, grads, lr)
        ts_new = TrainState(params=ts.params, state=_detached(st_),
                            opt_state=ts.opt_state, step=ts.step + 1)
        return ts_new, loss.detach(), _detached(stats)

    return train_step


def make_eval_step(model, loss_fn) -> Callable:
    """``eval_step(ts, (x, y), w_reg) -> (loss, stats)``, without gradients
    and without a host sync."""

    @torch.no_grad()
    def eval_step(ts: TrainState, data, w_reg):
        loss, _, stats = loss_fn(
            model, ts.params, ts.state, data, w_reg, training=False
        )
        return loss, stats

    return eval_step


def warmup_model(train_step, eval_step, ts, data, w_reg, lr):
    """One train step and one eval step on a copy of ``ts`` (reference
    ``utils.jl:126-153``): first-call set-up (kernel build, cuBLAS
    handles, the allocator's pools) happens before timing starts. The copy
    is discarded; ``ts`` is untouched. Either step may be None."""
    ts_copy = copy.deepcopy(ts)
    if train_step is not None:
        ts_copy, loss, _ = train_step(ts_copy, data, w_reg, lr)
        float(loss)
    if eval_step is not None:
        loss, _ = eval_step(ts_copy, data, w_reg)
        float(loss)
