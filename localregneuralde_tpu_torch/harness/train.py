"""Train state and the eval step (reference ``experiments/src/utils.jl``);
counterpart of ``localregneuralde_tpu/harness/train.py``. The train step,
optimizer state and warmup come with the training slice."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch


@dataclass
class TrainState:
    """``params`` maps parameter names (``neural_ode.model.layer_0.w``, ...)
    to tensors; ``state`` is the model's nested layer state."""

    params: Dict[str, torch.Tensor]
    state: Any


def create_train_state(model) -> TrainState:
    params = {k: v.detach() for k, v in model.named_parameters()}
    return TrainState(params=params, state=model.init_state())


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
