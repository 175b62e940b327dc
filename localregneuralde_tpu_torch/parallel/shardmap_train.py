"""Per-rank-grid data parallelism (``train.data_parallel='shardmap'``).

Counterpart of ``localregneuralde_tpu/parallel/shardmap_train.py``: each rank
runs the whole single-device train step on its own rows, with its own
adaptive grid, so the persistent kernels run on every rank (kernels 4 with 8
or 7 for the MNIST ODE, 5 with 9 for the latent ODE, 10 with 12 for the
SDE); the ranks meet once a step, in the reductions below.

**The documented estimator deviation** (the JAX package's): with n ranks
the regularised objective is the mean of n independent solves of the
ranks' rows, each with its own steps and its own ``reg_val``, not one solve
of the global batch; NFE is reported as the rank mean (a float).

The state leaves are treated as the JAX package treats them
(``shardmap_train.py:106-207`` there):

- **generators** are per rank: before the step each carried generator
  gives one 62-bit word (advancing it identically on every rank), and the
  rank's generator is seeded from ``(word, rank)`` (``rank_state``; JAX's
  ``fold_in(key, axis_index)``). The step draws from the rank's generators
  and the carried ones stay replicated;
- **batch-shaped leaves** (at least 2-D with this rank's rows as their
  leading dimension: the latent model's ``mu`` and ``logvar``, the
  classifier's ``y_pred`` in the stats) stay local. JAX tells them apart by
  tracing at two batch sizes; the port's other leaves are 0-D counters and
  1-D statistics, so the rule does not mistake a 1-D pair for rows;
- **booleans** reduce by all-ranks AND (a diverged rank must surface);
- **the rest** is averaged over the ranks: in the state cast back to its
  dtype (NFE truncates to an integer, the BatchNorm running statistics are
  the ranks' mean), in the stats as float32 means (NFE a float).

The loss and the gradients are averaged over the ranks in one flattened
buffer, added in rank order (``mesh.ordered_sum``), so every rank applies
the same update and the parameters, the optimizer's state and the EMA stay
replicated.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..harness.optim import device_scalar_like
from ..harness.train import TrainState, device_w, stage_step, step_body
from ..models.draws import to_device
from .mesh import (
    DPGroup, gather_slots, is_batch_leaf, map_tensors, mean_over_ranks,
    tensor_leaves,
)


def _rank_generator(g: torch.Generator, rank: int) -> torch.Generator:
    word = int(torch.randint(0, 2 ** 62, (), generator=g))
    seed = np.random.SeedSequence([word, rank]).generate_state(1, np.uint64)
    out = torch.Generator(device=g.device)
    out.manual_seed(int(seed[0]) & (2 ** 63 - 1))
    return out


def rank_state(state, rank: int):
    """``state`` with each generator replaced by this rank's: a
    deterministic function of the carried generator's next word and
    ``rank``. Advances each carried generator by one word, identically on
    every rank; the tensors are shared."""
    if isinstance(state, torch.Generator):
        return _rank_generator(state, rank)
    if isinstance(state, dict):
        return {k: rank_state(v, rank) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(rank_state(v, rank) for v in state)
    return state


def reduce_tree(tree, rows: int, dp: DPGroup, *, keep_dtype: bool):
    """``tree`` with each tensor reduced over the ranks: batch-shaped ones
    kept, booleans by AND, the rest averaged (one collective for all of
    them, in float64, which holds every float32 and int32 exactly). With
    ``keep_dtype`` an average is cast back to its leaf's dtype, else it is
    float32 where the leaf is not floating."""
    leaves = tensor_leaves(tree)
    idx = [i for i, x in enumerate(leaves) if not is_batch_leaf(x, rows)]
    if not idx:
        return tree
    flat = torch.cat([leaves[i].reshape(-1).to(torch.float64) for i in idx])
    slots = gather_slots(flat, dp)
    out, k = list(leaves), 0
    for i in idx:
        x = leaves[i]
        part = slots[:, k:k + x.numel()].reshape((dp.size,) + x.shape)
        k += x.numel()
        if x.dtype == torch.bool:
            out[i] = torch.all(part != 0, dim=0)
            continue
        acc = part[0]
        for r in range(1, dp.size):
            acc = acc + part[r]
        mean = acc / dp.size
        if x.is_floating_point():
            out[i] = mean.to(x.dtype)
        else:
            out[i] = mean.to(x.dtype if keep_dtype else torch.float32)
    it = iter(out)
    return map_tensors(lambda _: next(it), tree)


class PerRankSync:
    """The per-rank grid's reductions (``train.step_body``'s ``sync``)."""

    def __init__(self, dp: DPGroup, rows: int):
        self.dp, self.rows = dp, rows

    def state_in(self, state):
        return state

    def reduce(self, loss, state, stats, grads):
        flat = torch.cat([loss.reshape(1).to(grads[0].dtype)]
                         + [g.reshape(-1) for g in grads])
        red = mean_over_ranks(flat, self.dp)
        loss, k, out = red[0].to(loss.dtype), 1, []
        for g in grads:
            out.append(red[k:k + g.numel()].view_as(g))
            k += g.numel()
        return (loss,
                reduce_tree(state, self.rows, self.dp, keep_dtype=True),
                reduce_tree(stats, self.rows, self.dp, keep_dtype=False), out)


def make_shardmap_train_step(model, loss_fn, optimizer, dp: DPGroup, *,
                             ema_decay: float = 0.0) -> Callable:
    """``train_step(ts, data, w_reg, lr) -> (ts', loss, stats)``, the
    signature of ``harness.train.make_train_step``: ``data`` is this rank's
    rows (``mesh.shard_batch``), ``ts`` replicated. ``loss`` and the scalar
    stats come back as rank means (``stats['nfe']`` a float), booleans as
    all-ranks AND; ``stats['y_pred']`` is this rank's rows. Gradient
    accumulation is not taken (as in the JAX package: the runners refuse
    ``grad_accumulation`` > 1 here)."""

    def train_step(ts: TrainState, data, w_reg, lr):
        like = next(iter(ts.params.values()))
        rows = int(data[0].shape[0])
        sync = PerRankSync(dp, rows)
        body = step_body(model, loss_fn, optimizer, 1, ema_decay, sync=sync)
        draws = [to_device(d, like) for d in stage_step(
            model, rank_state(ts.state, dp.rank), rows, 1)]
        return body(ts, data, device_w(w_reg, like),
                    device_scalar_like(lr, like), draws)

    return train_step
