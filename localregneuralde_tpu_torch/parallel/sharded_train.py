"""Global-grid data parallelism (``train.data_parallel='gspmd'``).

Counterpart of ``localregneuralde_tpu/parallel/sharded_train.py``'s data
parallelism: the batch is spread over the ranks, the parameters are
replicated, and the solve keeps the reference's semantics of one adaptive
grid for the whole batch. Every norm of the solve (the error norm of each
attempt, the dt probe's) and of the regulariser is one scalar over all the
ranks' rows (``ops/residuals.internal_norm`` with the group), added in rank
order, so every rank takes the same accept decisions from the same bytes;
after each solve the ranks' accept and reject counts are held equal
(``NeuralODE``). The group reaches the layers through their state
(``nn.basic.GROUP``), inserted by the step into each DE layer's and each
BatchNorm's outside them (``group_paths``); a BatchNorm then takes its
batch moments over every rank's rows (the CIFAR model's outer
``BatchNorm(8)``, and through the layer the conv dynamics' on the eager
route). The persistent solves take no part in a collective. The TD-MLP
runs kernel 2 on every attempt and kernel 3 on every accepted step. The
chain family (the latent ODE) and the SDE family run kernels 5 and 10 as
GSPMD runs a replicated custom call: on the whole batch, gathered from the
ranks, on every rank, which keeps its rows (``mesh.replicated``; the SDE's
tree is the whole batch's). A dense sweep takes no accept decision, so
each rank sweeps its rows of the knots on kernel 9 or 12; kernel 9's
two-level sweep replays the whole batch's windows, so there every rank
sweeps the whole batch (``ode/stored_adjoint.py``). The conv family's
kernels 13 and 14 compute BatchNorm statistics inside every step, so its
whole solve runs so, as GSPMD runs the Pallas step and its VJP: the loop
of kernel 13 on the whole batch on every rank, then the sweep of kernel 14
with every rank's cotangents, and the regulariser's step. The eager routes
(``use_pallas='off'``) take the group's norms and BatchNorm moments in
their loops, the SDE's tree drawn by global row.

The gradients are the single-device step's on the global batch. The
cross-entropy is a mean over this rank's rows, so its gradient's rank mean
is the global mean's gradient; the regulariser is one function of the
global norm, whose backward gives each rank n times its rows' share
(``residuals._RankSum``), so the same rank mean sums the shares. One
all-reduce of the rank mean (loss and gradients flattened into one buffer,
added in rank order) thus gives every term its single-device gradient. A
step's draws (t1, the reservoir's uniforms, the tree's seed, the
reparameterisation's ε, the SDE regulariser's normals) are staged for the
whole batch from the carried, replicated generators, the same on every
rank, and each rank takes its rows of those with rows
(``harness.train.stage_step``).

With ``grad_accumulation`` N each rank holds its slice of each of the N
microbatches (``mesh.shard_batch(..., n_micro=N)``), so microbatch i over
the ranks is the global batch's microbatch i, solved on one grid.

The ODE solver modes other than Tsit5 under the stored or direct adjoint
raise ``NotImplementedError`` (ROADMAP Queue 1 item 14e); the per-rank
grid runs them all. Tensor parallelism is not ported (item 14d).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..harness.graph import KStepCall
from ..harness.optim import device_scalar_like
from ..harness.train import (
    TrainState, default_reduce, device_w, stage_step, step_body,
)
from ..models.draws import layers_with, to_device, with_key
from ..nn.basic import GROUP
from .mesh import DPGroup, mean_over_ranks


def check_global_grid(model, state=None) -> list:
    """The state paths of ``model``'s DE layers (those with
    ``persistent_step``: ``NeuralODE``, ``NeuralDSDE``) that take the
    global grid; each layer's ``check_global_grid`` raises
    ``NotImplementedError`` (with its ROADMAP item) for a family or mode
    that does not. ``state`` defaults to the model's initial state."""
    if state is None:
        state = model.init_state()
    paths = []
    for path, layer, _ in layers_with(model, state, "persistent_step"):
        layer.check_global_grid()
        paths.append(path)
    if not paths:
        raise NotImplementedError(
            "data_parallel='gspmd' needs a model with a NeuralODE or "
            "NeuralDSDE layer")
    return paths


def group_paths(model, state=None) -> list:
    """The state paths the global grid's step gives the group: the DE
    layers' (``check_global_grid``, which raises where the grid is not
    ported) and those of the BatchNorms outside them (``group_moments``;
    a DE layer hands it on to its dynamics' itself)."""
    if state is None:
        state = model.init_state()
    paths = check_global_grid(model, state)
    return paths + [path for path, layer, _ in layers_with(
        model, state, ("persistent_step", "group_moments"))
        if not hasattr(layer, "persistent_step")]


class GlobalGridSync:
    """The global grid's part of the step (``train.step_body``'s ``sync``):
    the group into the input state at ``paths`` (``group_paths``), then the
    rank mean of the loss, the gradients and the float scalar stats."""

    def __init__(self, dp: DPGroup, paths):
        self.dp, self.paths = dp, paths

    def state_in(self, state):
        for path in self.paths:
            state = with_key(state, path, GROUP, self.dp)
        return state

    def reduce(self, loss, state, stats, grads):
        scal = {k: v for k, v in stats.items()
                if isinstance(v, torch.Tensor) and v.ndim == 0
                and v.is_floating_point()}
        flat = torch.cat([loss.reshape(1).to(grads[0].dtype)]
                         + [v.reshape(1).to(grads[0].dtype)
                            for v in scal.values()]
                         + [g.reshape(-1) for g in grads])
        red = mean_over_ranks(flat, self.dp)
        loss = red[0].to(loss.dtype)
        stats = dict(stats)
        for i, k in enumerate(scal, start=1):
            stats[k] = red[i].to(stats[k].dtype)
        k, out = 1 + len(scal), []
        for g in grads:
            out.append(red[k:k + g.numel()].view_as(g))
            k += g.numel()
        return loss, state, stats, out


def global_grid_body(model, loss_fn, optimizer, dp: DPGroup, *,
                     grad_accumulation: int = 1, ema_decay: float = 0.0):
    """The single-device step body (``train.step_body``) on the global
    grid of ``dp``."""
    sync = GlobalGridSync(dp, group_paths(model))
    return step_body(model, loss_fn, optimizer, grad_accumulation, ema_decay,
                     sync=sync)


def make_sharded_train_step(model, loss_fn, optimizer, dp: DPGroup, *,
                            ema_decay: float = 0.0,
                            grad_accumulation: int = 1) -> Callable:
    """``train_step(ts, data, w_reg, lr) -> (ts', loss, stats)``, the
    signature and semantics of ``harness.train.make_train_step`` on the
    global batch: ``data`` is this rank's rows (``mesh.shard_batch``, with
    ``n_micro=grad_accumulation``), ``ts`` replicated. ``loss`` and the
    float scalar stats are the global batch's; ``stats['y_pred']`` is this
    rank's rows."""
    body = global_grid_body(model, loss_fn, optimizer, dp,
                            grad_accumulation=grad_accumulation,
                            ema_decay=ema_decay)

    def train_step(ts: TrainState, data, w_reg, lr):
        like = next(iter(ts.params.values()))
        draws = [to_device(d, like) for d in stage_step(
            model, ts.state, data[0].shape[0], body.n_micro, dp)]
        return body(ts, data, device_w(w_reg, like),
                    device_scalar_like(lr, like), draws)

    return train_step


def make_sharded_eval_step(model, loss_fn, dp: DPGroup) -> Callable:
    """``eval_step(ts, (x, y), w_reg) -> (loss, stats)`` on the global grid:
    ``(x, y)`` this rank's rows of an eval batch, one solve of the whole
    batch over the ranks."""
    sync = GlobalGridSync(dp, group_paths(model))

    @torch.no_grad()
    def eval_step(ts: TrainState, data, w_reg):
        loss, _, stats = loss_fn(model, ts.params, sync.state_in(ts.state),
                                 data, w_reg, training=False)
        return loss, stats

    return eval_step


def make_sharded_multi_train_step(model, loss_fn, optimizer, dp: DPGroup, *,
                                  reduce_fn: Optional[Callable] = None,
                                  ema_decay: float = 0.0,
                                  grad_accumulation: int = 1):
    """The K-step call on the global grid (JAX's scan of the sharded body,
    ``sharded_train.py:135-186`` there): ``multi_step(ts, data_stack,
    w_regs, lrs) -> (ts', last_loss, red)`` with every ``data_stack`` leaf
    ``(K, rows of this rank, ...)``; the K bodies of
    ``make_sharded_train_step``'s step run eagerly in the call (a
    collective cannot be captured over Gloo; ``captured`` stays False)."""
    body = global_grid_body(model, loss_fn, optimizer, dp,
                            grad_accumulation=grad_accumulation,
                            ema_decay=ema_decay)
    return KStepCall(model, body, reduce_fn or default_reduce, dp=dp)
