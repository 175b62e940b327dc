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
grid runs them all.

**Tensor parallelism** (``train.tensor_parallel`` = tp > 1 on a grid of
world / tp data ranks by tp model ranks, ``mesh.make_dp_group``): the
parameters whose names match JAX's rules (``sharding_rules_for_mlp_tp``,
the first dynamics layer column-parallel, the others row-parallel, each
only where its dimension divides, on JAX's layout, which is the port's)
are cut to this model rank's contiguous slice, with their Adam/Adamax
moments and their EMA (``shard_train_state``). The grid carries these
specs (``train_state_shardings``, ``DPGroup.specs``), and every consumer
reads them there. The rules take the TD-MLP's
first layer (``mnist_ode/mlp.yaml``) and the latent chain's eight Dense
layers (``physionet.yaml``); the CIFAR and SDE models keep every leaf
whole. The kernel routes (kernels 2 and 3 of the TD-MLP, 5 and 9 of the
chain) take whole weights, gathered over the model group once a call
(``NeuralODE.gathered_shards``), as GSPMD gathers a Pallas call's
operands: such a step is bitwise the same data degree's global-grid step.
The plain routes compute on the shards (``nn.basic.Dense._model_parallel``).
The loss, the stats and every gradient, whole or shard, are averaged over
the data group only; ``gradient_clip_norm`` takes the whole gradient's norm
(``GlobalGridSync.norm_sq``). A checkpoint keeps whole arrays
(``whole_train_state``), so a tensor-parallel run and a single-device run
resume from each other's.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional

import torch

from ..harness.graph import KStepCall
from ..harness.optim import device_scalar_like
from ..harness.train import (
    TrainState, default_reduce, device_w, stage_step, step_body,
)
from ..models.draws import layers_with, to_device, with_key
from ..nn.basic import GROUP
from .mesh import (
    DPGroup, mean_over_ranks, model_cat, model_shard, model_sum,
)

MODEL_AXIS = "model"


def sharding_rules_for_mlp_tp() -> Dict:
    """JAX's tensor-parallel rules (``sharded_train.py:28-35`` there): the
    first dynamics layer column-parallel, the following layers row-parallel
    on their input dimension. Keys are regexes over '/'-joined parameter
    paths, values the mesh axis of each dimension (None: whole)."""
    return {
        r".*neural_ode/model/layer_0/w$": (None, MODEL_AXIS),
        r".*neural_ode/model/layer_0/b$": (MODEL_AXIS,),
        r".*neural_ode/model/layer_\d+/w$": (MODEL_AXIS, None),
    }


def make_param_shardings(params, tp: int,
                         rules: Optional[Dict] = None) -> Dict:
    """The sharded dimension of each parameter (``{dotted name: dim or
    None}``) on a model axis of ``tp`` ranks, as JAX's
    ``make_param_shardings``: the rules in order, over the name with '/'
    for '.'; a matching rule applies only where every dimension it shards
    divides by tp (on JAX's layout, which is the port's), else the next
    matching rule is tried; no rule, a whole (replicated) leaf."""
    rules = rules or {}
    out = {}
    for name, leaf in params.items():
        shape = tuple(leaf.shape)
        path, out[name] = name.replace(".", "/"), None
        for pattern, spec in rules.items():
            if not re.match(pattern, path):
                continue
            dims = [d for d, axis in enumerate(spec) if axis == MODEL_AXIS]
            if len(shape) >= len(spec) and all(
                    shape[d] % tp == 0 for d in dims):
                out[name] = dims[0] if dims else None
                break
    return out


def train_state_shardings(ts: TrainState, dp: DPGroup) -> DPGroup:
    """The grid ``dp`` carrying the train state's specs (``DPGroup.specs``;
    JAX's ``train_state_shardings`` with its runner's rules,
    ``sharding_rules_for_mlp_tp``): the whole parameters' specs by
    ``make_param_shardings``, which each optimizer moment and the EMA take
    from its parameter (JAX matches them by path and shape), the layer
    state and the step whole. The one decision of what is sharded: the
    state's cut (``shard_train_state``), the step's clip norm, the layers'
    products and the checkpoint read it from the grid. ``dp`` itself
    without tensor parallelism."""
    if dp.model_size == 1:
        return dp
    return dataclasses.replace(dp, specs=make_param_shardings(
        ts.params, dp.model_size, sharding_rules_for_mlp_tp()))


@torch.no_grad()
def shard_train_state(ts: TrainState, dp: DPGroup) -> TrainState:
    """Cut every parameter that ``dp.specs`` shards
    (``train_state_shardings``), its optimizer moments and its EMA to this
    model rank's contiguous slice, in place: the parameter tensors stay the
    leaves the optimizer is bound to. Returns ``ts``."""
    opt = ts.opt_state
    for name, p in ts.params.items():
        dim = dp.specs.get(name)
        if dim is None:
            continue
        if opt is not None:
            st = opt.state[p]
            for slot in opt.slots:
                st[slot] = model_shard(st[slot], dp, dim)
        p.data = model_shard(p.data, dp, dim)
        if ts.ema is not None:
            ts.ema[name] = model_shard(ts.ema[name], dp, dim)
    return ts


def _whole(t, dp, dim):
    return t.detach() if dim is None else model_cat(t.detach(), dp, dim)


def whole_train_state(ts: TrainState, dp: DPGroup,
                      optimizer) -> TrainState:
    """A copy of a ``ts`` sharded by ``dp.specs`` with whole arrays,
    gathered over the model group (what ``jax.device_get`` of a sharded
    state gives): the parameters, an optimizer of ``optimizer`` (the
    ``OptimizerSpec``) with the whole moments, and the EMA; the layer state
    is shared. For the checkpoint, which every rank makes alike."""
    specs = dp.specs
    params = {k: _whole(p, dp, specs.get(k)) for k, p in ts.params.items()}
    opt = None
    if ts.opt_state is not None:
        sd = ts.opt_state.state_dict()
        for i, k in enumerate(ts.params):
            for slot in ts.opt_state.slots:
                if specs.get(k) is not None:
                    sd["state"][i][slot] = _whole(sd["state"][i][slot], dp,
                                                  specs[k])
        opt = optimizer.init(params)
        opt.load_state_dict(sd)
    ema = None if ts.ema is None else {
        k: _whole(v, dp, specs.get(k)) for k, v in ts.ema.items()}
    return dataclasses.replace(ts, params=params, opt_state=opt, ema=ema)


def shard_host_state(host: dict, dp: DPGroup) -> dict:
    """A checkpoint's host tree (``latent_runner.train_state_to_host``:
    whole arrays) cut like ``shard_train_state`` cuts a train state, for
    ``latent_runner.restore_train_state``: a tensor-parallel run resumes
    from any checkpoint, a single device's included."""
    import numpy as np

    specs = dp.specs

    def cut(a, dim):
        if dim is None:
            return a
        n = a.shape[dim] // dp.model_size
        return np.ascontiguousarray(
            np.take(a, range(dp.model_rank * n, (dp.model_rank + 1) * n),
                    axis=dim))

    names = list(host["params"])
    out = dict(host)
    out["params"] = {k: cut(v, specs.get(k))
                     for k, v in host["params"].items()}
    if host.get("ema") is not None:
        out["ema"] = {k: cut(v, specs.get(k)) for k, v in host["ema"].items()}
    opt = dict(host["opt"])
    opt["state"] = {i: {s: (cut(v, specs.get(names[i]))
                            if getattr(v, "ndim", 0) > 0 else v)
                        for s, v in st.items()}
                    for i, st in host["opt"]["state"].items()}
    out["opt"] = opt
    return out


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
    data ranks' mean of the loss, the gradients and the float scalar
    stats."""

    def __init__(self, dp: DPGroup, paths):
        self.dp, self.paths = dp, paths

    def norm_sq(self, grads, names) -> torch.Tensor:
        """The whole gradient's squared norm (``gradient_clip_norm``) of
        the parameters ``names``' ``grads``: under tensor parallelism the
        shards' (``dp.specs``) squared sums added over the model group in
        rank order (one collective), each whole leaf counted once, the
        leaves added in order."""
        sq = [torch.sum(g * g) for g in grads]
        idx = [i for i, k in enumerate(names)
               if self.dp.specs.get(k) is not None]
        if idx:
            summed = model_sum(torch.stack([sq[i] for i in idx]), self.dp)
            for j, i in enumerate(idx):
                sq[i] = summed[j]
        return sum(sq)

    def state_in(self, state):
        for path in self.paths:
            state = with_key(state, path, GROUP, self.dp.under(path))
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
    return step_body(model, loss_fn, optimizer, grad_accumulation, ema_decay,
                     sync=GlobalGridSync(dp, group_paths(model)))


def make_sharded_train_step(model, loss_fn, optimizer, dp: DPGroup, *,
                            ema_decay: float = 0.0,
                            grad_accumulation: int = 1) -> Callable:
    """``train_step(ts, data, w_reg, lr) -> (ts', loss, stats)``, the
    signature and semantics of ``harness.train.make_train_step`` on the
    global batch: ``data`` is this rank's rows (``mesh.shard_batch``, with
    ``n_micro=grad_accumulation``), ``ts`` replicated. ``loss`` and the
    float scalar stats are the global batch's; ``stats['y_pred']`` is this
    rank's rows. Under tensor parallelism ``ts`` is sharded by ``dp.specs``
    (``shard_train_state``)."""
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
    batch over the ranks (on a sharded ``ts`` under tensor
    parallelism)."""
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
