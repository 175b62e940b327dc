"""Train state, the train step, the K-step train call, warmup, the eval
step and the per-window phase probes (reference
``experiments/src/utils.jl:104-153``); counterpart of
``localregneuralde_tpu/harness/train.py``, with microbatched gradients
(``grad_accumulation``) and the params-EMA (``ema_decay``).

PyTorch runs eagerly, so a step is forward, ``torch.autograd.grad`` and the
optimizer update in turn; the parameters, the optimizer's state and the EMA
are updated in place. Every step runs one body (``step_body``) on device
inputs: the batch, ``w_reg`` and the learning rate as 0-d tensors, and the
step's random draws, staged from the layers' CPU generators before the step
(``models/draws.py``). ``make_train_step`` runs it once a call;
``make_multi_train_step`` runs it K times a call, on CUDA as one replay of
a captured CUDA graph where the route allows it (``harness/graph.py``).
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models.draws import (
    cloned_generators, rows_of, stage_draws, to_device, with_draws,
)
from .optim import device_scalar_like


@dataclass
class TrainState:
    """``params`` maps parameter names (``neural_ode.model.layer_0.w``, ...)
    to leaf tensors; ``state`` is the model's nested layer state;
    ``opt_state`` the optimizer bound to ``params`` (None without an
    optimizer); ``step`` counts optimizer steps; ``ema`` is the params-EMA
    (None: disabled), keyed like ``params``."""

    params: Dict[str, torch.Tensor]
    state: Any
    opt_state: Any = None
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(model, optimizer=None) -> TrainState:
    """The model's parameters as trainable leaves, its initial layer state
    and, given an ``OptimizerSpec``, the optimizer bound to them."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.named_parameters()}
    opt_state = None if optimizer is None else optimizer.init(params)
    return TrainState(params=params, state=model.init_state(),
                      opt_state=opt_state)


def init_ema(ts: TrainState) -> TrainState:
    """Seed the params-EMA at the current parameters (once before the first
    EMA step; it also re-seeds after resuming a checkpoint without one)."""
    return dataclasses.replace(
        ts, ema={k: v.detach().clone() for k, v in ts.params.items()})


def swap_ema_params(ts: TrainState) -> TrainState:
    """A view of the train state with the EMA weights as ``params``: what
    evaluation and the best checkpoint see. Without an EMA, ``ts``."""
    if ts.ema is None:
        return ts
    return dataclasses.replace(ts, params=ts.ema)


def _detached(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detached(v) for v in tree)
    return tree


def _merge_micro_stats(stats_list):
    """One step's stats from its microbatches' (JAX ``train.py:71-87``):
    per-row arrays (``y_pred``) concatenate, integer scalars (NFE) sum,
    boolean scalars (``solver_success``) AND, float scalars average."""
    first = stats_list[0]
    if isinstance(first, dict):
        return {k: _merge_micro_stats([s[k] for s in stats_list])
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_merge_micro_stats([s[i] for s in stats_list])
                           for i in range(len(first)))
    if not isinstance(first, torch.Tensor):
        return first
    s = torch.stack(stats_list)
    if s.ndim >= 2:
        return s.reshape((-1,) + tuple(s.shape[2:]))
    if s.dtype == torch.bool:
        return torch.all(s)
    if not s.is_floating_point():
        return torch.sum(s, dtype=s.dtype)
    return torch.mean(s)


def _zeros_for_none(grads, params):
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def _microbatched_grads(model, loss_fn, n_micro, ts, data, w, draws,
                        state_in=None):
    """Gradient accumulation over ``n_micro`` sequential microbatches (JAX
    ``train.py:90-127``): the layer state threads through them as
    ``n_micro`` smaller steps would, each microbatch solves on its own
    adaptive grid, and the gradient is the mean of theirs. ``state_in``
    prepares each microbatch's input state (the global grid's group).
    Returns ``(mean loss, state, merged stats, grads)``."""
    m = data[0].shape[0] // n_micro
    params = list(ts.params.values())
    state, gsum, losses, stats = ts.state, None, [], []
    for i in range(n_micro):
        md = tuple(a[i * m:(i + 1) * m] for a in data)
        st_in = state if state_in is None else state_in(state)
        loss, st_, st = loss_fn(model, ts.params, with_draws(st_in, draws[i]),
                                md, w, training=True)
        g = _zeros_for_none(
            torch.autograd.grad(loss, params, allow_unused=True), params)
        gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
        state = _detached(st_)
        losses.append(loss.detach())
        stats.append(_detached(st))
    inv = 1.0 / float(n_micro)
    grads = [g * inv for g in gsum]
    return (torch.mean(torch.stack(losses)), state,
            _merge_micro_stats(stats), grads)


def _ema_update(ema, params, decay: float) -> None:
    """ema ← d·ema + (1 − d)·p in place, with d and 1 − d in float32 as
    JAX's ``train.py:172-177`` rounds them."""
    d = np.float32(decay)
    om = float(np.float32(1.0) - d)
    with torch.no_grad():
        for k, p in params.items():
            ema[k].mul_(float(d)).add_(p * om)


def device_w(w, like: torch.Tensor):
    """``w_reg`` (or the latent's ``(w_reg, w_kl)``) as 0-d float32
    tensors on ``like``'s device."""
    if isinstance(w, (tuple, list)):
        return tuple(device_scalar_like(v, like) for v in w)
    return device_scalar_like(w, like)


def stage_step(model, state, rows: int, n_micro: int, dp=None):
    """One step's draws on the host, a ``Staged`` per microbatch of
    ``rows // n_micro`` rows, in the order the step uses them. With a
    ``DPGroup`` (``dp``, the global grid) ``rows`` is this rank's: each
    microbatch's draws are staged for the whole microbatch over the ranks
    and cut to this rank's rows of it (``draws.rows_of``)."""
    b = rows // n_micro
    if dp is None:
        return [stage_draws(model, state, b) for _ in range(n_micro)]
    piece = slice(dp.rank * b, (dp.rank + 1) * b)
    return [rows_of(model, state, stage_draws(model, state, b * dp.size),
                    piece) for _ in range(n_micro)]


def step_grads(model, loss_fn, n_micro: int, ts: TrainState, data, w,
               draws, state_in=None):
    """A step's forward and backward without the update: ``(loss, state,
    stats, grads)``, the gradients a list in ``ts.params``' order (zeros
    where a parameter gets none). ``state_in`` prepares the loss's input
    state (the global grid's group)."""
    params = list(ts.params.values())
    if n_micro > 1:
        return _microbatched_grads(model, loss_fn, n_micro, ts, data, w,
                                   draws, state_in)
    st_in = ts.state if state_in is None else state_in(ts.state)
    loss, st_, stats = loss_fn(model, ts.params, with_draws(st_in, draws[0]),
                               data, w, training=True)
    grads = _zeros_for_none(
        torch.autograd.grad(loss, params, allow_unused=True), params)
    return loss.detach(), _detached(st_), _detached(stats), grads


def step_body(model, loss_fn, optimizer, grad_accumulation: int = 1,
              ema_decay: float = 0.0, sync=None) -> Callable:
    """``body(ts, data, w, lr, draws) -> (ts', loss, stats)``: one forward,
    backward and optimizer update on device inputs (``w`` and ``lr`` 0-d
    tensors, ``draws`` a device ``Staged`` per microbatch). The shared
    body of the single-step and K-step calls (JAX ``_fused_step_body``).
    A data-parallel step gives ``sync`` (``parallel/``): its ``state_in``
    prepares the loss's input state, its ``reduce(loss, state, stats,
    grads)`` reduces them over the ranks before the update, and its
    ``norm_sq(grads, names)``, where it has one, is the whole gradient's
    squared norm for the optimizer's clipping (tensor parallelism's
    shards)."""
    n_micro = int(grad_accumulation)
    ema_decay = float(ema_decay)

    def body(ts: TrainState, data, w, lr, draws):
        params = list(ts.params.values())
        loss, state, stats, grads = step_grads(
            model, loss_fn, n_micro, ts, data, w, draws,
            None if sync is None else sync.state_in)
        norm_sq = None
        if sync is not None:
            loss, state, stats, grads = sync.reduce(loss, state, stats, grads)
            if hasattr(sync, "norm_sq"):
                norm_sq = functools.partial(sync.norm_sq,
                                            names=list(ts.params))
        optimizer.apply(ts.opt_state, params, grads, lr, norm_sq=norm_sq)
        if ema_decay > 0.0:
            _ema_update(ts.ema, ts.params, ema_decay)
        return (dataclasses.replace(ts, state=state, step=ts.step + 1),
                loss, stats)

    body.n_micro = n_micro
    return body


def make_train_step(model, loss_fn, optimizer, grad_accumulation: int = 1,
                    ema_decay: float = 0.0) -> Callable:
    """``train_step(ts, data, w_reg, lr) -> (ts', loss, stats)``: stage the
    step's draws, then one body (``step_body``). ``grad_accumulation=N``
    splits the batch into N sequential microbatches and takes one update on
    their mean gradient; ``ema_decay > 0`` updates ``ts.ema`` (seed it with
    ``init_ema``) after the update. ``w_reg`` and ``lr`` are numbers or 0-d
    tensors."""
    body = step_body(model, loss_fn, optimizer, grad_accumulation, ema_decay)

    def train_step(ts: TrainState, data, w_reg, lr):
        like = next(iter(ts.params.values()))
        draws = [to_device(d, like) for d in stage_step(
            model, ts.state, data[0].shape[0], body.n_micro)]
        return body(ts, data, device_w(w_reg, like),
                    device_scalar_like(lr, like), draws)

    return train_step


def default_reduce(loss, stats, data):
    return {"loss": loss}


def make_multi_train_step(model, loss_fn, optimizer,
                          reduce_fn: Optional[Callable] = None,
                          grad_accumulation: int = 1,
                          ema_decay: float = 0.0):
    """The K-step train call (JAX ``train.py:218-261``):
    ``multi_step(ts, data_stack, w_regs, lrs) -> (ts', last_loss, red)``.
    Every leaf of ``data_stack`` has a leading K axis, ``w_regs`` is a (K,)
    array (the latent model's a pair of them) and ``lrs`` (K,); ``red`` is
    ``reduce_fn(loss, stats, data)`` (default ``{"loss": loss}``) summed
    over the K steps on the device.

    The K steps are K bodies of ``make_train_step``'s step: on CUDA, where
    every solve and sweep of the step is a persistent kernel
    (``graph.capturable``), one replay of a CUDA graph that captured the K
    bodies; otherwise (the CPU, the CIFAR conv family's host-driven
    adaptive loop, a declined route) K eager bodies in the call.
    ``multi_step.captured`` says which the last call ran."""
    from .graph import KStepCall

    return KStepCall(model, step_body(model, loss_fn, optimizer,
                                      grad_accumulation, ema_decay),
                     reduce_fn or default_reduce)


def make_phase_probes(model, loss_fn, optimizer=None) -> Callable:
    """Per-phase wall-clock metrics (reference ``utils.jl:107-121`` logs
    forward, backward and optimizer separately; JAX ``train.py:275-322``).
    The training step is one call (one CUDA-graph replay under the K-step
    call), so the phases are probed on the eager step body, once per print
    window: ``measure(ts, data, w_reg) -> (t_fwd, t_fwdbwd)`` times a
    forward alone and a forward with its backward (``torch.autograd.grad``,
    no update), each run once to warm up and once timed, each closed by a
    fence on the device (``utils.profiling.fence``)::

        fwd_time = t_fwd
        bwd_time = t_fwdbwd - t_fwd
        opt_time = step time - t_fwdbwd     (by the caller)

    The probe leaves the run as it was: it works on a copy of the layer
    state (the CIFAR BatchNorm's running statistics are written by a
    training forward) whose generators are copies, so its draws take
    nothing from the layers' generators, and it updates no parameter, no
    optimizer state and no EMA. ``optimizer`` is unused (the reference's
    signature)."""
    from ..utils.profiling import fence

    def run(ts: TrainState, data, w, backward: bool):
        like = next(iter(ts.params.values()))
        state = cloned_generators(ts.state)
        state = with_draws(state, to_device(
            stage_draws(model, state, data[0].shape[0]), like))
        w = device_w(w, like)
        if not backward:
            with torch.no_grad():
                return loss_fn(model, ts.params, state, data, w,
                               training=True)[0]
        loss = loss_fn(model, ts.params, state, data, w, training=True)[0]
        params = list(ts.params.values())
        return [g for g in torch.autograd.grad(loss, params, allow_unused=True)
                if g is not None]

    def timed(ts, data, w, backward: bool) -> float:
        fence(run(ts, data, w, backward))  # warm-up
        t0 = time.perf_counter()
        fence(run(ts, data, w, backward))
        return time.perf_counter() - t0

    def measure(ts: TrainState, data, w_reg):
        """``(t_fwd, t_fwdbwd)`` in seconds."""
        return timed(ts, data, w_reg, False), timed(ts, data, w_reg, True)

    return measure


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
