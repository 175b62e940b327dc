"""The K-step train call: K train steps in one call, on CUDA one replay of
a captured CUDA graph (the port's counterpart of JAX's one-dispatch
``lax.scan`` over K steps, ``harness/train.py:218-261`` there).

``KStepCall(ts, data_stack, w_regs, lrs)`` first draws the K steps'
randomness on the host, from the layers' generators, in the order K eager
steps would (``models/draws.py``). Then:

- **Captured** (``capturable``: CUDA, and every solve and sweep of the step
  a persistent kernel, so the step issues device work only): the first call
  for a K and batch shape warms one step up on a deep copy of the train
  state (on a side stream; the copy is dropped), settles the layer state's
  shapes (the latent ``mu`` grows from its (1, 1) placeholder, the NFE
  counters move to the device) and captures the K step bodies into one
  ``torch.cuda.CUDAGraph``. The bodies read static K-stacked input buffers
  (the batches, ``w_reg``, the learning rates, the draws) and update the
  parameters, the optimizer's state, the EMA and the layer state in place;
  each body's new layer state is copied back into the static state tensors.
  Every call then copies its inputs into the buffers and replays; the loss
  and the reduction are cloned, since the next replay overwrites them. A
  train state whose tensors are not the captured ones (a restored
  checkpoint, a copy) is captured anew.
- **Eager** (the CPU, the CIFAR conv family, whose adaptive loop accepts
  steps on the host, a declined route, or a data-parallel step, whose
  collectives Gloo cannot run inside a captured graph): the K bodies
  run one after another in the call, on the same staged inputs.

Both run the single step's body (``train.step_body``), so a captured call
is the arithmetic of K eager steps by construction. The route predicate
decides before anything runs; a failed capture is never caught and
retried eagerly.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..models.draws import to_device
from .train import stage_step


def capturable(model, rows: int, device, dp=None) -> bool:
    """Whether a training step of ``model`` on a batch of ``rows`` runs
    every solve and sweep as a persistent kernel on CUDA (each DE layer's
    ``persistent_step``): TD-MLP K4 with K8 or K7, chain K5 with K9, SDE
    K10 with K12. A data-parallel step (``dp``, a ``parallel.DPGroup``) is
    not: its collectives cannot be captured over Gloo."""
    if dp is not None:
        return False
    layers = [m for m in model.modules() if hasattr(m, "persistent_step")]
    return bool(layers) and all(m.persistent_step(rows, device)
                                for m in layers)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def state_tensors(ts) -> list:
    """Every tensor a step reads and writes in place: the parameters, the
    optimizer's state, the EMA and the layer state."""
    out = list(ts.params.values())
    if ts.opt_state is not None:
        for p in ts.params.values():
            out += _leaves(dict(ts.opt_state.state[p]))
    if ts.ema is not None:
        out += list(ts.ema.values())
    return out + _leaves(ts.state)


def _settle(old, new):
    """The layer state ``old`` with each tensor leaf on the device, dtype
    and shape of the step's output ``new``: the same values where only the
    device or dtype moves, zeros where the shape settles (an output-only
    placeholder, as JAX's ``settle_state_shapes``). Other leaves (the
    generators) stay ``old``'s."""
    if isinstance(new, dict):
        return {k: _settle(old.get(k) if isinstance(old, dict) else None, v)
                for k, v in new.items()}
    if isinstance(new, (tuple, list)):
        return type(new)(_settle(o, v) for o, v in zip(old, new))
    if not isinstance(new, torch.Tensor):
        return old
    if isinstance(old, torch.Tensor) and old.shape == new.shape:
        if old.device == new.device and old.dtype == new.dtype:
            return old
        return old.to(device=new.device, dtype=new.dtype)
    return torch.zeros_like(new)


def _copy_into(dst, src):
    """Copy the tensor leaves of ``src`` into ``dst``'s, in place."""
    if isinstance(dst, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            _copy_into(v, src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


def _device_vector(a, like: torch.Tensor) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=like.device, dtype=torch.float32)
    return to_device(torch.from_numpy(np.asarray(a, np.float32)), like)


def _w_at(ws, k):
    return tuple(w[k] for w in ws) if isinstance(ws, tuple) else ws[k]


class KStepCall:
    """``multi_step(ts, data_stack, w_regs, lrs) -> (ts', last_loss, red)``
    (``train.make_multi_train_step``). ``w_regs`` is a (K,) array, or for
    the latent model a tuple ``(w_regs, w_kls)`` of them; ``captured`` says
    whether the last call replayed a graph. ``dp`` (the global grid's
    group) makes every call eager and stages each step's draws by global
    row (``train.stage_step``)."""

    def __init__(self, model, body, reduce_fn, dp=None):
        self.model, self.body, self.reduce_fn = model, body, reduce_fn
        self.dp = dp
        self.captured = False
        self._graphs = {}
        self._routes = {}  # (rows, device) -> capturable, decided once

    def __call__(self, ts, data_stack, w_regs, lrs):
        like = next(iter(ts.params.values()))
        data = tuple(data_stack)
        K, rows = int(data[0].shape[0]), int(data[0].shape[1])
        ws = (tuple(_device_vector(w, like) for w in w_regs)
              if isinstance(w_regs, tuple) else _device_vector(w_regs, like))
        lrs = _device_vector(lrs, like)
        n_micro = self.body.n_micro
        host = [stage_step(self.model, ts.state, rows, n_micro, self.dp)
                for _ in range(K)]
        route = (rows // n_micro, like.device)
        if route not in self._routes:
            self._routes[route] = capturable(self.model, *route, self.dp)
        self.captured = self._routes[route]
        if not self.captured:
            draws = [[to_device(d, like) for d in step] for step in host]
            return self.run(ts, data, ws, lrs, draws)
        g = self._graph(ts, data, ws, lrs, host)
        g.load(data, ws, lrs, host)
        g.graph.replay()
        ts = dataclasses.replace(ts, state=g.state, step=ts.step + K)
        return ts, g.loss.clone(), {k: v.clone() for k, v in g.red.items()}

    def run(self, ts, data, ws, lrs, draws, sink=None):
        """The K bodies in turn; with ``sink`` (the static layer state)
        each body's new layer state is copied into it."""
        red = None
        for k in range(int(data[0].shape[0])):
            data_k = tuple(a[k] for a in data)
            ts, loss, stats = self.body(ts, data_k, _w_at(ws, k), lrs[k],
                                        draws[k])
            if sink is not None:
                _copy_into(sink, ts.state)
                ts = dataclasses.replace(ts, state=sink)
            r = self.reduce_fn(loss, stats, data_k)
            red = r if red is None else {key: red[key] + r[key] for key in red}
        return ts, loss, red

    def _graph(self, ts, data, ws, lrs, host):
        key = (len(lrs),) + tuple((tuple(a.shape), a.dtype) for a in data)
        g = self._graphs.get(key)
        if g is None or g.ptrs != [t.data_ptr() for t in state_tensors(ts)]:
            self._graphs.pop(key, None)
            g = self._graphs[key] = _Graph(self, ts, data, ws, lrs, host)
        return g


class _Graph:
    """One captured K-step call: its static inputs, layer state and
    outputs."""

    def __init__(self, call: KStepCall, ts, data, ws, lrs, host):
        like = next(iter(ts.params.values()))
        dev = like.device
        self.data = tuple(torch.empty_like(a) for a in data)
        self.ws = (tuple(torch.empty_like(w) for w in ws)
                   if isinstance(ws, tuple) else torch.empty_like(ws))
        self.lrs = torch.empty_like(lrs)
        self.draws = [[{path: {k: torch.empty(v.shape, dtype=v.dtype,
                                              device=dev)
                               for k, v in d.items()}
                        for path, d in micro.items()}
                       for micro in step] for step in host]
        self.load(data, ws, lrs, host)
        # warm-up: first-call set-up (handles, function attributes, the
        # autograd engine's streams) on a copy, which is then dropped
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm, _, _ = call.body(copy.deepcopy(ts),
                                   tuple(a[0] for a in self.data),
                                   _w_at(self.ws, 0), self.lrs[0],
                                   self.draws[0])
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.state = _settle(ts.state, warm.state)
        del warm
        ts = dataclasses.replace(ts, state=self.state)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            _, self.loss, self.red = call.run(ts, self.data, self.ws,
                                              self.lrs, self.draws,
                                              sink=self.state)
        # held, so that no other tensor can take their addresses
        self.held = state_tensors(ts)
        self.ptrs = [t.data_ptr() for t in self.held]

    def load(self, data, ws, lrs, host):
        """Copy a call's inputs into the static buffers (the draws through
        pinned memory, without blocking)."""
        for dst, src in zip(self.data, data):
            dst.copy_(src, non_blocking=True)
        if isinstance(ws, tuple):
            for dst, src in zip(self.ws, ws):
                dst.copy_(src, non_blocking=True)
        else:
            self.ws.copy_(ws, non_blocking=True)
        self.lrs.copy_(lrs, non_blocking=True)
        for bufs, step in zip(self.draws, host):
            for b, micro in zip(bufs, step):
                for path, d in micro.items():
                    for k, v in d.items():
                        b[path][k].copy_(v.pin_memory(), non_blocking=True)
