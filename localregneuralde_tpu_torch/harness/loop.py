"""The train-loop options both runners share: ``train.steps_per_call``
(auto-K and its checks), ``train.grad_accumulation`` and
``train.ema_decay`` (their checks), and the block loop that feeds the
K-step train call (counterparts of ``localregneuralde_tpu/harness/
runner.py:254-276, 305-324, 623-750`` and ``latent_runner.py:281-400``)."""
from __future__ import annotations

import collections
import time
from typing import Callable

import numpy as np
import torch

from ..ode.solve import host_to_device


def batch_to_device(batch, device):
    """A host batch on ``device`` (through pinned memory on a card, so the
    copy does not wait for the queued step)."""
    like = torch.empty(0, device=device)
    return tuple(host_to_device(torch.from_numpy(np.asarray(a)), like)
                 for a in batch)


def device_batches(host_iter, device, size: int):
    """Batches (or K-stacks) on ``device``, ``size`` of them copied ahead of
    the one in use (``train.device_prefetch``; 0 or 1 copies on demand).
    The copies go through pinned memory without blocking, so they overlap
    the running step."""
    queue = collections.deque()
    for batch in host_iter:
        queue.append(batch_to_device(batch, device))
        if len(queue) >= max(1, size):
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def resolve_steps_per_call(spc, print_frequency, evaluate_every,
                           capturable=False) -> int:
    """``train.steps_per_call``: a positive K as given, 0 for auto. Auto is
    the JAX package's rule with the card's captured K-step call in the
    TPU's place: the largest K <= 8 that divides both the print and the
    eval cadence (so logging stays step-exact) where the train step is
    captured (``graph.capturable``: CUDA and a persistent-kernel route), and
    1 elsewhere (eager K-step calls only add a copy of the batches)."""
    spc = int(spc)
    if spc != 0:
        return max(1, spc)
    if not capturable:
        return 1
    for k in range(8, 1, -1):
        if print_frequency % k == 0 and evaluate_every % k == 0:
            return k
    return 1


def check_train_options(cfg):
    """``(grad_accumulation, ema_decay)`` of ``cfg``, with the JAX
    runners' checks (``runner.py:305-324``)."""
    ga = max(1, int(cfg.train.grad_accumulation))
    if ga > 1 and cfg.dataset.train_batchsize % ga:
        raise ValueError(
            f"train.grad_accumulation={ga} must divide "
            f"dataset.train_batchsize ({cfg.dataset.train_batchsize})"
        )
    ed = float(cfg.train.ema_decay)
    if not 0.0 <= ed < 1.0:
        raise ValueError(f"train.ema_decay must be in [0, 1), got {ed}")
    return ga, ed


def check_steps_per_call(cfg, spc: int) -> None:
    """K must divide both cadences, so that logging, evaluation and
    checkpoints fall on the steps of the single-step loop."""
    t = cfg.train
    if spc > 1 and (t.print_frequency % spc or t.evaluate_every % spc):
        raise ValueError(
            f"train.steps_per_call={spc} must divide both print_frequency "
            f"({t.print_frequency}) and evaluate_every ({t.evaluate_every})"
        )


def host_stacks(data_iter, initial_step: int, total_steps: int, spc: int):
    """K-stacks of host batches for the steps ``initial_step ..
    total_steps``: realigned to the K grid first (a resume can land off
    it), and a shorter block at the tail."""
    s = initial_step - 1
    while s < total_steps:
        bk = min(spc - (s % spc), total_steps - s)
        batches = [next(data_iter) for _ in range(bk)]
        s += bk
        yield tuple(np.stack([b[i] for b in batches])
                    for i in range(len(batches[0])))


def run_block_loop(multi_step, ts, stacks, *, initial_step: int,
                   total_steps: int, print_frequency: int,
                   evaluate_every: int, w_of: Callable, lr_of: Callable,
                   on_window: Callable, on_eval: Callable,
                   reduce_window: Callable = None):
    """The K-steps-per-call training loop (JAX ``_run_block_loop``): each
    K-stack of device batches ``stacks`` yields goes to ``multi_step`` with
    its steps' ``w_of(steps)`` and ``lr_of(steps)``; the reduction (a
    ``"row"`` of window stats and an ``"n_fail"`` count) is summed on the
    device and read once a print window. ``on_window(step, sums, n,
    all_ok, wall, data_time, rows, ts, batch, w)`` logs a window (``wall``
    taken before the call, so what it runs counts in no window; ``batch``
    and ``w`` the window's last step's, for the phase probes), ``on_eval(step,
    w, ts)`` evaluates and checkpoints, at the single-step loop's steps.
    ``reduce_window`` (data parallelism: the rank mean) maps the window's
    summed row before it is read. Returns the final train state."""
    sums = fails = None
    window_n, data_time = 0, 0.0
    t_window = time.perf_counter()
    step = initial_step - 1
    while step < total_steps:
        t0 = time.perf_counter()
        stack = next(stacks)
        data_time += time.perf_counter() - t0
        bk = int(stack[0].shape[0])
        steps = range(step + 1, step + bk + 1)
        w = w_of(steps)
        ts, _, red = multi_step(ts, stack, w, lr_of(steps))
        sums = red["row"] if sums is None else sums + red["row"]
        fails = red["n_fail"] if fails is None else fails + red["n_fail"]
        window_n += bk
        step += bk
        last = (tuple(float(x[-1]) for x in w) if isinstance(w, tuple)
                else float(w[-1]))
        if step % print_frequency == 0:
            if reduce_window is not None:
                sums = reduce_window(sums)
            host = torch.cat([sums, fails.reshape(1)]).tolist()
            on_window(step, host[:-1], window_n, host[-1] == 0.0,
                      time.perf_counter() - t_window, data_time,
                      int(stack[0].shape[1]), ts,
                      tuple(a[-1] for a in stack), last)
            sums = fails = None
            window_n, data_time = 0, 0.0
            t_window = time.perf_counter()
        if step % evaluate_every == 0 or step == total_steps:
            on_eval(step, last, ts)
    return ts
