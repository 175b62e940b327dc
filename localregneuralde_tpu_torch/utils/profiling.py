"""Phase timers and profiler integration.

Counterpart of ``localregneuralde_tpu/utils/profiling.py``. The reference
times the phases of its training step by hand on the wall clock (SURVEY.md
§5); here:

- ``PhaseTimer``: named wall-clock segments, each closed by a fence on the
  device of its ``sync`` tensors (a CUDA event recorded on the current
  stream and waited for), so that asynchronous launches do not hide work;
  a CPU tensor needs no fence;
- ``trace``: a context manager around ``torch.profiler`` that writes a
  Chrome trace of the enclosed block (CPU, and CUDA where there is a card)
  under ``log_dir``, and does nothing when ``log_dir`` is None.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch
from torch.utils._pytree import tree_leaves


def fence(sync) -> None:
    """Wait for the work queued so far on the current stream of each CUDA
    device that holds a tensor of ``sync`` (a tensor or a tree of them);
    nothing for CPU tensors, and never a device-wide synchronise."""
    devices = {t.device for t in tree_leaves(sync)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for device in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()


class PhaseTimer:
    """Accumulate wall-clock per named phase.

    Usage::

        timer = PhaseTimer()
        with timer.phase("forward", sync=loss):
            loss = fwd(...)
        timer.averages()  # {'forward': seconds}
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                fence(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def averages(self) -> Dict[str, float]:
        return {
            k: self.totals[k] / max(self.counts[k], 1) for k in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block with ``torch.profiler`` when ``log_dir``
    is set, writing ``trace_<pid>_<ms>.json`` there (Chrome's trace format;
    open it in Perfetto or TensorBoard); no-op when None."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
