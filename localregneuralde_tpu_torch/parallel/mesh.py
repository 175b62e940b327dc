"""The data-parallel group: one rank a process over ``torch.distributed``.

Counterpart of ``localregneuralde_tpu/parallel/mesh.py``: a process group of
world size n stands for JAX's ``data`` mesh axis, one rank a process (and a
device). ``shard_batch`` takes this rank's rows of a host batch, as JAX's
``shard_batch`` places a batch's leading dimension over the axis.

Every collective of the layer goes through ``gather_slots``: each rank
writes its tensor into its own slot of a zeroed ``(n, ...)`` buffer and one
all-reduce fills every slot on every rank. Adding zeros is exact, so each
rank then holds every rank's tensor bitwise (up to the sign of a zero), and
``ordered_sum`` adds the slots in rank order: every rank gets the same bytes
from the same order whatever the backend's reduction algorithm. It takes an
all-reduce only, which Gloo runs on CUDA tensors as well as on CPU ones
(its all-gather takes CPU tensors only), and NCCL on its devices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DPGroup:
    """The data-parallel group: ``group`` the process group (None: the
    default one), ``rank`` this process's rank in it and ``size`` its
    world size, the data-parallel degree."""

    group: Any
    rank: int
    size: int

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def make_dp_group(tensor_parallel: int = 1, group=None) -> DPGroup:
    """The data-parallel group over the initialised default process group
    (``multihost.initialize``), or over ``group``. Tensor parallelism is
    not ported: ``tensor_parallel`` > 1 raises."""
    if int(tensor_parallel) != 1:
        raise NotImplementedError(
            f"train.tensor_parallel={tensor_parallel}: tensor parallelism is "
            "not ported (ROADMAP Queue 1 item 14d); the parallel layer is "
            "data-parallel only")
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "parallel.multihost.initialize() first")
    return DPGroup(group=group, rank=dist.get_rank(group),
                   size=dist.get_world_size(group))


def local_rows(global_rows: int, dp: DPGroup, n_micro: int = 1) -> list:
    """This rank's rows of a global batch of ``global_rows``: a slice of
    each of its ``n_micro`` microbatches (see ``shard_batch``)."""
    if global_rows % (n_micro * dp.size):
        raise ValueError(
            f"a batch of {global_rows} rows does not split into {n_micro} "
            f"microbatch(es) over the data-parallel degree {dp.size}")
    m = global_rows // n_micro
    b = m // dp.size
    return [slice(i * m + dp.rank * b, i * m + (dp.rank + 1) * b)
            for i in range(n_micro)]


def shard_batch(batch, dp: DPGroup, n_micro: int = 1):
    """This rank's rows of a host (or device) batch: its contiguous slice
    of the leading dimension; with ``n_micro`` microbatches its slice of
    each microbatch, in order, so that the step's microbatch i over the
    ranks is the global batch's microbatch i."""
    pieces = local_rows(int(batch[0].shape[0]), dp, n_micro)

    def take(a):
        if len(pieces) == 1:
            return a[pieces[0]]
        parts = [a[p] for p in pieces]
        if isinstance(a, torch.Tensor):
            return torch.cat(parts)
        import numpy as np

        return np.concatenate(parts)

    return tuple(take(a) for a in batch)


def is_batch_leaf(x, rows: int) -> bool:
    """Whether a state or stats leaf holds rows of the batch: a tensor at
    least 2-D with this rank's ``rows`` leading (the latent model's ``mu``
    and ``logvar``, the classifier's ``y_pred``). The port's other leaves
    are 0-D counters and 1-D statistics."""
    return isinstance(x, torch.Tensor) and x.ndim >= 2 and x.shape[0] == rows


def tensor_leaves(tree) -> list:
    """The tensors of a state or stats tree (dicts, tuples, lists), in
    order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tensor_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tensor_leaves(v)]
    return []


def map_tensors(fn, tree):
    """``tree`` with each tensor ``t`` replaced by ``fn(t)``, in
    ``tensor_leaves``' order; other leaves (generators) kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def gather_slots(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """Every rank's ``x`` on every rank, ``(n,) + x.shape``, in rank order:
    one all-reduce of a zeroed buffer holding ``x`` in this rank's slot.
    Booleans travel as float32 and integers as float64 (exact below
    2**53), the types every backend reduces on every device."""
    dtype = x.dtype
    if dtype == torch.bool:
        x = x.to(torch.float32)
    elif not x.is_floating_point():
        x = x.to(torch.float64)
    buf = torch.zeros((dp.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[dp.rank] = x
    dist.all_reduce(buf, group=dp.group)
    return buf.to(dtype)


def ordered_sum(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """The sum over the ranks of ``x``, added in rank order: the same bytes
    on every rank."""
    slots = gather_slots(x, dp)
    acc = slots[0]
    for k in range(1, dp.size):
        acc = acc + slots[k]
    return acc


def mean_over_ranks(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """The mean over the ranks of a floating ``x`` (``ordered_sum / n``)."""
    return ordered_sum(x, dp) / dp.size


class _GroupSum(torch.autograd.Function):
    """``ordered_sum`` with its transpose as the backward: the cotangent of
    the sum summed over the ranks, in rank order. A rank's term then gets
    every rank's cotangent, and the step's rank mean of the gradients
    turns each rank's share into the gradient of the mean of the ranks'
    losses, whatever each rank's loss does with the sum."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return ordered_sum(x, dp)

    @staticmethod
    def backward(ctx, g):
        return ordered_sum(g.contiguous(), ctx.dp), None


def group_mean(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """The differentiable mean over the ranks of ``x``, each rank's
    statistic of an equal share of the batch's rows: the batch's statistic
    over every rank's rows (BatchNorm's moments on the global grid). A
    group of one gives ``x`` bitwise, forward and backward."""
    return _GroupSum.apply(x, dp) / dp.size


def all_ranks(flag: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """The AND over the ranks of a boolean."""
    return torch.all(gather_slots(flag.reshape(()), dp))


def agree(counts: torch.Tensor, dp: DPGroup, what: str) -> None:
    """Raise unless ``counts`` (an integer vector) is equal on every rank:
    one collective, each count's minimum against its maximum."""
    slots = gather_slots(counts.to(torch.int64), dp)
    lo, hi = slots.min(dim=0).values, slots.max(dim=0).values
    if not torch.equal(lo, hi):
        raise RuntimeError(
            f"the ranks of the global grid parted: {what} range over "
            f"{slots.tolist()} (rank order)")


def gather_rows(x: torch.Tensor, dp: DPGroup, axis: int = 0) -> torch.Tensor:
    """The whole batch from every rank's rows ``x`` (the batch on
    ``axis``), in rank order: bitwise each rank's rows, the same bytes on
    every rank (``gather_slots``)."""
    return torch.cat(gather_slots(x, dp).unbind(0), dim=axis)


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` differentiable: the backward takes this rank's rows
    of the whole batch's cotangent summed over the ranks, in rank order,
    since every rank's loss reaches every rank's rows."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return gather_rows(x, dp)

    @staticmethod
    def backward(ctx, g):
        return rank_rows(ordered_sum(g.contiguous(), ctx.dp), ctx.dp), None


def gather_rows_grad(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """``gather_rows`` (the batch on axis 0) with autograd through it: a
    computation that each rank runs on the whole batch then differentiates
    each rank's loss alone, and the step's rank mean of the gradients is
    the gradient of the mean of the ranks' losses."""
    return _GatherRows.apply(x, dp)


def rank_rows(x: torch.Tensor, dp: DPGroup, axis: int = 0) -> torch.Tensor:
    """This rank's rows of a whole batch ``x`` (the batch on ``axis``),
    contiguous: the inverse of ``gather_rows``."""
    b = x.shape[axis] // dp.size
    return x.narrow(axis, dp.rank * b, b).contiguous()


# the fields of a solve's result (ode.solve.ODESolution,
# sde.solve.SDESolution) that hold rows of the batch, by the batch's axis:
# the states at 0, the saved and recorded ones behind a time axis at 1
ROW_FIELDS = {"y_final": 0, "reservoir_u": 0, "ys": 1, "knot_us": 1,
              "knot_ks": 1, "ckpt_us": 1, "ckpt_ks": 1, "knot_dws": 1,
              "knot_dzs": 1}


def rank_solution(sol, dp: DPGroup):
    """A solve's result on the whole batch with this rank's rows of every
    field that holds rows (``ROW_FIELDS``); the counts, times and flags
    are the whole batch's, the same on every rank."""
    import dataclasses

    rows = {k: rank_rows(getattr(sol, k), dp, a)
            for k, a in ROW_FIELDS.items()
            if getattr(sol, k, None) is not None}
    return dataclasses.replace(sol, **rows)


def replicated(solve, u0: torch.Tensor, dp: DPGroup):
    """``solve(u)``, a kernel's whole solve (which takes no part in a
    collective), on the global grid as GSPMD runs a replicated custom call:
    on the whole batch, gathered from every rank's rows ``u0``, on every
    rank. Its norms are then over all the rows by construction, and every
    rank takes the same decisions from the same bytes. Returns ``(whole,
    this rank's)`` results (``rank_solution``), or ``(None, None)`` where
    ``solve`` declines."""
    whole = solve(gather_rows(u0, dp))
    if whole is None:
        return None, None
    return whole, rank_solution(whole, dp)
