"""The process grid: one rank a process over ``torch.distributed``.

Counterpart of ``localregneuralde_tpu/parallel/mesh.py``: a world of n
ranks stands for JAX's ``{"data": n / tp, "model": tp}`` mesh, laid out as
``make_mesh`` reshapes the devices, row-major, so world rank = d·tp + m.
The **data** subgroups are the ranks with equal m (JAX's ``data`` axis: the
batch's rows spread over them), the **model** subgroups the ranks with
equal d (the ``model`` axis: tensor parallelism's weight shards). With tp =
1 the data group is the whole world. ``shard_batch`` takes this rank's
rows of a host batch, as JAX's ``shard_batch`` places a batch's leading
dimension over the data axis; the ranks of a model group take the same
rows.

Every collective of the layer goes through ``gather_slots`` (over the data
group) or ``model_slots`` (over the model group): each rank writes its
tensor into its own slot of a zeroed ``(n, ...)`` buffer and one
all-reduce fills every slot on every rank. Adding zeros is exact, so each
rank then holds every rank's tensor bitwise (up to the sign of a zero), and
``ordered_sum`` and ``model_sum`` add the slots in rank order: every rank
gets the same bytes from the same order whatever the backend's reduction
algorithm. It takes an all-reduce only, which Gloo runs on CUDA tensors as
well as on CPU ones (its all-gather takes CPU tensors only), and NCCL on
its devices.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DPGroup:
    """The process grid as this rank sees it: ``group`` the data subgroup
    (None: the default process group), ``rank`` this process's rank in it
    and ``size`` its size, the data-parallel degree; ``model_group``,
    ``model_rank`` and ``model_size`` the same of the model subgroup (the
    tensor-parallel degree; a size of 1 and no group without tensor
    parallelism); ``world_rank`` and ``world_size`` this process's rank in
    the whole grid and its size. ``specs`` are tensor parallelism's
    parameter specs (``sharded_train.train_state_shardings``, ``{dotted
    name: sharded dimension or None}``), named from the module this grid
    is handed to (``under``); empty without tensor parallelism."""

    group: Any
    rank: int
    size: int
    model_group: Any = None
    model_rank: int = 0
    model_size: int = 1
    world_rank: Optional[int] = None
    world_size: Optional[int] = None
    specs: Dict[str, Optional[int]] = field(default_factory=dict,
                                            compare=False, hash=False)

    def __post_init__(self):
        if self.world_rank is None:
            object.__setattr__(self, "world_rank", self.rank)
        if self.world_size is None:
            object.__setattr__(self, "world_size", self.size)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def data_axis(self) -> "DPGroup":
        """This grid with its model axis dropped: the group of a
        computation that every rank of a model group runs alike on whole
        weights (the kernel routes under tensor parallelism)."""
        return dataclasses.replace(self, model_group=None, model_rank=0,
                                   model_size=1, specs={})

    def under(self, path) -> "DPGroup":
        """This grid as the submodule at ``path`` (a tuple of names) sees
        it: ``specs`` of its parameters only, named from it."""
        if not self.specs or not path:
            return self
        prefix = ".".join(path) + "."
        return dataclasses.replace(self, specs={
            k[len(prefix):]: d for k, d in self.specs.items()
            if k.startswith(prefix)})

    def world(self) -> "DPGroup":
        """The whole grid as one data group (the default process group)."""
        if self.model_size == 1:
            return self
        return DPGroup(group=None, rank=self.world_rank,
                       size=self.world_size)


def check_grid(tp: int, world: Optional[int] = None) -> None:
    """JAX's runner's checks of the tensor-parallel degree: at least 1, and
    a divisor of the ``world`` ranks (where given)."""
    if tp < 1:
        raise ValueError(f"train.tensor_parallel must be >= 1, got {tp}")
    if world is not None and world % tp:
        raise ValueError(
            f"tensor_parallel={tp} does not divide the {world} ranks")


def make_dp_group(tensor_parallel: int = 1, group=None) -> DPGroup:
    """The process grid over the initialised default process group
    (``multihost.initialize``), or over ``group``: ``tensor_parallel`` =
    tp model ranks by world / tp data ranks, world rank = d·tp + m (JAX's
    ``make_mesh({"data": world / tp, "model": tp})``). With tp > 1 every
    rank makes every data and model subgroup, in the same order (Gloo
    needs that). Raises ``ValueError`` where tp is below 1 or does not
    divide the world."""
    tp = int(tensor_parallel)
    check_grid(tp)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "parallel.multihost.initialize() first")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    check_grid(tp, world)
    if tp == 1:
        return DPGroup(group=group, rank=rank, size=world)
    ranks = (list(range(world)) if group is None
             else dist.get_process_group_ranks(group))
    n_data = world // tp
    data = [dist.new_group([ranks[d * tp + m] for d in range(n_data)])
            for m in range(tp)]
    model = [dist.new_group([ranks[d * tp + m] for m in range(tp)])
             for d in range(n_data)]
    d, m = divmod(rank, tp)
    return DPGroup(group=data[m], rank=d, size=n_data, model_group=model[d],
                   model_rank=m, model_size=tp, world_rank=rank,
                   world_size=world)


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


def _slots(x: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` on every rank, ``(size,) +
    x.shape``, in rank order: one all-reduce of a zeroed buffer holding
    ``x`` in this rank's slot. Booleans travel as float32 and integers as
    float64 (exact below 2**53), the types every backend reduces on every
    device."""
    dtype = x.dtype
    if dtype == torch.bool:
        x = x.to(torch.float32)
    elif not x.is_floating_point():
        x = x.to(torch.float64)
    buf = torch.zeros((size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[rank] = x
    dist.all_reduce(buf, group=group)
    return buf.to(dtype)


def _in_order(slots: torch.Tensor) -> torch.Tensor:
    acc = slots[0]
    for k in range(1, slots.shape[0]):
        acc = acc + slots[k]
    return acc


def gather_slots(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """Every data rank's ``x`` on every rank, ``(n,) + x.shape``, in rank
    order (``_slots`` over the data group)."""
    return _slots(x, dp.group, dp.rank, dp.size)


def model_slots(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """``gather_slots`` over the model group: every model rank's ``x``."""
    return _slots(x, dp.model_group, dp.model_rank, dp.model_size)


def ordered_sum(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """The sum over the data ranks of ``x``, added in rank order: the same
    bytes on every rank."""
    return _in_order(gather_slots(x, dp))


def model_sum(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """``ordered_sum`` over the model group."""
    return _in_order(model_slots(x, dp))


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


# --- the model axis (tensor parallelism)

def model_shard(x: torch.Tensor, dp: DPGroup, dim: int) -> torch.Tensor:
    """This model rank's contiguous slice of a whole ``x`` along ``dim``."""
    n = x.shape[dim] // dp.model_size
    return x.narrow(dim, dp.model_rank * n, n).contiguous()


def model_cat(x: torch.Tensor, dp: DPGroup, dim: int) -> torch.Tensor:
    """The whole tensor from every model rank's slice ``x`` along ``dim``,
    in rank order: bitwise each rank's slice, the same bytes on every
    rank (``model_slots``)."""
    return torch.cat(model_slots(x.contiguous(), dp).unbind(0), dim=dim)


class _ModelGather(torch.autograd.Function):
    """``model_cat`` differentiable: every model rank computes alike on the
    whole tensor, so each holds the same cotangent of it, and the backward
    takes this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, dp, dim):
        ctx.dp, ctx.dim = dp, dim
        return model_cat(x, dp, dim)

    @staticmethod
    def backward(ctx, g):
        return model_shard(g, ctx.dp, ctx.dim), None, None


def model_gather(x: torch.Tensor, dp: DPGroup, dim: int) -> torch.Tensor:
    """The whole tensor from this model rank's slice ``x`` (a weight
    shard, or a column-parallel layer's features), with autograd through
    it (``_ModelGather``)."""
    return _ModelGather.apply(x, dp, dim)


class _ModelCopy(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over the model group
    in rank order: the input of a column-parallel product, which each
    model rank multiplies by its own columns."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_sum(g.contiguous(), ctx.dp), None


def model_copy(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    return _ModelCopy.apply(x, dp)


class _ModelSlice(torch.autograd.Function):
    """This model rank's slice of a whole ``x`` along ``dim`` (the input of
    a row-parallel product); the backward puts each rank's slice of the
    cotangent in its place, summed over the model group (``model_cat``:
    the slices are disjoint, so the sum of the zero-padded slots is their
    concatenation)."""

    @staticmethod
    def forward(ctx, x, dp, dim):
        ctx.dp, ctx.dim = dp, dim
        return model_shard(x, dp, dim)

    @staticmethod
    def backward(ctx, g):
        return model_cat(g, ctx.dp, ctx.dim), None, None


def model_slice(x: torch.Tensor, dp: DPGroup, dim: int) -> torch.Tensor:
    return _ModelSlice.apply(x, dp, dim)


class _ModelReduce(torch.autograd.Function):
    """``model_sum`` of a row-parallel product's partial sums, whose
    backward is the identity: each rank's partial gets the sum's cotangent,
    the same on every model rank."""

    @staticmethod
    def forward(ctx, x, dp):
        return model_sum(x, dp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def model_reduce(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    return _ModelReduce.apply(x, dp)


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
