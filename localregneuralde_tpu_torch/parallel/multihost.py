"""Process plumbing of data parallelism: bring-up, the primary process,
each process's rows, replicated state and the gathered state a checkpoint
keeps.

Counterpart of ``localregneuralde_tpu/parallel/multihost.py``. A rank is a
process: ``torchrun --nproc_per_node=n`` (or any launcher that sets
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``) starts them,
and ``initialize`` joins them into the default process group. By default
the backend is NCCL when every rank of the node has a CUDA device of its
own and Gloo otherwise (the CPU, or ranks that share a card: NCCL refuses
two ranks on one device). A process started alone runs a group of one.

Replicated state is built from the same seed on every rank and checked once
against rank 0's (``place_train_state``); ``gather_to_host`` all-gathers
the batch-shaped layer state over the data group so that every rank
holds, and world rank 0 writes, the whole state (the parameters' model
shards are gathered by ``sharded_train.whole_train_state``).
"""
from __future__ import annotations

import os
import socket
from typing import Any, Optional

import torch
import torch.distributed as dist

from .mesh import (
    DPGroup, gather_slots, is_batch_leaf, local_rows, map_tensors,
    tensor_leaves,
)


def free_port() -> int:
    """A free TCP port on this host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(device) -> str:
    """NCCL when ``device`` is a CUDA device and the node has one for each
    of its ranks (``LOCAL_WORLD_SIZE``), else Gloo."""
    device = torch.device(device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if device.type == "cuda" and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def initialize(rank: Optional[int] = None, world_size: Optional[int] = None,
               master_addr: Optional[str] = None,
               master_port: Optional[int] = None,
               backend: Optional[str] = None, device="cpu") -> None:
    """Join the default process group (idempotent: a no-op once it is up).
    Each argument defaults to its ``torchrun`` environment variable
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), and
    without them to a group of one on 127.0.0.1 at a free port;
    ``backend`` to ``default_backend(device)``."""
    if dist.is_initialized():
        return
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    addr = master_addr or env.get("MASTER_ADDR", "127.0.0.1")
    port = master_port or env.get("MASTER_PORT") or free_port()
    backend = backend or default_backend(device)
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world_size)


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK mod the cards)``, so ranks
    beyond the cards share them; the CPU for ``device_type='cpu'``."""
    if device_type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def is_primary() -> bool:
    """True on the process that writes the canonical logs and checkpoints
    (rank 0, or a process outside any group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_batch_slice(global_batch_size: int, dp: DPGroup) -> slice:
    """The contiguous rows of a global batch this process loads."""
    return local_rows(global_batch_size, dp)[0]


def place_replicated(tree: Any, dp: DPGroup) -> Any:
    """Make every tensor of ``tree`` rank 0's, in place (a broadcast each):
    host values that every rank should hold identically."""
    for t in tensor_leaves(tree):
        with torch.no_grad():
            dist.broadcast(t, src=0, group=dp.group)
    return tree


def place_train_state(ts, dp: DPGroup):
    """Check once that the replicated train state starts identical on every
    rank of the whole grid (the parameters, built from the same seed, whole:
    before tensor parallelism cuts them): rank 0's values are broadcast and
    compared bitwise; a rank that differs raises. Returns ``ts``."""
    dp = dp.world()
    params = list(ts.params.values())
    theirs = [p.detach().clone() for p in params]
    place_replicated(theirs, dp)
    same = torch.tensor(all(torch.equal(a, b) for a, b in zip(params, theirs)))
    if not bool(torch.all(gather_slots(same.to(params[0].device), dp))):
        raise RuntimeError(
            "the replicated parameters differ between ranks: build the "
            "model from the same seed on every rank")
    return ts


def gather_to_host(tree: Any, dp: DPGroup, rows: int) -> Any:
    """``tree`` with every batch-shaped tensor (at least 2-D, ``rows`` of
    this rank leading) replaced by the concatenation of every rank's, in
    rank order: the whole state on every rank, for its checkpoint. Other
    leaves are returned as they are."""
    def gather(t):
        if not is_batch_leaf(t, rows):
            return t
        slots = gather_slots(t.detach(), dp)
        return slots.reshape((-1,) + tuple(t.shape[1:]))

    return map_tensors(gather, tree)


def local_state(tree: Any, dp: DPGroup, global_rows: int) -> Any:
    """The inverse of ``gather_to_host`` on a restored state: each
    batch-shaped tensor with ``global_rows`` rows cut to this rank's."""
    rows = local_rows(global_rows, dp)[0]
    return map_tensors(lambda t: t[rows].clone()
                       if is_batch_leaf(t, global_rows) else t, tree)


def checkpoint_subdir(path: str, dp: Optional[DPGroup]) -> str:
    """World rank 0 keeps ``path``; rank r > 0 writes under
    ``path/proc{r}``, so nothing clobbers on a shared filesystem (JAX
    ``runner.py:289-294``)."""
    if dp is None or dp.world_rank == 0:
        return path
    return os.path.join(path, f"proc{dp.world_rank}")

