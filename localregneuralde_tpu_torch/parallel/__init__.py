"""Data and tensor parallelism over ``torch.distributed``, one rank a
process (counterpart of ``localregneuralde_tpu/parallel/``): the process
grid and the batch's rows (``mesh``), the process plumbing
(``multihost``), the per-rank grid (``shardmap_train``,
``train.data_parallel='shardmap'``) and the global grid (``sharded_train``,
``'gspmd'``), with tensor parallelism's parameter specs and shards
(``train.tensor_parallel``)."""
from . import multihost
from .mesh import DPGroup, make_dp_group, shard_batch
from .sharded_train import (
    make_param_shardings,
    make_sharded_eval_step,
    make_sharded_multi_train_step,
    make_sharded_train_step,
    shard_train_state,
    sharding_rules_for_mlp_tp,
    train_state_shardings,
    whole_train_state,
)
from .shardmap_train import make_shardmap_train_step, rank_state

__all__ = [
    "DPGroup",
    "make_dp_group",
    "make_param_shardings",
    "make_sharded_eval_step",
    "make_sharded_multi_train_step",
    "make_sharded_train_step",
    "make_shardmap_train_step",
    "multihost",
    "rank_state",
    "shard_batch",
    "shard_train_state",
    "sharding_rules_for_mlp_tp",
    "train_state_shardings",
    "whole_train_state",
]
