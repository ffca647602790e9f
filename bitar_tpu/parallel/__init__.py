"""Multi-device / multi-host parallel execution layer."""

from . import multihost
from .pipeline import (
    distributed_step,
    prepare_distributed_step,
    reorder_tables_for_recv,
)
from .sharding import (
    BLOCKS_AXIS,
    make_mesh,
    pad_block_count,
    prepare_sharded_batch,
    shard_blocks,
    sharded_decode,
)
from .shuffle import ShufflePlan, execute_shuffle, hash_partition, plan_shuffle

__all__ = [
    "BLOCKS_AXIS",
    "multihost",
    "ShufflePlan",
    "distributed_step",
    "execute_shuffle",
    "hash_partition",
    "make_mesh",
    "pad_block_count",
    "plan_shuffle",
    "prepare_distributed_step",
    "prepare_sharded_batch",
    "reorder_tables_for_recv",
    "shard_blocks",
    "sharded_decode",
]
