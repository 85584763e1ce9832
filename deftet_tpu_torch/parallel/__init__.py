"""Data parallelism over torch.distributed: the world, the divisor clamp,
batch sharding, replication and the collectives of the data-parallel
step (the port's counterpart of deftet_tpu/parallel)."""

from .mesh import (
    Shard,
    World,
    active,
    all_reduce_sum,
    draw_rows,
    embed_rows,
    init_world,
    largest_divisor,
    mean_over_shard,
    replicate,
    rows_of,
    shard_rows,
    sharded,
    sum_over_shard,
    world_from_env,
)
from .spawn import run_ranks

__all__ = [
    "Shard",
    "World",
    "active",
    "all_reduce_sum",
    "draw_rows",
    "embed_rows",
    "init_world",
    "largest_divisor",
    "mean_over_shard",
    "replicate",
    "rows_of",
    "run_ranks",
    "shard_rows",
    "sharded",
    "sum_over_shard",
    "world_from_env",
]
