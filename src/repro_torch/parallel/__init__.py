"""Sharding rules of the port: the reference's ``parallel`` package on
DTensor placements."""

from .sharding import (
    batch_specs, cache_partition_specs, param_specs, shard_tree,
    to_placements,
)

__all__ = ["param_specs", "batch_specs", "cache_partition_specs",
           "to_placements", "shard_tree"]
