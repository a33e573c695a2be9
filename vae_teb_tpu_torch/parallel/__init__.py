"""Process groups, the sharding policy and the collectives of data- and
tensor-parallel training."""

from .collectives import (all_reduce_mean_, all_reduce_sum, copy_to_group,
                          draw, gather_columns, gather_rows, local_rows,
                          noise_rows)
from .mesh import (Distributed, Mesh, Replicated, Sharded, batch_sharding,
                   data_parallel_mesh, hybrid_mesh, init_distributed,
                   replicated_sharding, shard_batch,
                   stacked_batch_sharding, tensor_parallel_rule)

__all__ = ["Distributed", "Mesh", "Replicated", "Sharded",
           "all_reduce_mean_", "all_reduce_sum", "batch_sharding",
           "copy_to_group", "data_parallel_mesh", "draw", "gather_columns",
           "gather_rows", "hybrid_mesh", "init_distributed", "local_rows",
           "noise_rows", "replicated_sharding", "shard_batch",
           "stacked_batch_sharding", "tensor_parallel_rule"]
