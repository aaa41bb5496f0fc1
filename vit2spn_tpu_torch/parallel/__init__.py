"""Several ranks (port of `vit2spn_tpu/parallel/`): the (data, model) mesh of
processes, data parallelism with one explicit reduction, and Megatron-style
tensor parallelism, under the JAX package's export names."""

from vit2spn_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    init_distributed,
    make_mesh,
    replicated_sharding,
    shard_batch,
)
from vit2spn_tpu_torch.parallel.shard_map_dp import all_reduce_grads, shard_map_dp_step

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "shard_map_dp_step",
    "Mesh",
    "init_distributed",
    "all_reduce_grads",
]
