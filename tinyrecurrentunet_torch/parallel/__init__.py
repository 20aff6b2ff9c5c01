"""Data parallelism of the port: one process per card, `torch.distributed`,
computing the JAX package's global-batch step (`parallel/mesh.py`)."""

from tinyrecurrentunet_torch.parallel.mesh import (  # noqa: F401
    all_reduce_sum,
    barrier,
    batch_mean,
    broadcast_state_,
    capturable_collectives,
    default_backend,
    initialize_distributed,
    is_distributed,
    launch,
    loader_shard,
    local_device,
    local_rank_count,
    rank,
    sum_gradients_,
    world_size,
)
