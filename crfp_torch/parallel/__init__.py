"""Parallelism over ``torch.distributed`` (crfp_tpu/parallel): data
parallelism for training (``sharding``) and height-sharded streaming
inference (``spatial``)."""

from crfp_torch.parallel.sharding import (
    data_parallel_mesh,
    global_mesh,
    initialize_distributed,
    replicate,
    shard_batch,
)
from crfp_torch.parallel.spatial import (
    SpatialStreamingRunner,
    halo_exchange,
    shard_frame_height,
    sharded_conv3x3,
)

__all__ = [
    "data_parallel_mesh",
    "global_mesh",
    "initialize_distributed",
    "shard_batch",
    "replicate",
    "SpatialStreamingRunner",
    "halo_exchange",
    "sharded_conv3x3",
    "shard_frame_height",
]
