"""The device mesh: data parallelism over arrays split on the ``data``
mesh axis, model (embedding-table) sharding over the ``model`` axis, and
collectives that join the positions' local work (port of the JAX
package's ``parallel/``; one process drives every position)."""

from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    ShardedArray,
    all_gather,
    axis_index,
    data_sharding,
    device_put,
    model_sharding,
    pad_to_multiple,
    psum,
    replicated,
    shard_batch,
    shard_put,
)

__all__ = [
    "Mesh",
    "NamedSharding",
    "ShardedArray",
    "all_gather",
    "axis_index",
    "data_sharding",
    "device_put",
    "model_sharding",
    "pad_to_multiple",
    "psum",
    "replicated",
    "shard_batch",
    "shard_put",
]
