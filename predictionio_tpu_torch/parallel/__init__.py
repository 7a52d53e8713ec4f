"""The device mesh: data parallelism over arrays split on the ``data``
mesh axis, model (embedding-table) sharding over the ``model`` axis,
sequences over ``seq``, and collectives that join the positions' local
work, in one process or across a ``torch.distributed`` group (port of
the JAX package's ``parallel/``). The names below load
``parallel/mesh.py``, and torch, on first use, so that the CLI's
``parallel/distributed.py`` hook imports no torch on a single process."""

__all__ = [
    "Mesh",
    "NamedSharding",
    "ShardedArray",
    "all_gather",
    "axis_index",
    "data_sharding",
    "device_put",
    "device_put_local",
    "model_sharding",
    "pad_to_multiple",
    "ppermute",
    "psum",
    "replicated",
    "shard_batch",
    "shard_put",
]


def __getattr__(name: str):
    if name in __all__:
        from predictionio_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
