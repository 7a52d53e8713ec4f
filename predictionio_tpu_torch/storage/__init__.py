"""Pluggable storage: registry, DAO interfaces, backends."""

from predictionio_tpu_torch.storage.base import (
    AccessKey,
    AccessKeys,
    App,
    Apps,
    BaseStorageClient,
    Channel,
    Channels,
    EngineInstance,
    EngineInstances,
    EvaluationInstance,
    EvaluationInstances,
    EventFilter,
    Events,
    Model,
    Models,
    StorageClientConfig,
)
from predictionio_tpu_torch.storage.registry import (
    EVENT_DATA,
    META_DATA,
    MODEL_DATA,
    Storage,
    StorageError,
    register_backend,
)

__all__ = [
    "AccessKey", "AccessKeys", "App", "Apps", "BaseStorageClient",
    "Channel", "Channels", "EngineInstance", "EngineInstances",
    "EvaluationInstance", "EvaluationInstances", "EventFilter", "Events",
    "Model", "Models", "StorageClientConfig",
    "EVENT_DATA", "META_DATA", "MODEL_DATA",
    "Storage", "StorageError", "register_backend",
]
