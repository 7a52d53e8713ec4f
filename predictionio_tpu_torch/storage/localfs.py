"""Local-filesystem model storage backend.

Parity: storage/localfs/src/main/scala/.../localfs/{StorageClient,
LocalFSModels}.scala:32-61 — one file per model blob under a configured
directory (a copy of the JAX package's ``storage/localfs.py``).
"""

from __future__ import annotations

import os

from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import Model, StorageClientConfig


class LocalFSModels(base.Models):
    def __init__(self, path: str, prefix: str = ""):
        self._path = path
        self._prefix = prefix
        os.makedirs(path, exist_ok=True)

    def _file(self, model_id: str) -> str:
        # model ids are uuid hex / instance ids; keep paths safe anyway
        safe = model_id.replace("/", "_").replace("..", "_")
        return os.path.join(self._path, f"{self._prefix}{safe}")

    def insert(self, model: Model) -> None:
        tmp = self._file(model.id) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(model.models)
        os.replace(tmp, self._file(model.id))

    def get(self, model_id: str) -> Model | None:
        try:
            with open(self._file(model_id), "rb") as f:
                return Model(model_id, f.read())
        except FileNotFoundError:
            return None

    def delete(self, model_id: str) -> None:
        try:
            os.remove(self._file(model_id))
        except FileNotFoundError:
            pass


class LocalFSStorageClient(base.BaseStorageClient):
    """Config properties: PATH (directory; default ~/.pio_store/models)."""

    prefix = "LocalFS"

    def __init__(self, config: StorageClientConfig = StorageClientConfig()):
        super().__init__(config)
        path = config.properties.get(
            "PATH", os.path.join(os.path.expanduser("~"), ".pio_store", "models")
        )
        self._models = LocalFSModels(os.path.abspath(path))

    def models(self) -> LocalFSModels:
        return self._models
