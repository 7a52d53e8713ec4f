"""Network-filesystem model storage backend (the reference's HDFS role;
a copy of the JAX package's ``storage/hdfs.py``).

Parity: storage/hdfs/src/main/scala/.../hdfs/{StorageClient,
HDFSModels}.scala:31-60 — model blobs under a configured distributed
filesystem path. The reference reached HDFS through the Hadoop
``FileSystem`` client; the TPU-native deployment story is a mounted
network filesystem (NFS / GCS-FUSE / Lustre on Cloud TPU VMs), so this
backend addresses the store by path like ``localfs`` but adds the
durability discipline a shared filesystem needs:

- writes go to a tempfile, are fsync'd, then atomically renamed;
- the directory entry is fsync'd after rename so the blob survives a
  host crash (NFS close-to-open consistency makes this observable to
  other hosts — e.g. a trainer writing a model that a serving host on
  another VM loads);
- every operation routes through ``resilient()``: ESTALE/EIO-class
  transient errors retry with jittered backoff under the shared
  RetryPolicy (replacing the old hand-rolled retry-once) and feed the
  per-source circuit breaker.

Config properties: ``PATH`` (mount-point directory; default
``~/.pio_store/hdfs_models``), ``PREFIX`` (file-name prefix), plus the
``RETRY_*``/``BREAKER_*`` resilience knobs
(docs/operations-resilience.md).
"""

from __future__ import annotations

import errno
import os

from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import Model, StorageClientConfig
from predictionio_tpu_torch.utils.resilience import Resilience, resilient

#: errno values a shared network filesystem emits transiently (stale NFS
#: handle between open and read; EIO on a flapping mount)
_TRANSIENT_ERRNOS = (errno.ESTALE, errno.EIO)


def _is_transient_fs_error(exc: BaseException) -> bool:
    return isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # some filesystems refuse O_RDONLY on dirs; rename already done
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class NetworkFSModels(base.Models):
    def __init__(self, path: str, prefix: str = "",
                 resilience: Resilience | None = None):
        self._path = path
        self._prefix = prefix
        self._resilience = resilience or Resilience(
            "hdfs", classify=_is_transient_fs_error)
        os.makedirs(path, exist_ok=True)

    def _file(self, model_id: str) -> str:
        safe = model_id.replace("/", "_").replace("..", "_")
        return os.path.join(self._path, f"{self._prefix}{safe}")

    def insert(self, model: Model) -> None:
        resilient(self._resilience, self._write, model)

    def _write(self, model: Model) -> None:
        target = self._file(model.id)
        tmp = target + ".tmp"
        with open(tmp, "wb") as f:
            f.write(model.models)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
        _fsync_dir(self._path)

    def get(self, model_id: str) -> Model | None:
        return resilient(self._resilience, self._read, model_id)

    def _read(self, model_id: str) -> Model | None:
        try:
            with open(self._file(model_id), "rb") as f:
                return Model(model_id, f.read())
        except FileNotFoundError:
            return None

    def delete(self, model_id: str) -> None:
        resilient(self._resilience, self._remove, model_id)

    def _remove(self, model_id: str) -> None:
        try:
            os.remove(self._file(model_id))
        except FileNotFoundError:
            pass
        _fsync_dir(self._path)


class HDFSStorageClient(base.BaseStorageClient):
    """Config properties: PATH (mounted network-FS dir), PREFIX."""

    prefix = "HDFS"

    def __init__(self, config: StorageClientConfig = StorageClientConfig()):
        super().__init__(config)
        props = config.properties
        path = props.get(
            "PATH",
            os.path.join(os.path.expanduser("~"), ".pio_store", "hdfs_models"),
        )
        source = props.get("SOURCE_NAME", os.path.abspath(path))
        self._models = NetworkFSModels(
            os.path.abspath(path), props.get("PREFIX", ""),
            resilience=Resilience.from_properties(
                f"hdfs/{source}", props, classify=_is_transient_fs_error),
        )

    def models(self) -> NetworkFSModels:
        return self._models
