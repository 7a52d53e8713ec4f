"""Env-var storage configuration, as the JAX package's
``storage/registry.py`` reads it, served from the memory backend.

Sources are declared as ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` and the
repositories bind to them with
``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA}_SOURCE``. The port
serves the metadata (apps, channels, evaluation instances) and event
repositories from a
source of TYPE ``memory``; any other TYPE, and the JAX package's default
of sqlite + localfs when nothing is configured, raise until
storage-backed ``pio train``/``pio deploy`` are ported (ROADMAP.md queue
1 item 3). Models go to a directory (``workflow/train.run_train``), so
the MODELDATA repository is not read.
"""

from __future__ import annotations

import os
import threading
from typing import Mapping

from predictionio_tpu_torch.storage.base import Apps, Channels, EvaluationInstances, Events
from predictionio_tpu_torch.storage.memory import MemoryStorageClient

EVENT_DATA = "EVENTDATA"
META_DATA = "METADATA"

_SOURCES_PREFIX = "PIO_STORAGE_SOURCES_"
_REPOSITORIES_PREFIX = "PIO_STORAGE_REPOSITORIES_"
_NOT_PORTED = ("only storage sources of TYPE 'memory' are ported; other backends "
               "come with storage-backed pio train/pio deploy (ROADMAP.md queue 1 item 3)")


class StorageError(RuntimeError):
    """Misconfigured or not yet ported storage."""


class Storage:
    """The repositories' DAOs, from an env mapping (default
    ``os.environ``); one client per source, made at first use."""

    def __init__(self, env: Mapping[str, str] | None = None):
        env = dict(os.environ if env is None else env)
        self._types = {k[len(_SOURCES_PREFIX):-len("_TYPE")]: v for k, v in env.items()
                       if k.startswith(_SOURCES_PREFIX) and k.endswith("_TYPE")}
        self._repositories = {repo: env.get(f"{_REPOSITORIES_PREFIX}{repo}_SOURCE")
                              for repo in (META_DATA, EVENT_DATA)}
        self._clients: dict[str, MemoryStorageClient] = {}
        self._lock = threading.Lock()

    def _client(self, repo: str) -> MemoryStorageClient:
        source = self._repositories[repo]
        if source is None:
            raise StorageError(f"repository {repo} has no source: set "
                               f"{_REPOSITORIES_PREFIX}{repo}_SOURCE; " + _NOT_PORTED)
        if source not in self._types:
            raise StorageError(f"undefined storage source: {source}")
        if self._types[source] != "memory":
            raise StorageError(f"source {source} has TYPE {self._types[source]!r}: "
                               + _NOT_PORTED)
        with self._lock:
            return self._clients.setdefault(source, MemoryStorageClient())

    def get_events(self) -> Events:
        return self._client(EVENT_DATA).events

    def get_meta_data_apps(self) -> Apps:
        return self._client(META_DATA).apps

    def get_meta_data_channels(self) -> Channels:
        return self._client(META_DATA).channels

    def get_meta_data_evaluation_instances(self) -> EvaluationInstances:
        return self._client(META_DATA).evaluation_instances


def memory_storage() -> Storage:
    """A fresh all-in-memory Storage: the metadata and event
    repositories on one memory source."""
    return Storage({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    })
