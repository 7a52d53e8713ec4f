"""Env-var driven storage registry and repository wiring (port of the JAX
package's ``storage/registry.py``).

- Sources are declared as ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` plus
  arbitrary ``PIO_STORAGE_SOURCES_<NAME>_<KEY>`` properties.
- Repositories bind to sources via
  ``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_SOURCE``.
- Clients are created lazily and cached per source.

When no repository is configured at all, the JAX package's default
applies: sqlite metadata + events (``pio.sqlite``) and a localfs model
repository (``models/``) under ``$PIO_FS_BASEDIR``, else
``~/.pio_store``. Both packages read and write the same files.

Backend TYPEs: ``memory``, ``sqlite`` (alias ``jdbc``), ``localfs``, and
the event-only ``binevents`` (alias ``hbase``) and ``fileevents``. The
JAX package's other TYPEs raise :class:`StorageError` naming the
ROADMAP.md item that ports them; there is no fall back to another
backend.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Mapping

from predictionio_tpu_torch.storage.base import (
    AccessKeys,
    Apps,
    BaseStorageClient,
    Channels,
    EngineInstances,
    EvaluationInstances,
    Events,
    Models,
    StorageClientConfig,
)
from predictionio_tpu_torch.storage.binevents import BinEventsStorageClient
from predictionio_tpu_torch.storage.fileevents import FileEventsStorageClient
from predictionio_tpu_torch.storage.localfs import LocalFSStorageClient
from predictionio_tpu_torch.storage.memory import MemoryStorageClient
from predictionio_tpu_torch.storage.sqlite import SQLiteStorageClient

logger = logging.getLogger(__name__)

EVENT_DATA = "EVENTDATA"
META_DATA = "METADATA"
MODEL_DATA = "MODELDATA"

_SOURCES_PREFIX = "PIO_STORAGE_SOURCES"
_REPOSITORIES_PREFIX = "PIO_STORAGE_REPOSITORIES"

BACKENDS: dict[str, Callable[[StorageClientConfig], BaseStorageClient]] = {
    "memory": MemoryStorageClient,
    "sqlite": SQLiteStorageClient,
    # reference pio-env.sh files say TYPE=jdbc for the SQL store
    "jdbc": SQLiteStorageClient,
    "localfs": LocalFSStorageClient,
    "binevents": BinEventsStorageClient,
    # the reference's HBase role: event data only
    "hbase": BinEventsStorageClient,
    "fileevents": FileEventsStorageClient,
}

#: the JAX package's backend TYPEs the port does not serve yet, with the
#: ROADMAP.md queue 1 item that ports each
NOT_PORTED = dict.fromkeys(
    ("postgres", "pg", "elasticsearch", "elasticsearch1", "s3", "hdfs", "chaos"), "item 23")


class StorageError(RuntimeError):
    """Misconfigured or not yet ported storage."""


class Storage:
    """The repositories' DAOs, from an env mapping (default
    ``os.environ``); one client per source, made at first use."""

    def __init__(self, env: Mapping[str, str] | None = None):
        self._env = dict(os.environ if env is None else env)
        self._clients: dict[str, BaseStorageClient] = {}
        self._lock = threading.RLock()
        self._sources = self._parse_sources()
        self._repositories = self._parse_repositories()

    def _parse_sources(self) -> dict[str, tuple[str, StorageClientConfig]]:
        # a source's name is everything between the prefix and the _TYPE
        # suffix, so names may themselves contain underscores (PIO_SQLITE)
        names = {
            k[len(_SOURCES_PREFIX) + 1: -len("_TYPE")]
            for k in self._env
            if k.startswith(_SOURCES_PREFIX + "_") and k.endswith("_TYPE")
            and len(k) > len(_SOURCES_PREFIX) + 1 + len("_TYPE")
        }
        # PIO_STORAGE_SOURCES_X_FOO_TYPE is source "X_FOO"'s type or
        # property "FOO_TYPE" of source "X": when the shorter source X
        # exists, a known backend TYPE value declares a source, anything
        # else stays X's property (warned, so a typo is visible)
        known = set(BACKENDS) | set(NOT_PORTED)
        for name in sorted(names):
            shorter = [o for o in names if o != name and name.startswith(o + "_")]
            if not shorter:
                continue
            type_val = self._env[f"{_SOURCES_PREFIX}_{name}_TYPE"]
            if type_val not in known:
                logger.warning(
                    "PIO_STORAGE_SOURCES_%s_TYPE=%r is not a backend type; treating it "
                    "as property %s_TYPE of source %s", name, type_val,
                    name[len(shorter[0]) + 1:], shorter[0])
                names.discard(name)
        sources: dict[str, tuple[str, StorageClientConfig]] = {}
        for name in names:
            type_key = f"{_SOURCES_PREFIX}_{name}_TYPE"
            prefix = f"{_SOURCES_PREFIX}_{name}_"
            # keys of a LONGER source name sharing this prefix (source
            # PIO vs PIO_SQLITE) are not this source's properties
            longer = [f"{_SOURCES_PREFIX}_{other}_" for other in names
                      if other != name and other.startswith(name + "_")]
            props = {k[len(prefix):]: v for k, v in self._env.items()
                     if k.startswith(prefix) and k != type_key
                     and not any(k.startswith(lp) for lp in longer)}
            props.setdefault("SOURCE_NAME", name)
            sources[name] = (self._env[type_key], StorageClientConfig(
                parallel=props.pop("PARALLEL", "false").lower() == "true",
                test=props.pop("TEST", "false").lower() == "true",
                properties=props,
            ))
        return sources

    def _parse_repositories(self) -> dict[str, str]:
        repos = {repo: source for repo in (META_DATA, EVENT_DATA, MODEL_DATA)
                 if (source := self._env.get(f"{_REPOSITORIES_PREFIX}_{repo}_SOURCE"))}
        if not repos:
            repos = self._default_repositories()
        missing = [r for r in (META_DATA, EVENT_DATA, MODEL_DATA) if r not in repos]
        if missing:
            raise StorageError(
                f"Repositories {missing} have no configured source. Set "
                f"{_REPOSITORIES_PREFIX}_<REPO>_SOURCE and matching "
                f"{_SOURCES_PREFIX}_<NAME>_TYPE environment variables.")
        return repos

    def _default_repositories(self) -> dict[str, str]:
        base = self._env.get("PIO_FS_BASEDIR",
                             os.path.join(os.path.expanduser("~"), ".pio_store"))
        self._sources.setdefault("DEFAULT_SQLITE", ("sqlite", StorageClientConfig(
            properties={"PATH": os.path.join(base, "pio.sqlite")})))
        self._sources.setdefault("DEFAULT_LOCALFS", ("localfs", StorageClientConfig(
            properties={"PATH": os.path.join(base, "models")})))
        return {META_DATA: "DEFAULT_SQLITE", EVENT_DATA: "DEFAULT_SQLITE",
                MODEL_DATA: "DEFAULT_LOCALFS"}

    def client_for_source(self, source_name: str) -> BaseStorageClient:
        with self._lock:
            if source_name in self._clients:
                return self._clients[source_name]
            if source_name not in self._sources:
                raise StorageError(f"Undefined storage source: {source_name}")
            type_name, config = self._sources[source_name]
            if type_name in NOT_PORTED:
                raise StorageError(
                    f"storage source {source_name} has TYPE {type_name!r}, which the "
                    f"port does not serve yet: ROADMAP.md queue 1 {NOT_PORTED[type_name]}; "
                    f"ported TYPEs: {sorted(BACKENDS)}")
            if type_name not in BACKENDS:
                raise StorageError(f"Storage type {type_name!r} is not registered "
                                   f"(available: {sorted(BACKENDS)})")
            client = self._clients[source_name] = BACKENDS[type_name](config)
            return client

    def _repo_client(self, repo: str) -> BaseStorageClient:
        return self.client_for_source(self._repositories[repo])

    def get_events(self) -> Events:
        return self._repo_client(EVENT_DATA).events()

    def get_meta_data_apps(self) -> Apps:
        return self._repo_client(META_DATA).apps()

    def get_meta_data_access_keys(self) -> AccessKeys:
        return self._repo_client(META_DATA).access_keys()

    def get_meta_data_channels(self) -> Channels:
        return self._repo_client(META_DATA).channels()

    def get_meta_data_engine_instances(self) -> EngineInstances:
        return self._repo_client(META_DATA).engine_instances()

    def get_meta_data_evaluation_instances(self) -> EvaluationInstances:
        return self._repo_client(META_DATA).evaluation_instances()

    def get_model_data_models(self) -> Models:
        return self._repo_client(MODEL_DATA).models()

    def verify_all_data_objects(self) -> None:
        """Touch every repository DAO (``pio status``)."""
        self.get_meta_data_apps()
        self.get_meta_data_access_keys()
        self.get_meta_data_channels()
        self.get_meta_data_engine_instances()
        self.get_meta_data_evaluation_instances()
        self.get_model_data_models()
        self.get_events()

    def close(self) -> None:
        with self._lock:
            for client in self._clients.values():
                client.close()
            self._clients.clear()


def memory_storage() -> Storage:
    """A fresh all-in-memory Storage: every repository on one memory
    source."""
    return Storage({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
    })
