"""fileevents backend — append-only JSONL event store (events only; a
copy of the JAX package's ``storage/fileevents.py``, same file format).

Fills the reference's HBase role: a backend that implements ONLY the
event-data repository (SURVEY.md §2.4 — hbase has "no metadata DAOs —
HBase is event-store only"). Layout mirrors HBase's table-per-app/channel
(HBEventsUtil.eventTableName): one log file
``events_<app>[_<ch>].jsonl`` under the configured PATH, each line an
operation record ``{"op": "put"|"del", ...}``. Reads replay the log into
an in-memory index (compacting deletes); writes append + fsync-free
flush, so inserts are O(1) and sequential — the ingestion-friendly write
path that motivated HBase in the reference.

Config: ``PIO_STORAGE_SOURCES_<NAME>_TYPE=fileevents``,
``PIO_STORAGE_SOURCES_<NAME>_PATH=/dir``.
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from typing import Iterator, Sequence

from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.core.json_codec import event_from_json, event_to_json
from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import EventFilter, StorageClientConfig


def _table_name(app_id: int, channel_id: int | None) -> str:
    """Parity: HBEventsUtil.eventTableName — events_<app>[_<ch>]."""
    suffix = f"_{channel_id}" if channel_id is not None else ""
    return f"events_{app_id}{suffix}.jsonl"


class FileEvents(base.Events):
    def __init__(self, path: str):
        self._path = path
        self._lock = threading.RLock()
        #: (app, channel) -> id -> Event; lazily replayed from disk
        self._index: dict[tuple[int, int | None], dict[str, Event]] = {}
        os.makedirs(path, exist_ok=True)

    # -- log helpers --------------------------------------------------------
    def _file(self, app_id: int, channel_id: int | None) -> str:
        return os.path.join(self._path, _table_name(app_id, channel_id))

    def _load(self, app_id: int, channel_id: int | None) -> dict[str, Event]:
        key = (app_id, channel_id)
        if key in self._index:
            return self._index[key]
        table: dict[str, Event] = {}
        path = self._file(app_id, channel_id)
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    if rec["op"] == "put":
                        event = event_from_json(rec["event"], validate=False)
                        table[event.event_id] = event
                    elif rec["op"] == "del":
                        table.pop(rec["id"], None)
        self._index[key] = table
        return table

    def _append(self, app_id: int, channel_id: int | None, rec: dict) -> None:
        with open(self._file(app_id, channel_id), "a") as f:
            f.write(json.dumps(rec) + "\n")

    # -- Events DAO ---------------------------------------------------------
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            self._load(app_id, channel_id)
            path = self._file(app_id, channel_id)
            if not os.path.exists(path):
                open(path, "a").close()
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            self._index.pop((app_id, channel_id), None)
            path = self._file(app_id, channel_id)
            if os.path.exists(path):
                os.remove(path)
                return True
            return False

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        event_id = event.event_id or uuid.uuid4().hex
        event = event.with_event_id(event_id)
        with self._lock:
            table = self._load(app_id, channel_id)
            table[event_id] = event
            self._append(app_id, channel_id,
                         {"op": "put", "event": event_to_json(event)})
        return event_id

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        ids = []
        with self._lock:
            table = self._load(app_id, channel_id)
            lines = []
            for event in events:
                event_id = event.event_id or uuid.uuid4().hex
                event = event.with_event_id(event_id)
                table[event_id] = event
                lines.append(json.dumps({"op": "put", "event": event_to_json(event)}))
                ids.append(event_id)
            with open(self._file(app_id, channel_id), "a") as f:
                f.write("\n".join(lines) + "\n")
        return ids

    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        with self._lock:
            return self._load(app_id, channel_id).get(event_id)

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            table = self._load(app_id, channel_id)
            if event_id not in table:
                return False
            del table[event_id]
            self._append(app_id, channel_id, {"op": "del", "id": event_id})
            return True

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter = EventFilter(),
    ) -> Iterator[Event]:
        with self._lock:
            events = [
                e for e in self._load(app_id, channel_id).values()
                if filter.matches(e)
            ]
        events.sort(key=lambda e: (e.event_time, e.event_id or ""),
                    reverse=filter.reversed)
        if filter.limit is not None and filter.limit >= 0:
            events = events[: filter.limit]
        return iter(events)


class FileEventsStorageClient(base.BaseStorageClient):
    """Events-only client; the metadata/model accessors keep the base
    class's NotImplementedError, mirroring how the reference's hbase
    backend simply has no metadata DAO classes."""

    def __init__(self, config: StorageClientConfig = StorageClientConfig()):
        super().__init__(config)
        path = config.properties.get(
            "PATH",
            os.path.join(
                os.environ.get("PIO_FS_BASEDIR",
                               os.path.join(os.path.expanduser("~"), ".pio_store")),
                "fileevents",
            ),
        )
        self._events = FileEvents(path)

    def events(self) -> FileEvents:
        return self._events
