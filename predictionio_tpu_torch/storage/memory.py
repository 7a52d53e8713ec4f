"""In-memory storage backend — the test/dev backend (a copy of the JAX
package's ``storage/memory.py``).

The reference has no in-memory backend (its tests hit live dockerized
stores); this one exists so unit tests and quickstarts run with zero
services, while the same columnar/row conformance checks also run
against sqlite (tests/test_torch_storage.py).
"""

from __future__ import annotations

import dataclasses
import threading
import uuid
from typing import Iterator

from predictionio_tpu_torch.core.columns import EventColumns, check_batch_size
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    EventFilter,
    Model,
    StorageClientConfig,
)


def _sort_and_limit(events: list[Event], filter: EventFilter) -> list[Event]:
    # id tiebreak: equal-timestamp order must be a property of the DATA,
    # not of dict insertion order — the (eventTime, id) total order every
    # other backend pins (sqlite ORDER BY)
    events.sort(key=lambda e: (e.event_time, e.event_id or ""),
                reverse=filter.reversed)
    if filter.limit is not None and filter.limit >= 0:
        events = events[: filter.limit]
    return events


class MemoryEvents(base.Events):
    def __init__(self):
        self._tables: dict[tuple[int, int | None], dict[str, Event]] = {}
        self._lock = threading.RLock()

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            self._tables.setdefault((app_id, channel_id), {})
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            return self._tables.pop((app_id, channel_id), None) is not None

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        event_id = event.event_id or uuid.uuid4().hex
        with self._lock:
            self._tables.setdefault((app_id, channel_id), {})
            self._tables[(app_id, channel_id)][event_id] = event.with_event_id(event_id)
        return event_id

    def insert_batch(
        self, events, app_id: int, channel_id: int | None = None
    ) -> list[str]:
        # one lock acquisition per batch (the transactional analogue of
        # sqlite's single-commit executemany): a concurrent reader sees
        # the whole batch or none of it
        ids = [e.event_id or uuid.uuid4().hex for e in events]
        with self._lock:
            table = self._tables.setdefault((app_id, channel_id), {})
            for event_id, e in zip(ids, events):
                table[event_id] = e.with_event_id(event_id)
        return ids

    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        with self._lock:
            return self._tables.get((app_id, channel_id), {}).get(event_id)

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            return self._tables.get((app_id, channel_id), {}).pop(event_id, None) is not None

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter = EventFilter(),
    ) -> Iterator[Event]:
        with self._lock:
            events = [
                e
                for e in self._tables.get((app_id, channel_id), {}).values()
                if filter.matches(e)
            ]
        return iter(_sort_and_limit(events, filter))

    def find_columnar(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter = EventFilter(),
        batch_size: int = base.Events.COLUMNAR_BATCH_SIZE,
    ):
        """Native path: one lock acquisition + one filter/sort pass over
        the table, then a direct single-pass array build per batch —
        no per-batch re-entry into ``find`` and no iterator hops."""
        check_batch_size(batch_size)
        return self._find_columnar(app_id, channel_id, filter, batch_size)

    def _find_columnar(self, app_id, channel_id, filter, batch_size):
        with self._lock:
            events = [
                e
                for e in self._tables.get((app_id, channel_id), {}).values()
                if filter.matches(e)
            ]
        events = _sort_and_limit(events, filter)
        for at in range(0, len(events), batch_size):
            yield EventColumns.from_events(events[at:at + batch_size])


class MemoryApps(base.Apps):
    def __init__(self):
        self._apps: dict[int, App] = {}
        self._next_id = 1
        self._lock = threading.RLock()

    def insert(self, app: App) -> int | None:
        with self._lock:
            if self.get_by_name(app.name) is not None:
                return None
            app_id = app.id if app.id > 0 else self._next_id
            if app_id in self._apps:
                return None
            self._next_id = max(self._next_id, app_id) + 1
            self._apps[app_id] = App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> App | None:
        return self._apps.get(app_id)

    def get_by_name(self, name: str) -> App | None:
        return next((a for a in self._apps.values() if a.name == name), None)

    def get_all(self) -> list[App]:
        return sorted(self._apps.values(), key=lambda a: a.id)

    def update(self, app: App) -> None:
        with self._lock:
            self._apps[app.id] = app

    def delete(self, app_id: int) -> None:
        with self._lock:
            self._apps.pop(app_id, None)


class MemoryAccessKeys(base.AccessKeys):
    def __init__(self):
        self._keys: dict[str, AccessKey] = {}
        self._lock = threading.RLock()

    def insert(self, access_key: AccessKey) -> str | None:
        key = access_key.key or self.generate_key()
        with self._lock:
            if key in self._keys:
                return None
            self._keys[key] = AccessKey(key, access_key.appid, tuple(access_key.events))
            return key

    def get(self, key: str) -> AccessKey | None:
        return self._keys.get(key)

    def get_all(self) -> list[AccessKey]:
        return list(self._keys.values())

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [k for k in self._keys.values() if k.appid == app_id]

    def update(self, access_key: AccessKey) -> None:
        with self._lock:
            self._keys[access_key.key] = access_key

    def delete(self, key: str) -> None:
        with self._lock:
            self._keys.pop(key, None)


class MemoryChannels(base.Channels):
    def __init__(self):
        self._channels: dict[int, Channel] = {}
        self._next_id = 1
        self._lock = threading.RLock()

    def insert(self, channel: Channel) -> int | None:
        if not Channel.is_valid_name(channel.name):
            return None
        with self._lock:
            channel_id = channel.id if channel.id > 0 else self._next_id
            if channel_id in self._channels:
                return None
            self._next_id = max(self._next_id, channel_id) + 1
            self._channels[channel_id] = Channel(channel_id, channel.name, channel.appid)
            return channel_id

    def get(self, channel_id: int) -> Channel | None:
        return self._channels.get(channel_id)

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [c for c in self._channels.values() if c.appid == app_id]

    def delete(self, channel_id: int) -> None:
        with self._lock:
            self._channels.pop(channel_id, None)


class MemoryEngineInstances(base.EngineInstances):
    def __init__(self):
        self._instances: dict[str, EngineInstance] = {}
        self._lock = threading.RLock()

    def insert(self, instance: EngineInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        with self._lock:
            self._instances[instance_id] = (
                instance if instance.id else dataclasses.replace(instance, id=instance_id)
            )
        return instance_id

    def get(self, instance_id: str) -> EngineInstance | None:
        return self._instances.get(instance_id)

    def get_all(self) -> list[EngineInstance]:
        return list(self._instances.values())

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        out = [
            i
            for i in self._instances.values()
            if i.status == "COMPLETED"
            and i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        return sorted(out, key=lambda i: i.start_time, reverse=True)

    def update(self, instance: EngineInstance) -> None:
        with self._lock:
            self._instances[instance.id] = instance

    def delete(self, instance_id: str) -> None:
        with self._lock:
            self._instances.pop(instance_id, None)


class MemoryEvaluationInstances(base.EvaluationInstances):
    def __init__(self):
        self._instances: dict[str, EvaluationInstance] = {}
        self._lock = threading.RLock()

    def insert(self, instance: EvaluationInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        with self._lock:
            self._instances[instance_id] = (
                instance if instance.id else dataclasses.replace(instance, id=instance_id)
            )
        return instance_id

    def get(self, instance_id: str) -> EvaluationInstance | None:
        return self._instances.get(instance_id)

    def get_all(self) -> list[EvaluationInstance]:
        return list(self._instances.values())

    def get_completed(self) -> list[EvaluationInstance]:
        out = [i for i in self._instances.values() if i.status == "EVALCOMPLETED"]
        return sorted(out, key=lambda i: i.start_time, reverse=True)

    def update(self, instance: EvaluationInstance) -> None:
        with self._lock:
            self._instances[instance.id] = instance

    def delete(self, instance_id: str) -> None:
        with self._lock:
            self._instances.pop(instance_id, None)


class MemoryModels(base.Models):
    def __init__(self):
        self._models: dict[str, Model] = {}
        self._lock = threading.RLock()

    def insert(self, model: Model) -> None:
        with self._lock:
            self._models[model.id] = model

    def get(self, model_id: str) -> Model | None:
        return self._models.get(model_id)

    def delete(self, model_id: str) -> None:
        with self._lock:
            self._models.pop(model_id, None)


class MemoryStorageClient(base.BaseStorageClient):
    """All repositories in process memory."""

    def __init__(self, config: StorageClientConfig = StorageClientConfig()):
        super().__init__(config)
        self._events = MemoryEvents()
        self._apps = MemoryApps()
        self._access_keys = MemoryAccessKeys()
        self._channels = MemoryChannels()
        self._engine_instances = MemoryEngineInstances()
        self._evaluation_instances = MemoryEvaluationInstances()
        self._models = MemoryModels()

    def events(self) -> MemoryEvents:
        return self._events

    def apps(self) -> MemoryApps:
        return self._apps

    def access_keys(self) -> MemoryAccessKeys:
        return self._access_keys

    def channels(self) -> MemoryChannels:
        return self._channels

    def engine_instances(self) -> MemoryEngineInstances:
        return self._engine_instances

    def evaluation_instances(self) -> MemoryEvaluationInstances:
        return self._evaluation_instances

    def models(self) -> MemoryModels:
        return self._models
