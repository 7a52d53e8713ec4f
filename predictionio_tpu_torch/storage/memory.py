"""In-memory storage backend (the subset of the JAX package's
``storage/memory.py`` that training and evaluation read through):
events, apps, channels and evaluation instances.
"""

from __future__ import annotations

import dataclasses
import threading
import uuid
from typing import Iterator, Sequence

from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import App, Channel, EvaluationInstance, EventFilter


class MemoryEvents(base.Events):
    def __init__(self):
        self._tables: dict[tuple[int, int | None], dict[str, Event]] = {}
        self._lock = threading.RLock()

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            self._tables.setdefault((app_id, channel_id), {})
        return True

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: int | None = None) -> list[str]:
        # one lock acquisition per batch: a concurrent reader sees the
        # whole batch or none of it
        ids = [e.event_id or uuid.uuid4().hex for e in events]
        with self._lock:
            table = self._tables.setdefault((app_id, channel_id), {})
            for event_id, e in zip(ids, events):
                table[event_id] = e.with_event_id(event_id)
        return ids

    def find(self, app_id: int, channel_id: int | None = None,
             filter: EventFilter = EventFilter()) -> Iterator[Event]:
        with self._lock:
            events = [e for e in self._tables.get((app_id, channel_id), {}).values()
                      if filter.matches(e)]
        # the (event time, id) total order every backend of the JAX
        # package keeps: equal times order by id, not by insertion
        events.sort(key=lambda e: (e.event_time, e.event_id or ""), reverse=filter.reversed)
        if filter.limit is not None and filter.limit >= 0:
            events = events[: filter.limit]
        return iter(events)


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

    def get_by_name(self, name: str) -> App | None:
        return next((a for a in self._apps.values() if a.name == name), None)


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

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [c for c in self._channels.values() if c.appid == app_id]


class MemoryEvaluationInstances(base.EvaluationInstances):
    def __init__(self):
        self._instances: dict[str, EvaluationInstance] = {}
        self._lock = threading.RLock()

    def insert(self, instance: EvaluationInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        with self._lock:
            self._instances[instance_id] = dataclasses.replace(instance, id=instance_id)
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


class MemoryStorageClient:
    """One memory source: its DAOs live as long as the client."""

    def __init__(self):
        self.events = MemoryEvents()
        self.apps = MemoryApps()
        self.channels = MemoryChannels()
        self.evaluation_instances = MemoryEvaluationInstances()
