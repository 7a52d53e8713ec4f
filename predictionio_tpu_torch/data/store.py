"""EventStore: the engine-facing, name-based facade over the event DAOs
(port of the JAX package's ``data/store.py``): the training reads
``find`` and the columnar ``scan``, ``aggregate_properties``, and the
serving-time single-entity read ``find_by_entity``.
"""

from __future__ import annotations

from datetime import datetime
from typing import Iterator, Sequence

from predictionio_tpu_torch.core.columns import EventColumns
from predictionio_tpu_torch.core.datamap import PropertyMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage.base import EventFilter, Events
from predictionio_tpu_torch.storage.registry import Storage


class AppNotFoundError(KeyError):
    pass


class EventStore:
    def __init__(self, storage: Storage):
        self.storage = storage

    def app_name_to_id(self, app_name: str,
                       channel_name: str | None = None) -> tuple[int, int | None]:
        app = self.storage.get_meta_data_apps().get_by_name(app_name)
        if app is None:
            raise AppNotFoundError(f"App {app_name!r} does not exist.")
        channel_id = None
        if channel_name is not None:
            channels = self.storage.get_meta_data_channels().get_by_app_id(app.id)
            match = next((c for c in channels if c.name == channel_name), None)
            if match is None:
                raise AppNotFoundError(
                    f"Channel {channel_name!r} does not exist in app {app_name!r}.")
            channel_id = match.id
        return app.id, channel_id

    def find(
        self,
        app_name: str,
        channel_name: str | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None | type(...) = ...,
        target_entity_id: str | None | type(...) = ...,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        """Training-time bulk read of one app (and channel)."""
        app_id, channel_id = self.app_name_to_id(app_name, channel_name)
        return self.storage.get_events().find(
            app_id,
            channel_id,
            EventFilter(
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                limit=limit,
                reversed=reversed,
            ),
        )

    def scan(
        self,
        app_name: str,
        channel_name: str | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None | type(...) = ...,
        target_entity_id: str | None | type(...) = ...,
        limit: int | None = None,
        reversed: bool = False,
        batch_size: int | None = None,
    ) -> Iterator[EventColumns]:
        """:meth:`find` as columnar batches (``core/columns.EventColumns``):
        the same filter, and the batches, concatenated, are exactly the
        events ``find`` returns."""
        app_id, channel_id = self.app_name_to_id(app_name, channel_name)
        return self.storage.get_events().find_columnar(
            app_id,
            channel_id,
            EventFilter(
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                limit=limit,
                reversed=reversed,
            ),
            batch_size=Events.COLUMNAR_BATCH_SIZE if batch_size is None else batch_size,
        )

    def aggregate_properties(
        self,
        app_name: str,
        entity_type: str,
        channel_name: str | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, PropertyMap]:
        """Per-entity properties folded from $set/$unset/$delete events
        (``core/aggregation.py``); ``required`` keeps only entities that
        have every named property."""
        app_id, channel_id = self.app_name_to_id(app_name, channel_name)
        return self.storage.get_events().aggregate_properties(
            app_id, entity_type, channel_id, start_time=start_time, until_time=until_time,
            required=required)

    def find_by_entity(
        self,
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None | type(...) = ...,
        target_entity_id: str | None | type(...) = ...,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        limit: int | None = None,
        latest: bool = True,
    ) -> Iterator[Event]:
        """Serving-time read of one entity's events, newest first unless
        ``latest`` is False."""
        app_id, channel_id = self.app_name_to_id(app_name, channel_name)
        return self.storage.get_events().find_single_entity(
            app_id, entity_type, entity_id, channel_id, event_names=event_names,
            target_entity_type=target_entity_type, target_entity_id=target_entity_id,
            start_time=start_time, until_time=until_time, limit=limit, latest=latest)
