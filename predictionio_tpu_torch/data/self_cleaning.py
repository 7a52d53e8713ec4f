"""SelfCleaningDataSource — prune/compact the event store before training
(a copy of the JAX package's ``data/self_cleaning.py``).

Parity: core/src/main/scala/.../core/SelfCleaningDataSource.scala:42-330:
a DataSource mixin that, given an ``EventWindow``, (1) drops events older
than the window, (2) compacts runs of ``$set`` events per entity into one
merged ``$set``, (3) removes duplicate events, and optionally (4) writes
the cleaned set back to the store (``clean_persisted_events``, the
cleanPersistedPEvents/wipe path :161-233).
"""

from __future__ import annotations

import dataclasses
import logging
from datetime import datetime, timedelta, timezone
from typing import Iterable, Sequence

from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage.registry import Storage

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class EventWindow:
    """Parity: EventWindow (SelfCleaningDataSource.scala:322-330);
    ``duration`` replaces the reference's "3 days"-style string."""

    duration: timedelta | None = None
    remove_duplicates: bool = False
    compress_properties: bool = False


class SelfCleaningDataSource:
    """Mixin for DataSources. Set ``event_window`` (and use
    ``clean_events``/``clean_persisted_events``) to train on a pruned,
    compacted view of the event log."""

    #: override in subclasses (SelfCleaningDataSource.scala:55-62)
    event_window: EventWindow | None = None

    # -- pure transforms ----------------------------------------------------
    def clean_events(
        self,
        events: Iterable[Event],
        now: datetime | None = None,
    ) -> list[Event]:
        """Window filter + compaction + dedup per the EventWindow
        (getCleanedPEvents :77-105)."""
        events = list(events)
        window = self.event_window
        if window is None:
            return events
        if window.duration is not None:
            cutoff = (now or datetime.now(timezone.utc)) - window.duration
            events = [e for e in events if e.event_time >= cutoff]
        if window.compress_properties:
            events = self._compress_properties(events)
        if window.remove_duplicates:
            events = self._remove_duplicates(events)
        return events

    @staticmethod
    def _compress_properties(events: Sequence[Event]) -> list[Event]:
        """Merge each entity's ``$set`` run into one event carrying the
        folded properties (later fields win), stamped with the latest
        event time (compressPProperties :107-126)."""
        sets: dict[tuple[str, str], list[Event]] = {}
        rest: list[Event] = []
        for e in events:
            if e.event == "$set":
                sets.setdefault((e.entity_type, e.entity_id), []).append(e)
            else:
                rest.append(e)
        compressed = []
        for run in sets.values():
            run.sort(key=lambda e: e.event_time)
            merged = run[0].properties
            for e in run[1:]:
                merged = merged.merge(e.properties)
            compressed.append(dataclasses.replace(run[-1], properties=merged))
        return rest + compressed

    @staticmethod
    def _remove_duplicates(events: Sequence[Event]) -> list[Event]:
        """Drop events identical up to identity fields, keeping the first
        (removePDuplicates :128-141)."""
        import json

        seen = set()
        out = []
        for e in events:
            key = (
                e.event, e.entity_type, e.entity_id,
                e.target_entity_type, e.target_entity_id,
                # canonical JSON: property values may be lists/dicts
                json.dumps(e.properties.fields, sort_keys=True, default=str),
                e.event_time,
            )
            if key in seen:
                continue
            seen.add(key)
            out.append(e)
        return out

    # -- persisted cleanup --------------------------------------------------
    def clean_persisted_events(
        self,
        storage: Storage,
        app_id: int,
        channel_id: int | None = None,
        now: datetime | None = None,
    ) -> int:
        """Replace the stored event set with its cleaned form; returns the
        cleaned count (cleanPersistedPEvents + wipe :161-233)."""
        if self.event_window is None:
            return 0
        from predictionio_tpu_torch.storage.base import EventFilter

        events_dao = storage.get_events()
        original = list(events_dao.find(app_id, channel_id, EventFilter()))
        cleaned = self.clean_events(original, now=now)
        if len(cleaned) == len(original):
            return len(cleaned)
        events_dao.remove(app_id, channel_id)
        events_dao.init(app_id, channel_id)
        if cleaned:
            events_dao.insert_batch(cleaned, app_id, channel_id)
        logger.info(
            "cleaned persisted events for app %s: %d -> %d",
            app_id, len(original), len(cleaned),
        )
        return len(cleaned)
