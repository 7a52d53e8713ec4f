"""Event-store tail follower: resumable ``find_columnar`` reads from a
durable ``(eventTime, id)`` cursor (port of the JAX package's
``online/follower.py``, over the port's storage).

Every backend's ``find``/``find_columnar`` yields one total order,
ascending ``(eventTime, id)``, so a consumer that remembers the last row
it consumed resumes exactly after it: re-read from the cursor's event
time (inclusive) and drop rows whose order key is not strictly greater
than the cursor's. ``Events.CURSOR_TIME_RESOLUTION_US`` names the
granularity a backend orders at (µs for sqlite and memory, ms for the
binary log), so the comparison mirrors the backend's own sort key.

No skipped event and no duplicate: the contract the fold-in loop stands
on (a duplicate is harmless, since fold-in recomputes from the full
history, but a skip loses a rating).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Iterator

import numpy as np

from predictionio_tpu_torch.core.columns import us_to_datetime
from predictionio_tpu_torch.storage.base import EventFilter, Events

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TailCursor:
    """The last-consumed row's position in the backend's
    ``(eventTime, id)`` total order: µs-exact event time + event id."""

    time_us: int
    event_id: str

    def key(self, resolution_us: int = 1) -> tuple[int, str]:
        """The comparison key at the backend's ordering granularity."""
        return (self.time_us // max(1, resolution_us), self.event_id)

    def to_doc(self) -> list:
        return [int(self.time_us), self.event_id]

    @staticmethod
    def from_doc(doc: Any) -> "TailCursor | None":
        """A cursor from its JSON spelling; None for junk (a torn or
        hand-edited file degrades to "no cursor", never a crash)."""
        if (isinstance(doc, (list, tuple)) and len(doc) == 2
                and isinstance(doc[0], int) and isinstance(doc[1], str)):
            return TailCursor(time_us=doc[0], event_id=doc[1])
        return None


class CursorStore:
    """Durable cursor persistence: one JSON file, committed with the
    tmp+fsync+``os.replace`` discipline (the WAL cursor's idiom) so a
    crash never leaves a torn cursor. ``path=None`` keeps the cursor
    in memory only — a restart re-tails from its initial position,
    which is CORRECT (fold-in is idempotent) just wasteful."""

    def __init__(self, path: str | None):
        self.path = path
        self._memory: TailCursor | None = None

    def load(self) -> TailCursor | None:
        if self.path is None:
            return self._memory
        try:
            with open(self.path) as f:
                return TailCursor.from_doc(json.load(f))
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return None

    def save(self, cursor: TailCursor) -> None:
        self._memory = cursor
        if self.path is None:
            return
        tmp = f"{self.path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(cursor.to_doc(), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError:
            # a read-only/full state dir degrades durability, not
            # correctness: the in-memory cursor keeps this process
            # exactly-once; only a restart re-reads the tail
            logger.warning("could not persist tail cursor to %s",
                           self.path, exc_info=True)


def cursor_resolution_us(events: Any) -> int:
    """The granularity ``events`` orders ties at (class attribute on
    the DAO; proxied backends — chaos — pass it through)."""
    return int(getattr(events, "CURSOR_TIME_RESOLUTION_US", 1))


def resume_columnar(
    events: Any,
    app_id: int,
    channel_id: int | None = None,
    filter: EventFilter = EventFilter(),
    cursor: TailCursor | None = None,
    batch_size: int = Events.COLUMNAR_BATCH_SIZE,
) -> Iterator[tuple[Any, np.ndarray]]:
    """``find_columnar`` resumed strictly after ``cursor``: yields
    ``(EventColumns, surviving_row_indices)`` pairs. Concatenating the
    surviving rows reproduces exactly the suffix of the full ``find``
    sequence that follows the cursor row — no skip, no duplicate
    (module docstring).

    The resume is defined only for the forward unlimited scan the tail
    consumes: ``reversed`` or ``limit`` filters raise (a limited or
    descending read has no meaningful "after the cursor" suffix)."""
    if filter.reversed or filter.limit is not None:
        raise ValueError(
            "cursor resume is defined for forward unlimited scans only")
    if cursor is None:
        for cols in events.find_columnar(app_id, channel_id, filter,
                                         batch_size=batch_size):
            yield cols, np.arange(len(cols))
        return
    res = cursor_resolution_us(events)
    cursor_t, cursor_id = cursor.key(res)
    # re-read from the cursor's ORDER-KEY time (inclusive: equal-time
    # rows with a greater id are still pending) and drop everything at
    # or before the cursor key
    floor = us_to_datetime(cursor_t * res)
    start = (max(filter.start_time, floor)
             if filter.start_time is not None else floor)
    flt = dataclasses.replace(filter, start_time=start)
    for cols in events.find_columnar(app_id, channel_id, flt,
                                     batch_size=batch_size):
        t = cols.event_time_us // res
        after = t > cursor_t
        tied = t == cursor_t
        if tied.any():
            ids_after = np.fromiter(
                ((eid or "") > cursor_id for eid in cols.event_ids),
                dtype=bool, count=len(cols))
            after = after | (tied & ids_after)
        idx = np.nonzero(after)[0]
        if len(idx):
            yield cols, idx


@dataclasses.dataclass(frozen=True)
class TailRow:
    """One tailed event, flattened to what the fold-in consumes."""

    event: str
    entity_id: str
    target_entity_id: str | None
    time_us: int
    event_id: str
    properties: dict


class EventTailFollower:
    """A stateful tail over one app's event stream.

    ``poll_once()`` reads everything past the current cursor and
    returns ``(rows, new_cursor)`` WITHOUT advancing — the caller
    commits via :meth:`commit` only after the rows were applied
    downstream, so a crash between read and apply replays (at-least-
    once into an idempotent fold)."""

    def __init__(self, events: Any, app_id: int,
                 channel_id: int | None = None,
                 filter: EventFilter = EventFilter(),
                 store: CursorStore | None = None,
                 batch_size: int = Events.COLUMNAR_BATCH_SIZE,
                 max_rows: int = 20_000):
        self.events = events
        self.app_id = app_id
        self.channel_id = channel_id
        self.filter = filter
        self.store = store or CursorStore(None)
        self.batch_size = batch_size
        #: per-poll backlog cap: a leader resuming a durable cursor
        #: after a long stop must not materialize the whole backlog in
        #: one pass — the poll stops at the cap, the cursor lands on
        #: the last row CONSUMED, and the next cycle continues exactly
        #: where this one stopped (still exactly-once, just paged)
        self.max_rows = max(1, int(max_rows))
        self.cursor = self.store.load()

    def poll_once(self) -> tuple[list[TailRow], TailCursor | None]:
        rows: list[TailRow] = []
        last: TailCursor | None = None
        for cols, idx in resume_columnar(
                self.events, self.app_id, self.channel_id, self.filter,
                cursor=self.cursor, batch_size=self.batch_size):
            if len(rows) + len(idx) > self.max_rows:
                idx = idx[: self.max_rows - len(rows)]
            names = cols.event.decode()
            eids = cols.entity_id.decode()
            targets = cols.target_entity_id.decode()
            for i in idx:
                i = int(i)
                rows.append(TailRow(
                    event=names[i],
                    entity_id=eids[i],
                    target_entity_id=targets[i],
                    time_us=int(cols.event_time_us[i]),
                    event_id=cols.event_ids[i] or "",
                    properties=cols.properties_raw(i),
                ))
            if len(idx):
                tail = int(idx[-1])
                last = TailCursor(int(cols.event_time_us[tail]),
                                  cols.event_ids[tail] or "")
            if len(rows) >= self.max_rows:
                break
        return rows, (last or self.cursor)

    def commit(self, cursor: TailCursor | None) -> None:
        """Advance + persist — call only after the polled rows were
        applied (at-least-once contract in the class docstring)."""
        if cursor is None:
            return
        # pio: lint-ignore[shared-state-race]: cursor is an immutable TailCursor swapped by reference on the fold thread; the status-doc read tolerates staleness
        self.cursor = cursor
        self.store.save(cursor)
