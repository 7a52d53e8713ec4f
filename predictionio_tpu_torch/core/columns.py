"""EventColumns — struct-of-arrays event batches for the columnar data plane
(a copy of the JAX package's ``core/columns.py``, which holds no device
code; the port keeps its own so that it imports nothing of that package).

The reference amortized training-time event scans across a Spark
cluster (PEvents' RDD reads); the equivalent lever here is trading
per-event Python objects for numpy columns. ``Events.find_columnar``
(storage/base.py) yields these batches; the train path consumes them
through ``EventStore.scan`` (data/store.py) so events land in the
padded jit-ready arrays without a per-event Python loop.

Layout per batch of ``n`` events:

- ``event_time_us`` — int64 epoch-microseconds (exact: datetime
  resolution is µs, so the int64 column round-trips losslessly);
- ``event``, ``entity_type``, ``entity_id``, ``target_entity_type``,
  ``target_entity_id`` — dictionary-encoded :class:`DictColumn`
  (int32 codes + string vocab; ``None`` is a vocab entry, so optional
  columns need no separate mask);
- ``event_ids`` — plain tuple (ids are unique, dictionary encoding
  would only add indirection);
- everything else (properties, tags, prId, creationTime) — a LAZY
  row-payload column: the backend hands over whatever cheap per-row
  representation it already holds (Event objects for the in-memory
  store, raw JSON strings for SQL rows) and decoding happens only for
  the rows a consumer
  actually touches. Scans that never read properties never parse them.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from datetime import datetime, timedelta, timezone
from typing import Any, Iterable, Sequence

import numpy as np

from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.core.json_codec import parse_datetime

_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)


def datetime_to_us(t: datetime) -> int:
    """Exact microseconds since epoch."""
    delta = t - _EPOCH
    return (delta.days * 86_400 + delta.seconds) * 1_000_000 + delta.microseconds


def us_to_datetime(us: int) -> datetime:
    """Inverse of :func:`datetime_to_us`, exact (no float round-trip)."""
    return _EPOCH + timedelta(microseconds=int(us))


class DictColumn:
    """Dictionary-encoded string column: int32 codes into a small vocab.

    Event-name/entity-type/entity-id columns are low-cardinality, so the
    string work is O(vocab) instead of O(events); ``decode()`` expands
    to an object array for vectorized consumers (numpy fancy-indexing,
    one C loop)."""

    __slots__ = ("codes", "vocab")

    def __init__(self, codes: np.ndarray, vocab: Sequence[str | None]):
        self.codes = np.asarray(codes, dtype=np.int32)
        self.vocab = tuple(vocab)

    def __len__(self) -> int:
        return len(self.codes)

    def decode(self) -> np.ndarray:
        """codes -> object array of strings (or None)."""
        return np.asarray(self.vocab, dtype=object)[self.codes]

    def __getitem__(self, i: int) -> str | None:
        return self.vocab[self.codes[i]]

    def code_of(self, value: str | None) -> int | None:
        """The code for ``value`` in this batch's vocab, or None when the
        value never occurs (lets consumers compare int codes, not strings)."""
        try:
            return self.vocab.index(value)
        except ValueError:
            return None


def encode_column(values: Sequence[str | None]) -> DictColumn:
    """Dictionary-encode one column at C speed: ``dict.fromkeys`` builds
    the order-preserving vocab in a single C call, and the codes come
    from mapping the C-level ``dict.__getitem__`` under ``np.fromiter``
    — no per-value Python frame (a method-per-value encoder measured
    ~3x slower on the sqlite scan)."""
    index = {v: i for i, v in enumerate(dict.fromkeys(values))}
    codes = np.fromiter(map(index.__getitem__, values), dtype=np.int32,
                        count=len(values))
    return DictColumn(codes, list(index))


# ---------------------------------------------------------------------------
# Lazy row payloads: the cold fields, decoded per row on demand
# ---------------------------------------------------------------------------

class _EventRows:
    """Cold fields backed by already-materialized Event objects (the
    in-memory store and the generic rows->columns fallback)."""

    __slots__ = ("events",)

    def __init__(self, events: Sequence[Event]):
        self.events = events

    def properties(self, i: int) -> DataMap:
        return self.events[i].properties

    def properties_raw(self, i: int) -> dict:
        return self.events[i].properties.fields

    def tags(self, i: int) -> tuple[str, ...]:
        return tuple(self.events[i].tags)

    def pr_id(self, i: int) -> str | None:
        return self.events[i].pr_id

    def creation_time(self, i: int) -> datetime:
        return self.events[i].creation_time


class _JsonRows:
    """Cold fields as raw SQL columns (properties/tags as the JSON text
    the row already carries, creationTime as its stored text — all
    parsed only when asked; a scan that never materializes Events never
    pays any of it)."""

    __slots__ = ("props_json", "tags_json", "pr_ids", "creation_raw")

    def __init__(self, props_json: Sequence[str | None],
                 tags_json: Sequence[str | None],
                 pr_ids: Sequence[str | None],
                 creation_raw: Sequence[str]):
        self.props_json = props_json
        self.tags_json = tags_json
        self.pr_ids = pr_ids
        self.creation_raw = creation_raw

    def properties(self, i: int) -> DataMap:
        raw = self.props_json[i]
        return DataMap.from_json(json.loads(raw)) if raw else DataMap()

    def properties_raw(self, i: int) -> dict:
        raw = self.props_json[i]
        return json.loads(raw) if raw else {}

    def tags(self, i: int) -> tuple[str, ...]:
        raw = self.tags_json[i]
        return tuple(json.loads(raw)) if raw else ()

    def pr_id(self, i: int) -> str | None:
        return self.pr_ids[i]

    def creation_time(self, i: int) -> datetime:
        return parse_datetime(self.creation_raw[i])


class _EventJsonRows:
    """Cold fields inside full event-JSON payloads (the binevents frame
    carries the filterable fields in binary and the rest as one JSON
    blob; a scan that never touches properties never parses it)."""

    __slots__ = ("payloads", "_cache")

    def __init__(self, payloads: Sequence[bytes | str]):
        self.payloads = payloads
        self._cache: dict[int, dict] = {}

    def _doc(self, i: int) -> dict:
        doc = self._cache.get(i)
        if doc is None:
            doc = self._cache[i] = json.loads(self.payloads[i])
        return doc

    def properties(self, i: int) -> DataMap:
        return DataMap.from_json(self._doc(i).get("properties") or {})

    def properties_raw(self, i: int) -> dict:
        return self._doc(i).get("properties") or {}

    def tags(self, i: int) -> tuple[str, ...]:
        return tuple(self._doc(i).get("tags") or ())

    def pr_id(self, i: int) -> str | None:
        return self._doc(i).get("prId")

    def creation_time(self, i: int) -> datetime:
        raw = self._doc(i).get("creationTime")
        return parse_datetime(raw) if raw else us_to_datetime(0)

    def event_time(self, i: int) -> datetime:
        """Payload eventTime — the wire format truncates to
        milliseconds, and materialized Events must match what the row
        path (``find``) returns; the µs-exact instant stays in the
        batch's ``event_time_us`` column."""
        return parse_datetime(self._doc(i)["eventTime"])


# ---------------------------------------------------------------------------
# The batch type
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EventColumns:
    """One struct-of-arrays batch of events (module docstring has the
    layout). Row order is the backend's ``find`` order for the same
    filter — the columnar/row conformance checks pin that equivalence
    for every backend (tests/test_torch_storage.py)."""

    event_time_us: np.ndarray          # int64[n]
    event: DictColumn
    entity_type: DictColumn
    entity_id: DictColumn
    target_entity_type: DictColumn
    target_entity_id: DictColumn
    event_ids: tuple[str | None, ...]
    _rows: Any                         # lazy cold-field provider

    def __len__(self) -> int:
        return len(self.event_time_us)

    # -- vectorized accessors ------------------------------------------------
    def event_times(self) -> np.ndarray:
        """int64 epoch-micros (the canonical time column)."""
        return self.event_time_us

    def properties(self, i: int) -> DataMap:
        """Row ``i``'s properties, decoded on demand."""
        return self._rows.properties(i)

    def properties_raw(self, i: int) -> dict:
        """Row ``i``'s properties as the plain decoded-JSON mapping —
        the hot-path accessor: no DataMap wrapping, no per-value
        conversion pass; use :meth:`properties` when DataMap semantics
        (typed getters, datetime revival) matter."""
        return self._rows.properties_raw(i)

    # -- materialization -----------------------------------------------------
    def to_events(self) -> list[Event]:
        """Materialize Event objects (the row-path escape hatch; batch
        consumers should read the arrays instead)."""
        if isinstance(self._rows, _EventRows):
            # the batch was built FROM these Events — hand them back
            # instead of reconstructing field-identical copies
            return list(self._rows.events)
        ev_names = self.event.decode()
        etypes = self.entity_type.decode()
        eids = self.entity_id.decode()
        tets = self.target_entity_type.decode()
        teis = self.target_entity_id.decode()
        rows = self._rows
        # a provider whose payload carries its own event-time spelling
        # (the binary log's ms-truncated wire JSON) overrides the column,
        # so materialized Events match find() exactly
        row_time = getattr(rows, "event_time", None)
        return [
            Event(
                event=ev_names[i],
                entity_type=etypes[i],
                entity_id=eids[i],
                target_entity_type=tets[i],
                target_entity_id=teis[i],
                properties=rows.properties(i),
                event_time=(row_time(i) if row_time is not None
                            else us_to_datetime(self.event_time_us[i])),
                tags=rows.tags(i),
                pr_id=rows.pr_id(i),
                creation_time=rows.creation_time(i),
                event_id=self.event_ids[i],
            )
            for i in range(len(self))
        ]

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_events(events: Sequence[Event]) -> "EventColumns":
        """Single-pass rows->columns build (the generic fallback every
        backend inherits, and the in-memory store's native path). One
        list comprehension per column + the C-speed encoder — not one
        Python loop doing six things per event."""
        events = events if isinstance(events, (list, tuple)) else list(events)
        n = len(events)
        times = np.fromiter(
            (datetime_to_us(e.event_time) for e in events),
            dtype=np.int64, count=n)
        return EventColumns(
            event_time_us=times,
            event=encode_column([e.event for e in events]),
            entity_type=encode_column([e.entity_type for e in events]),
            entity_id=encode_column([e.entity_id for e in events]),
            target_entity_type=encode_column(
                [e.target_entity_type for e in events]),
            target_entity_id=encode_column(
                [e.target_entity_id for e in events]),
            event_ids=tuple(e.event_id for e in events),
            _rows=_EventRows(events),
        )

    @staticmethod
    def from_sql_columns(times_us: np.ndarray,
                         event: DictColumn, entity_type: DictColumn,
                         entity_id: DictColumn, target_entity_type: DictColumn,
                         target_entity_id: DictColumn,
                         event_ids: Sequence[str | None],
                         props_json: Sequence[str | None],
                         tags_json: Sequence[str | None],
                         pr_ids: Sequence[str | None],
                         creation_raw: Sequence[str]) -> "EventColumns":
        """SQL rows already split into columns; properties/tags stay the
        raw JSON text of the row (the lazy JSON column) and
        creationTime stays its stored text — only event_time is eager
        (it is the hot column scans sort and range-filter on)."""
        return EventColumns(
            event_time_us=np.asarray(times_us, dtype=np.int64),
            event=event, entity_type=entity_type, entity_id=entity_id,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            event_ids=tuple(event_ids),
            _rows=_JsonRows(props_json, tags_json, pr_ids, creation_raw),
        )


    @staticmethod
    def from_event_json(times_us: np.ndarray,
                        event: DictColumn, entity_type: DictColumn,
                        entity_id: DictColumn, target_entity_type: DictColumn,
                        target_entity_id: DictColumn,
                        event_ids: Sequence[str | None],
                        payloads: Sequence[bytes | str]) -> "EventColumns":
        """Binary-log frames: hot fields decoded straight from the frame
        header, cold fields left inside the event-JSON payload."""
        return EventColumns(
            event_time_us=np.asarray(times_us, dtype=np.int64),
            event=event, entity_type=entity_type, entity_id=entity_id,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            event_ids=tuple(event_ids),
            _rows=_EventJsonRows(payloads),
        )


def check_batch_size(batch_size: int) -> None:
    """Eager validation shared by every find_columnar implementation:
    those are generator functions, so an in-body check would only fire
    at first iteration — far from the misconfigured call site."""
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")


def iter_batches(events: Iterable[Event], batch_size: int):
    """Chunk an event iterator into EventColumns batches (the generic
    rows->columns fallback; storage/base.py wires it as the default
    ``find_columnar``)."""
    check_batch_size(batch_size)
    return _iter_batches(events, batch_size)


def _iter_batches(events: Iterable[Event], batch_size: int):
    it = iter(events)
    while True:
        chunk = list(itertools.islice(it, batch_size))
        if not chunk:
            return
        yield EventColumns.from_events(chunk)
