"""Legacy batch-view helpers (deprecated in the reference, kept for
parity; a copy of the JAX package's ``data/view.py``).

Parity: data/src/main/scala/.../data/view/{LBatchView.scala,
PBatchView.scala, DataView.scala} — predicate-combinator queries over an
event batch: filter chains, property aggregation to a point in time, and
fold/group reductions. The reference deprecated these in favor of
PEventStore; this module exists so users migrating view-based engines
have a drop-in, but new code should use EventStore + the Preparator.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import logging
import os
import warnings
from datetime import datetime
from typing import Any, Callable, Iterable, TypeVar

from predictionio_tpu_torch.core.aggregation import aggregate_properties
from predictionio_tpu_torch.core.datamap import DataMap, PropertyMap
from predictionio_tpu_torch.core.event import Event

T = TypeVar("T")
logger = logging.getLogger(__name__)


def data_map_aggregator() -> Callable[[DataMap | None, Event], DataMap | None]:
    """The $set/$unset/$delete step function over an optional DataMap —
    ViewAggregators.getDataMapAggregator (LBatchView.scala:77-101)."""

    def op(acc: DataMap | None, e: Event) -> DataMap | None:
        if e.event == "$set":
            return e.properties if acc is None else acc + e.properties
        if e.event == "$unset":
            return None if acc is None else acc - e.properties.keys()
        if e.event == "$delete":
            return None
        return acc

    return op


class BatchView:
    """An in-memory event batch with combinator queries.

    Parity: LBatchView.LEventStore/ViewPredicates (LBatchView.scala:33+).
    """

    def __init__(self, events: Iterable[Event], _warned: bool = False):
        if not _warned:
            warnings.warn(
                "BatchView is a legacy API (deprecated in the reference); "
                "use EventStore.find/aggregate_properties",
                DeprecationWarning,
                stacklevel=2,
            )
        self._events = list(events)

    # -- predicates (ViewPredicates parity) ---------------------------------
    def filter(self, predicate: Callable[[Event], bool]) -> "BatchView":
        return BatchView((e for e in self._events if predicate(e)), _warned=True)

    def filter_by(
        self,
        event: str | None = None,
        entity_type: str | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
    ) -> "BatchView":
        """Keyword-predicate filter — EventSeq.filter(eventOpt,
        entityTypeOpt, startTimeOpt, untilTimeOpt) (LBatchView.scala:
        117-128); ``None`` matches everything, times are [start, until)."""
        return self.filter(
            lambda e: (event is None or e.event == event)
            and (entity_type is None or e.entity_type == entity_type)
            and (start_time is None or e.event_time >= start_time)
            and (until_time is None or e.event_time < until_time)
        )

    def event_name(self, name: str) -> "BatchView":
        return self.filter(lambda e: e.event == name)

    def entity_type(self, entity_type: str) -> "BatchView":
        return self.filter(lambda e: e.entity_type == entity_type)

    def before(self, t: datetime) -> "BatchView":
        return self.filter(lambda e: e.event_time < t)

    def after(self, t: datetime) -> "BatchView":
        return self.filter(lambda e: e.event_time >= t)

    # -- terminal operations ------------------------------------------------
    def events(self) -> list[Event]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def aggregate_properties(
        self, entity_type: str, until_time: datetime | None = None
    ) -> dict[str, PropertyMap]:
        """$set/$unset/$delete fold per entity, optionally up to a point in
        time (LBatchView.aggregateProperties parity)."""
        selected = (
            e for e in self._events
            if e.entity_type == entity_type
            and (until_time is None or e.event_time < until_time)
        )
        return aggregate_properties(selected)

    def group_by_entity(self) -> dict[tuple[str, str], list[Event]]:
        out: dict[tuple[str, str], list[Event]] = {}
        for e in self._events:
            out.setdefault((e.entity_type, e.entity_id), []).append(e)
        return out

    def fold(self, init: T, op: Callable[[T, Event], T]) -> T:
        acc = init
        for e in self._events:
            acc = op(acc, e)
        return acc

    def aggregate_by_entity_ordered(
        self, init: T, op: Callable[[T, Event], T]
    ) -> dict[str, T]:
        """Per-entityId time-ordered fold — EventSeq.
        aggregateByEntityOrdered (LBatchView.scala:134-140): group by
        entity id, sort each group by event time, foldLeft with ``op``."""
        groups: dict[str, list[Event]] = {}
        for e in self._events:
            groups.setdefault(e.entity_id, []).append(e)
        out: dict[str, T] = {}
        for entity_id, evs in groups.items():
            acc = init
            for e in sorted(evs, key=lambda e: e.event_time):
                acc = op(acc, e)
            out[entity_id] = acc
        return out


def create_data_view(
    app_name: str,
    conversion: Callable[[Event], Any | None],
    *,
    name: str = "",
    version: str = "",
    channel_name: str | None = None,
    start_time: datetime | None = None,
    until_time: datetime | None = None,
    storage=None,
    base_dir: str | None = None,
):
    """Cached columnar view of converted events — DataView.create
    (DataView.scala:61-112): read events, map each through
    ``conversion`` (``None`` results are dropped), persist the result as
    a Parquet file fingerprinted by (time range, ``version``, and the
    conversion function's source), and return the cached
    ``pyarrow.Table`` on later calls.

    ``conversion`` may return a dataclass, mapping, or tuple; rows must
    be homogeneous. Divergence from the reference: DataView.scala keys
    the cache on ``DateTime.now()`` when ``untilTime`` is absent, so its
    cache can never hit; here an absent ``until_time`` simply bypasses
    the cache (fresh read every call) and caching requires an explicit,
    stable ``until_time``. The conversion fingerprint uses the
    function's source text (via inspect) where Scala used the case
    class serialVersionUID."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from predictionio_tpu_torch.data.store import EventStore

    store = EventStore(storage) if storage is not None else EventStore()

    cache_path = None
    if until_time is not None:
        try:
            src = inspect.getsource(conversion)
        except (OSError, TypeError):
            # source unavailable (REPL/stdin/builtin): key on the stable
            # qualified name — never repr(), whose memory address would
            # defeat the cache across processes
            src = (f"{getattr(conversion, '__module__', '?')}."
                   f"{getattr(conversion, '__qualname__', repr(type(conversion)))}")
        key = hashlib.md5(
            f"{channel_name}-{start_time}-{until_time}-{version}-{src}".encode()
        ).hexdigest()[:16]
        base = base_dir or os.path.join(
            os.environ.get("PIO_FS_BASEDIR",
                           os.path.expanduser("~/.pio_store")), "view")
        cache_path = os.path.join(base, f"{name}-{app_name}-{key}.parquet")
        if os.path.exists(cache_path):
            return pq.read_table(cache_path)
        logger.info("cached copy not found, reading from the event store")

    # stream the event scan into per-chunk record batches (the columnar
    # scan underneath bounds what is resident: one EventColumns batch +
    # one converted chunk, never the whole result set as a Python list)
    batches: list[pa.RecordBatch] = []
    for cols in store.scan(app_name, channel_name=channel_name,
                           start_time=start_time, until_time=until_time):
        chunk = []
        for e in cols.to_events():
            row = conversion(e)
            if row is None:
                continue
            if dataclasses.is_dataclass(row):
                row = dataclasses.asdict(row)
            elif not isinstance(row, dict):
                row = {f"f{i}": v for i, v in enumerate(row)}
            chunk.append(row)
        if chunk:
            batches.append(pa.RecordBatch.from_pylist(chunk))
    if not batches:
        table = pa.Table.from_pylist([])
    else:
        # per-chunk inferred schemas can disagree (ints then floats);
        # promoted concat unifies them the way one global from_pylist did
        tables = [pa.Table.from_batches([b]) for b in batches]
        try:
            table = pa.concat_tables(tables, promote_options="permissive")
        except TypeError:
            # pyarrow < 14 spells type promotion promote=True (the
            # parquet extra does not pin a floor)
            table = pa.concat_tables(tables, promote=True)
    if cache_path is not None:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        tmp = f"{cache_path}.tmp.{os.getpid()}"
        pq.write_table(table, tmp)
        os.replace(tmp, cache_path)
        return pq.read_table(cache_path)
    return table
