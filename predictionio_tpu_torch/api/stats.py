"""Counters of the two servers (a copy of the JAX package's
``api/stats.py``):

- :class:`ServingStats`: the engine server's hot-path counters (the
  batch-size histogram, dedup, expiries, result-cache hits, misses,
  evictions, expirations and invalidations, ANN queries and rescored
  candidates with the shortlist-width histogram) and the queue-wait and
  device-dispatch histograms, for ``GET /stats.json``;
- :class:`IngestStats`: the event server's ingest path (inserted batch
  sizes, an events/s EWMA, a windowed events/s over complete seconds,
  the storage insert latency);
- :class:`StatsKeeper`: the event server's per-app hourly counts of
  status codes and (entityType, targetEntityType, event) triples
  (``pio eventserver --stats``), kept as the current and the previous
  hour's :class:`Stats`;
- :func:`resilience_snapshot`: the fallback counters of
  ``utils/resilience``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import Counter
from datetime import datetime, timezone

from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.core.json_codec import format_datetime
from predictionio_tpu_torch.core.wire import snake_to_camel
from predictionio_tpu_torch.obs.histogram import LatencyHistogram
from predictionio_tpu_torch.utils.resilience import registry_snapshot


def resilience_snapshot() -> dict:
    """Counters by policy name (``serving/query-batcher``,
    ``serving/reload``); empty until something is counted."""
    return registry_snapshot()


class ServingStats:
    """Counters of the query hot path, written by the batcher's
    dispatcher (batch records), the result cache and handler threads
    (expiries). One lock guards every field at writers and readers."""

    COUNTER_FIELDS = (
        "dispatches", "batched_queries", "deduped", "expired",
        "cache_hits", "cache_misses", "cache_evictions",
        "cache_expirations", "cache_invalidations",
        "cache_user_invalidations",
        "ann_queries", "ann_rescored",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self.COUNTER_FIELDS, 0)
        #: dispatched (deduplicated) batch size -> count
        self._batch_hist: Counter[int] = Counter()
        #: ANN shortlist width (candidates rescored per query, pad
        #: included) -> query count
        self._ann_hist: Counter[int] = Counter()
        #: enqueue → dispatch, per query; ``query_batch`` wall time, per batch
        self.queue_wait = LatencyHistogram()
        self.device_time = LatencyHistogram()

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._counts[field] += n

    def observe_queue_waits(self, waits) -> None:
        """The enqueue → dispatch waits of one batch's queries."""
        self.queue_wait.observe_many(waits)

    def observe_device_time(self, dt: float) -> None:
        """One batch's ``query_batch`` wall time."""
        self.device_time.observe(dt)

    def record_batch(self, dispatched: int, coalesced: int) -> None:
        """One dispatch: ``dispatched`` distinct queries scored,
        ``coalesced`` queries answered by it (more when the dedup pass
        folded identical concurrent queries)."""
        with self._lock:
            self._counts["dispatches"] += 1
            self._counts["batched_queries"] += coalesced
            self._counts["deduped"] += coalesced - dispatched
            self._batch_hist[dispatched] += 1

    def record_ann(self, shortlist_width: int, queries: int = 1) -> None:
        """``queries`` queries answered through the ANN index, each from a
        ``shortlist_width``-candidate rescore (the ALSModel observer)."""
        with self._lock:
            self._counts["ann_queries"] += queries
            self._counts["ann_rescored"] += shortlist_width * queries
            self._ann_hist[shortlist_width] += queries

    def ann_histogram(self) -> dict[int, int]:
        """Shortlist width -> query count."""
        with self._lock:
            return dict(self._ann_hist)

    def count(self, field: str) -> int:
        with self._lock:
            return self._counts[field]

    def raw_counts(self) -> dict[str, int]:
        """Every counter under one lock acquisition (snake_case keys):
        the metric registry's read (obs/registry.serving_collector)."""
        with self._lock:
            return dict(self._counts)

    def batch_histogram(self) -> dict[int, int]:
        """Dispatched batch size -> count."""
        with self._lock:
            return dict(self._batch_hist)

    def snapshot(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            hist = {str(k): v for k, v in sorted(self._batch_hist.items())}
            ann_hist = {str(k): v for k, v in sorted(self._ann_hist.items())}
        hits, misses = counts["cache_hits"], counts["cache_misses"]
        looked = hits + misses
        return {
            **{snake_to_camel(k): v for k, v in counts.items()},
            "batchSizeHistogram": hist,
            "annShortlistHistogram": ann_hist,
            "cacheHitRatio": round(hits / looked, 4) if looked else None,
            "queueWait": self.queue_wait.snapshot().summary_ms(),
            "deviceDispatch": self.device_time.snapshot().summary_ms(),
        }


class IngestStats:
    """Counters for the event server's ingest path, written by the
    request handlers after each successful insert/insert_batch — the
    same one-lock-at-writers-AND-readers discipline as
    :class:`ServingStats`, so a ``GET /stats.json`` reader never sees a
    torn histogram.

    ``events_per_sec_ewma`` smooths the instantaneous batch rate
    (batch size / time since the previous batch) with EWMA_ALPHA.
    Caveat (bench discipline): under a closed-loop load generator the
    EWMA tracks the generator's issue rate, not server capacity — treat
    it as an observability signal, not a benchmark number. The
    windowed rate below does NOT share that bias: a ring of per-second
    monotonic buckets counts what actually landed each wall second, so
    ``eventsPerSecWindowed`` is a true recent-throughput number
    (complete seconds only — the current partial second is excluded so
    a mid-second read never underreports)."""

    EWMA_ALPHA = 0.2
    #: SKIP (not clamp) the EWMA update for gaps below this: two
    #: handler threads landing in the same instant would otherwise
    #: divide by ~zero and fold a meaningless multi-million-events/sec
    #: spike into the average
    _MIN_DT = 1e-6
    #: per-second ring span: the windowed rate covers up to this many
    #: complete seconds (Prometheus-style "last minute" semantics)
    WINDOW_SECONDS = 60

    def __init__(self, clock=None):
        self._now = clock or time.monotonic
        self._lock = threading.Lock()
        self._batches = 0
        self._events = 0
        #: inserted batch size -> count (1 = single-event posts)
        self._batch_hist: Counter[int] = Counter()
        self._last_t: float | None = None
        self._ewma_rate: float | None = None
        #: per-second event counts: slot i holds the count for the
        #: monotonic second recorded in _ring_sec[i]; a slot whose
        #: second moved on is reset lazily at the next write
        self._ring = [0] * self.WINDOW_SECONDS
        self._ring_sec = [-1] * self.WINDOW_SECONDS
        self._first_sec: int | None = None
        #: storage insert/insert_batch walltime (obs/histogram.py;
        #: owns its own lock) — fed by the event server's ingest paths
        self.insert_latency = LatencyHistogram()

    def record_batch(self, n: int) -> None:
        """One successful storage insert of ``n`` events."""
        if n <= 0:
            return
        with self._lock:
            # clock read INSIDE the lock: a thread that read the clock
            # before losing the lock race would otherwise compute a
            # negative-then-clamped dt and spike the EWMA
            now = self._now()
            self._batches += 1
            self._events += n
            self._batch_hist[n] += 1
            sec = int(now)
            idx = sec % self.WINDOW_SECONDS
            if self._ring_sec[idx] != sec:
                self._ring[idx] = 0
                self._ring_sec[idx] = sec
            self._ring[idx] += n
            if self._first_sec is None:
                self._first_sec = sec
            if self._last_t is not None:
                dt = now - self._last_t
                if dt >= self._MIN_DT:
                    inst = n / dt
                    self._ewma_rate = (
                        inst if self._ewma_rate is None
                        else self.EWMA_ALPHA * inst
                        + (1.0 - self.EWMA_ALPHA) * self._ewma_rate)
            self._last_t = now

    def _windowed_rate_locked(self) -> tuple[float | None, int]:
        """(events/sec over complete seconds, window length) — caller
        holds the lock. None until one full second has elapsed."""
        if self._first_sec is None:
            return None, 0
        now_sec = int(self._now())
        # complete seconds only: [now_sec - window, now_sec)
        window = min(self.WINDOW_SECONDS - 1, now_sec - self._first_sec)
        if window <= 0:
            return None, 0
        lo = now_sec - window
        total = sum(
            count
            for count, sec in zip(self._ring, self._ring_sec)
            if lo <= sec < now_sec
        )
        return total / window, window

    def totals(self) -> tuple[int, int]:
        """(batches, events) under one lock (obs/registry.ingest_collector)."""
        with self._lock:
            return self._batches, self._events

    def batch_histogram(self) -> dict[int, int]:
        with self._lock:
            return dict(self._batch_hist)

    def rates(self) -> tuple[float | None, float | None, int]:
        """(ewma, windowed, window_seconds) under one lock."""
        with self._lock:
            windowed, window = self._windowed_rate_locked()
            return self._ewma_rate, windowed, window

    def snapshot(self) -> dict:
        with self._lock:
            batches, events = self._batches, self._events
            hist = {str(k): v for k, v in sorted(self._batch_hist.items())}
            rate = self._ewma_rate
            windowed, window = self._windowed_rate_locked()
        return {
            "batches": batches,
            "events": events,
            "meanBatchSize": round(events / batches, 2) if batches else None,
            "batchSizeHistogram": hist,
            "eventsPerSecEwma": round(rate, 1) if rate is not None else None,
            "eventsPerSecWindowed": (
                round(windowed, 1) if windowed is not None else None),
            "windowSeconds": window,
            "insertLatency": self.insert_latency.snapshot().summary_ms(),
        }


@dataclasses.dataclass(frozen=True)
class EntityTypesEvent:
    """Parity: EntityTypesEvent (Stats.scala:30-39)."""
    entity_type: str
    target_entity_type: str | None
    event: str

    @staticmethod
    def of(e: Event) -> "EntityTypesEvent":
        return EntityTypesEvent(e.entity_type, e.target_entity_type, e.event)


class Stats:
    """One bucket of counts. Parity: Stats (Stats.scala:51-82)."""

    def __init__(self, start_time: datetime):
        self.start_time = start_time
        self.end_time: datetime | None = None
        self.status_code_count: Counter[tuple[int, int]] = Counter()
        self.ete_count: Counter[tuple[int, EntityTypesEvent]] = Counter()

    def cutoff(self, end_time: datetime) -> None:
        self.end_time = end_time

    def update(self, app_id: int, status_code: int, event: Event) -> None:
        self.status_code_count[(app_id, status_code)] += 1
        self.ete_count[(app_id, EntityTypesEvent.of(event))] += 1

    def get(self, app_id: int) -> dict:
        """JSON snapshot for one app (Stats.get -> StatsSnapshot)."""
        return {
            "startTime": format_datetime(self.start_time),
            "endTime": format_datetime(self.end_time) if self.end_time else None,
            "basic": [
                {
                    "key": {
                        "entityType": k[1].entity_type,
                        "targetEntityType": k[1].target_entity_type,
                        "event": k[1].event,
                    },
                    "value": v,
                }
                for k, v in sorted(self.ete_count.items(), key=lambda kv: repr(kv[0]))
                if k[0] == app_id
            ],
            "statusCode": [
                {"key": k[1], "value": v}
                for k, v in sorted(self.status_code_count.items())
                if k[0] == app_id
            ],
        }


def _hour_floor(t: datetime) -> datetime:
    return t.replace(minute=0, second=0, microsecond=0)


class StatsKeeper:
    """Thread-safe hourly rotation: current hour + previous hour.
    Parity: StatsActor's Bookkeeping/GetStats handling."""

    def __init__(self):
        now = datetime.now(timezone.utc)
        self._lock = threading.Lock()
        self._current = Stats(_hour_floor(now))
        self._previous = Stats(_hour_floor(now))

    def _rotate(self, now: datetime) -> None:
        hour = _hour_floor(now)
        if hour > self._current.start_time:
            self._current.cutoff(hour)
            self._previous = self._current
            self._current = Stats(hour)

    def update(self, app_id: int, status_code: int, event: Event) -> None:
        now = datetime.now(timezone.utc)
        with self._lock:
            self._rotate(now)
            self._current.update(app_id, status_code, event)

    def get(self, app_id: int) -> dict:
        """Both buckets, keyed like the reference's Map[String, StatsSnapshot]."""
        with self._lock:
            self._rotate(datetime.now(timezone.utc))
            return {
                "time": format_datetime(datetime.now(timezone.utc)),
                "currentHour": self._current.get(app_id),
                "prevHour": self._previous.get(app_id),
            }
