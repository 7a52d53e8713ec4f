"""Serving counters of the engine server (the part of the JAX package's
``api/stats.py`` the serving layer uses; a copy):

- :class:`ServingStats`: the hot path's counters (the batch-size
  histogram, dedup, expiries, result-cache hits, misses, evictions,
  expirations and invalidations) and the queue-wait and device-dispatch
  histograms, for ``GET /stats.json``;
- :func:`resilience_snapshot`: the fallback counters of
  ``utils/resilience``.

The event server's ``IngestStats`` and per-app ``Stats`` come with
ROADMAP.md queue 1 item 22, the ANN shortlist counters with item 10.
"""

from __future__ import annotations

import threading
from collections import Counter

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
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self.COUNTER_FIELDS, 0)
        #: dispatched (deduplicated) batch size -> count
        self._batch_hist: Counter[int] = Counter()
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

    def count(self, field: str) -> int:
        with self._lock:
            return self._counts[field]

    def batch_histogram(self) -> dict[int, int]:
        """Dispatched batch size -> count."""
        with self._lock:
            return dict(self._batch_hist)

    def snapshot(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            hist = {str(k): v for k, v in sorted(self._batch_hist.items())}
        hits, misses = counts["cache_hits"], counts["cache_misses"]
        looked = hits + misses
        return {
            **{snake_to_camel(k): v for k, v in counts.items()},
            "batchSizeHistogram": hist,
            "cacheHitRatio": round(hits / looked, 4) if looked else None,
            "queueWait": self.queue_wait.snapshot().summary_ms(),
            "deviceDispatch": self.device_time.snapshot().summary_ms(),
        }
