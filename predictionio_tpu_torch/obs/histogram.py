"""Log-bucketed latency histograms with lock-guarded snapshots (a copy
of the JAX package's ``obs/histogram.py``).

One histogram is a fixed ladder of upper bounds (powers of two from
100 µs to ~13 s) plus a +Inf overflow bucket, a running sum and a count.
``observe`` is one bisect and one lock acquisition; ``snapshot`` reads
everything under the same lock, so a concurrent reader never sees a torn
histogram. Snapshot counts are cumulative (each bucket counts every
observation at or below its bound), which makes a quantile one scan.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Iterable, NamedTuple, Sequence

#: default bucket ladder: powers of two from 100 µs to ~13.1 s (a
#: relative error of at most 2x from sub-ms cache hits to cold batches)
DEFAULT_BOUNDS: tuple[float, ...] = tuple(
    0.0001 * (1 << i) for i in range(18)
)


class HistogramSnapshot(NamedTuple):
    """An atomic view of one histogram (see module docstring)."""

    #: upper bounds, ascending; the implicit +Inf bucket follows
    bounds: tuple[float, ...]
    #: cumulative counts per bound, plus the +Inf total as the last entry
    cumulative: tuple[int, ...]
    #: sum of observed values (seconds)
    sum: float
    #: total observations — always equals ``cumulative[-1]``
    count: int

    def quantile(self, q: float) -> float | None:
        """Upper-bound estimate of the q-quantile (0 < q <= 1): the
        bound of the first bucket whose cumulative count reaches
        q*count. None when empty; the top bound is returned for
        overflow observations (the estimate saturates, it never
        invents a value beyond the ladder)."""
        if self.count == 0:
            return None
        need = q * self.count
        for bound, cum in zip(self.bounds, self.cumulative):
            if cum >= need:
                return bound
        return self.bounds[-1]

    def summary_ms(self) -> dict:
        """Operator-facing summary for the JSON status docs."""
        mean = self.sum / self.count if self.count else None
        to_ms = lambda v: round(v * 1e3, 3) if v is not None else None  # noqa: E731
        return {
            "count": self.count,
            "meanMs": to_ms(mean),
            "p50Ms": to_ms(self.quantile(0.50)),
            "p95Ms": to_ms(self.quantile(0.95)),
            "p99Ms": to_ms(self.quantile(0.99)),
        }


class LatencyHistogram:
    """Thread-safe log-bucketed histogram of seconds (module docstring):
    one lock guards counts, sum and count at writers and readers."""

    __slots__ = ("bounds", "_lock", "_counts", "_sum", "_count")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError("histogram bounds must be ascending and non-empty")
        self.bounds = tuple(float(b) for b in bounds)
        self._lock = threading.Lock()
        # one slot per bound + the +Inf overflow slot
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, seconds: float) -> None:
        idx = bisect_left(self.bounds, seconds)
        with self._lock:
            self._counts[idx] += 1
            self._sum += seconds
            self._count += 1

    def observe_many(self, values: Iterable[float]) -> None:
        """One lock acquisition for a whole batch of samples (the
        batcher records every entry's queue wait in one call)."""
        indexed = [(bisect_left(self.bounds, v), v) for v in values]
        if not indexed:
            return
        with self._lock:
            for idx, v in indexed:
                self._counts[idx] += 1
                self._sum += v
            self._count += len(indexed)

    def snapshot(self) -> HistogramSnapshot:
        with self._lock:
            counts = list(self._counts)
            total_sum = self._sum
            count = self._count
        cumulative: list[int] = []
        running = 0
        for c in counts:
            running += c
            cumulative.append(running)
        return HistogramSnapshot(
            bounds=self.bounds,
            cumulative=tuple(cumulative),
            sum=total_sum,
            count=count,
        )
