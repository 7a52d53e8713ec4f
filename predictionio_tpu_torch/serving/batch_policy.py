"""Load-aware micro-batching policy for the serving query batcher (a
copy of the JAX package's ``serving/batch_policy.py``).

A fixed wait window charges every lone query the full wait and still
under-coalesces under load. The adaptive policy decides per batch,
driven by an EWMA of query inter-arrival time:

- **idle** (arrivals further apart than the max wait): waiting would
  buy no companions — dispatch immediately, near-zero added latency;
- **loaded** (arrivals dense): wait just long enough for the expected
  arrivals to fill the target batch, capped at ``max_wait_ms``.

Target batch sizes snap to the port's power-of-two serving widths
(``ops/topk.BATCH_WIDTHS`` / ``serving_batch``), the sizes sessionrec's
``batch_predict`` splits a batch into, so a target never asks for a
size outside that menu.

The clock is injectable (``utils/resilience.Clock``) so the policy's
tests run on virtual time.
"""

from __future__ import annotations

import threading

from predictionio_tpu_torch.ops.topk import BATCH_WIDTHS, serving_batch
from predictionio_tpu_torch.utils.resilience import SYSTEM_CLOCK, Clock


class BatchPolicy:
    """One decision point per batch: how long to wait, how many to take.

    ``observe_arrival()`` is called by every handler thread at submit
    time; ``plan()`` is called by the dispatcher after it pops a
    batch's first query. Both are lock-guarded — arrivals come from
    many handler threads concurrently.
    """

    def __init__(self, batch_max: int = 64, clock: Clock = SYSTEM_CLOCK,
                 ewma_alpha: float = 0.2):
        # the serving menu tops out at BATCH_WIDTHS[-1]
        self.batch_max = max(1, min(int(batch_max), BATCH_WIDTHS[-1]))
        self._clock = clock
        self._alpha = min(max(ewma_alpha, 0.01), 1.0)
        self._lock = threading.Lock()
        self._last_arrival: float | None = None
        self._ewma_s: float | None = None
        self._last_wait_s = 0.0
        self._last_target = self.batch_max

    def observe_arrival(self) -> None:
        now = self._clock.monotonic()
        with self._lock:
            if self._last_arrival is not None:
                dt = max(0.0, now - self._last_arrival)
                self._ewma_s = (dt if self._ewma_s is None
                                else (1 - self._alpha) * self._ewma_s
                                + self._alpha * dt)
            self._last_arrival = now

    def ewma_interarrival_s(self) -> float | None:
        with self._lock:
            return self._ewma_s

    def plan(self, inflight: int | None = None) -> tuple[float, int]:
        """(wait_seconds, target_batch_size) for the batch being formed.

        ``inflight`` is the number of callers currently blocked in
        ``submit`` (None = unknown): with one in-flight caller no
        companion can possibly arrive during a wait — every other
        client is either absent or already queued — so an adaptive
        policy must not hold the door."""
        raise NotImplementedError

    def _record_plan(self, wait_s: float, target: int) -> None:
        with self._lock:
            self._last_wait_s = wait_s
            self._last_target = target

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "policy": type(self).__name__,
                "batchMax": self.batch_max,
                "ewmaInterarrivalMs": (
                    round(self._ewma_s * 1e3, 4)
                    if self._ewma_s is not None else None),
                "lastWaitMs": round(self._last_wait_s * 1e3, 4),
                "lastTargetBatch": self._last_target,
            }


class FixedBatchPolicy(BatchPolicy):
    """A constant wait window, always aiming for a full batch. Selected
    with ``ServerConfig.batch_policy="fixed"``; ``batch_max=1`` is strict
    per-query dispatch."""

    def __init__(self, batch_max: int = 64, wait_ms: float = 5.0,
                 clock: Clock = SYSTEM_CLOCK):
        super().__init__(batch_max=batch_max, clock=clock)
        self._wait_s = max(0.0, wait_ms) / 1e3

    def plan(self, inflight: int | None = None) -> tuple[float, int]:
        self._record_plan(self._wait_s, self.batch_max)
        return self._wait_s, self.batch_max


class AdaptiveBatchPolicy(BatchPolicy):
    """EWMA-driven wait: expect ``max_wait / ewma`` arrivals in the
    window, target the smallest menu size covering them, and wait only
    as long as filling that target should take.

    With no arrival history (cold start) or a stale/slow EWMA the
    policy chooses zero wait — a lone query after an idle stretch pays
    (near) nothing. ``min_wait_ms`` exists for deployments whose
    arrivals are bursty beyond what the EWMA can see (default 0)."""

    def __init__(self, batch_max: int = 64, max_wait_ms: float = 5.0,
                 min_wait_ms: float = 0.0, clock: Clock = SYSTEM_CLOCK,
                 ewma_alpha: float = 0.2):
        super().__init__(batch_max=batch_max, clock=clock,
                         ewma_alpha=ewma_alpha)
        self._max_wait_s = max(0.0, max_wait_ms) / 1e3
        self._min_wait_s = min(max(0.0, min_wait_ms) / 1e3, self._max_wait_s)

    def plan(self, inflight: int | None = None) -> tuple[float, int]:
        if inflight is not None and inflight <= 1:
            # a lone in-flight caller (single closed-loop client): no
            # companion can arrive while it blocks — the EWMA may look
            # "loaded" (its own steady spacing) but waiting would
            # charge that one client the window for nothing
            self._record_plan(self._min_wait_s, 1)
            return self._min_wait_s, 1
        with self._lock:
            ewma = self._ewma_s
        if ewma is None or self._max_wait_s <= 0.0:
            # cold start: no evidence any companion is coming
            self._record_plan(self._min_wait_s, self.batch_max)
            return self._min_wait_s, self.batch_max
        if ewma >= self._max_wait_s:
            # idle: the next arrival is (in expectation) beyond the
            # longest wait we may charge — dispatch now
            self._record_plan(self._min_wait_s, 1)
            return self._min_wait_s, 1
        # loaded: arrivals expected inside the window (the one in hand
        # included), snapped up to the serving menu
        expected = 1 + int(self._max_wait_s / max(ewma, 1e-9))
        target = min(serving_batch(expected), self.batch_max)
        wait = min(max(ewma * (target - 1), self._min_wait_s),
                   self._max_wait_s)
        self._record_plan(wait, target)
        return wait, target


def make_batch_policy(name: str, batch_max: int, wait_ms: float,
                      clock: Clock = SYSTEM_CLOCK) -> BatchPolicy:
    """Policy factory for ``ServerConfig.batch_policy``: "adaptive"
    (wait_ms is the cap) or "fixed" (wait_ms is the constant window)."""
    if name == "fixed":
        return FixedBatchPolicy(batch_max=batch_max, wait_ms=wait_ms,
                                clock=clock)
    if name == "adaptive":
        return AdaptiveBatchPolicy(batch_max=batch_max, max_wait_ms=wait_ms,
                                   clock=clock)
    raise ValueError(
        f"unknown batch_policy {name!r} (expected 'adaptive' or 'fixed')")
