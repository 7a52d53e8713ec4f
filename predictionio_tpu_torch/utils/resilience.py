"""The part of the JAX package's ``utils/resilience.py`` that the engine
server's serving layer uses (a copy; the port imports nothing of that
package):

- :class:`Clock` / :class:`ManualClock`: an injectable time source, so
  the batch policy, the result caches and the worker supervisor run on
  virtual time in tests;
- :class:`TransientError`: the base of failures worth retrying, which
  the loopback transport of the worker pool raises
  (``fleet/transport.UpstreamProtocolError``);
- :class:`StorageUnavailableError` and :data:`STORAGE_UNAVAILABLE_ERRORS`:
  what the serving plane answers with ``503`` + ``Retry-After``;
- :func:`deadline_scope` / :func:`remaining_deadline`: the per-request
  deadline, carried into the micro-batcher;
- :class:`RetryPolicy`: the delays of exponential backoff with jitter
  (the server's bind retry);
- :func:`record_fallback` / :func:`registry_snapshot`: counters of
  graceful-degradation events (a failed batch retried query by query, a
  failed ``/reload``), in the shape ``GET /stats.json`` shows under
  ``resilience``.

The circuit breaker, the ``resilient`` call wrapper and the storage
backends wrapped in them stay with the router tier (ROADMAP.md queue 1
item 23).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import random
import threading
import time
from typing import Any


class Clock:
    """Injectable time source; production uses :data:`SYSTEM_CLOCK`."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


SYSTEM_CLOCK = Clock()


class ManualClock(Clock):
    """Deterministic clock for tests: ``sleep`` advances virtual time at
    once (each call recorded in ``slept``), ``advance`` moves it."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._lock = threading.Lock()
        self.slept: list[float] = []

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self._now += max(0.0, seconds)
            self.slept.append(seconds)

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds


class TransientError(Exception):
    """Marker for failures worth retrying (connection refused, a
    malformed upstream answer): raised at a network boundary, so the
    caller's policy never guesses from library-specific types."""


class StorageUnavailableError(ConnectionError):
    """A backend stayed unreachable. The serving plane maps this class of
    failure to ``503`` + ``Retry-After``."""

    def __init__(self, name: str, message: str, retry_after: float = 1.0):
        super().__init__(f"storage backend {name!r} unavailable: {message}")
        self.name = name
        self.retry_after = retry_after


#: what the serving plane treats as "backend down → 503"
STORAGE_UNAVAILABLE_ERRORS: tuple[type[BaseException], ...] = (
    StorageUnavailableError, ConnectionError, TimeoutError,
)


def retry_after_hint(exc: BaseException, default: float = 1.0) -> float:
    """Seconds a client should wait before retrying after ``exc``,
    floored at ``default``."""
    hint = getattr(exc, "retry_after", None)
    if isinstance(hint, (int, float)) and hint > 0:
        return max(default, float(hint))
    return default


_DEADLINE: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "pio_request_deadline", default=None)


@contextlib.contextmanager
def deadline_scope(budget_seconds: float):
    """Set the ambient per-request deadline for the enclosed work. Nested
    scopes only shrink it."""
    new = time.monotonic() + max(0.0, budget_seconds)
    current = _DEADLINE.get()
    token = _DEADLINE.set(min(new, current) if current is not None else new)
    try:
        yield
    finally:
        _DEADLINE.reset(token)


def remaining_deadline() -> float | None:
    """Seconds left in the ambient request deadline (None: no deadline)."""
    deadline = _DEADLINE.get()
    if deadline is None:
        return None
    return max(0.0, deadline - time.monotonic())


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter:
    ``delay(n) = uniform(floor·cap, cap)``, ``cap = min(max_delay,
    base_delay · multiplier**n)`` for 0-based retry index ``n``. The
    JAX package's attempt count and total deadline come with the
    ``resilient`` wrapper (item 23)."""

    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: bool = True
    #: lower bound of the jitter window as a fraction of the cap: 0.0 is
    #: full jitter, 0.5 "equal jitter" (a guaranteed minimum wait)
    jitter_floor: float = 0.0

    def backoff(self, retry_index: int, rng: random.Random) -> float:
        """Delay before retry number ``retry_index`` (0-based)."""
        cap = min(self.max_delay, self.base_delay * (self.multiplier ** retry_index))
        if not self.jitter:
            return cap
        return rng.uniform(cap * min(max(self.jitter_floor, 0.0), 1.0), cap)


class ResilienceMetrics:
    """Lock-guarded counters for one named policy."""

    FIELDS = ("calls", "attempts", "retries", "failures",
              "short_circuits", "unavailable", "fallbacks")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self.FIELDS, 0)

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._counts[field] += n

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


class Resilience:
    """A named counter set in the registry. In the JAX package it also
    wraps calls in a retry policy and a breaker (item 23); here it is
    the counter-only entry that :func:`record_fallback` registers."""

    def __init__(self, name: str):
        self.name = name
        self.metrics = ResilienceMetrics()

    def snapshot(self) -> dict[str, Any]:
        return self.metrics.snapshot()


_REGISTRY: dict[str, Resilience] = {}
_REGISTRY_LOCK = threading.Lock()


def record_fallback(name: str) -> None:
    """Count a graceful-degradation fallback under ``name``: the query
    batcher retrying a failed batch query by query, or ``/reload``
    keeping the last-known-good model."""
    with _REGISTRY_LOCK:
        r = _REGISTRY.get(name)
        if r is None:
            r = _REGISTRY[name] = Resilience(name)
    r.metrics.bump("fallbacks")


def registry_snapshot() -> dict[str, dict[str, Any]]:
    """Counters by name, for ``api/stats.resilience_snapshot``."""
    with _REGISTRY_LOCK:
        items = list(_REGISTRY.items())
    return {name: r.snapshot() for name, r in sorted(items)}


def reset_registry() -> None:
    """Test isolation hook."""
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
