"""Resilience: retry, circuit breaking, deadlines and their counters (a
copy of the JAX package's ``utils/resilience.py``; the port imports
nothing of that package).

- :class:`Clock` / :class:`ManualClock`: an injectable time source, so
  breakers, retries, the batch policy, the result caches and the
  supervisor run on virtual time in tests;
- :class:`RetryPolicy`: exponential backoff with full jitter
  (``uniform(0, min(cap, base*2^n))``), bounded by an attempt count, a
  total budget and the ambient per-request deadline
  (:func:`deadline_scope`);
- :class:`CircuitBreaker`: closed / open / half-open, one probe at a time
  while half-open, on the injected clock;
- :class:`Resilience` / :func:`resilient`: the call wrapper composing
  both, with counters per name (attempts, retries, failures,
  short-circuits, fallbacks) in the registry that ``api/stats.py`` and
  ``obs/registry.resilience_collector`` read. The router wraps every
  forward to a replica in its backend's ``Resilience``;
- :class:`StorageUnavailableError`: what the serving plane answers with
  ``503`` + ``Retry-After``, never a bare 500.

Configuration comes from source properties (``RETRY_*``, ``BREAKER_*``)
with process-wide fallbacks in ``PIO_RESILIENCE_<KEY>`` env vars.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import logging
import os
import random
import threading
import time
from typing import Any, Callable, Iterable, Mapping

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------

class Clock:
    """Injectable time source; production uses :data:`SYSTEM_CLOCK`."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


SYSTEM_CLOCK = Clock()


class ManualClock(Clock):
    """Deterministic clock for tests: ``sleep`` advances virtual time
    instantly, ``advance`` moves it explicitly. Breaker open → half-open
    → closed transitions become exactly reproducible."""

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


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

class TransientError(Exception):
    """Marker for failures worth retrying (connection refused, HTTP 5xx,
    stale NFS handle). Backends raise/wrap into this at their network
    boundary so the policy layer never guesses from SDK-specific types."""


class CircuitOpenError(TransientError):
    """The breaker is open: the call was short-circuited without touching
    the backend. ``retry_after`` is the time until the half-open probe."""

    def __init__(self, name: str, retry_after: float):
        super().__init__(
            f"circuit breaker {name!r} is open (retry in {retry_after:.1f}s)")
        self.name = name
        self.retry_after = retry_after


class StorageUnavailableError(ConnectionError):
    """A backend stayed unreachable after the policy's retries (or its
    breaker is open). The serving plane maps this — and only this class
    of failure — to ``503`` + ``Retry-After``. Subclasses
    ``ConnectionError`` (an ``OSError``) so callers with pre-resilience
    I/O-error handling keep working unchanged."""

    def __init__(self, name: str, message: str, retry_after: float = 1.0):
        super().__init__(f"storage backend {name!r} unavailable: {message}")
        self.name = name
        self.retry_after = retry_after


#: exception types that are retryable by default everywhere
TRANSIENT_ERRORS: tuple[type[BaseException], ...] = (
    TransientError, ConnectionError, TimeoutError,
)


def is_transient_http_status(code: int) -> bool:
    """THE retryability contract for plain-HTTP backends (ES, S3): 5xx
    and 429 are transient; any other 4xx is an application error that
    must surface unchanged. Shared so the backends cannot diverge."""
    return code >= 500 or code == 429

#: what the serving plane treats as "backend down → 503" (bare
#: ConnectionError/TimeoutError cover code paths that bypass resilient(),
#: e.g. a local sqlite file on a dying disk surfacing OSError subclasses)
STORAGE_UNAVAILABLE_ERRORS: tuple[type[BaseException], ...] = (
    StorageUnavailableError, CircuitOpenError, TransientError,
    ConnectionError, TimeoutError,
)


def retry_after_hint(exc: BaseException, default: float = 1.0) -> float:
    """Seconds a client should wait before retrying after ``exc``,
    floored at ``default`` so sub-second internal backoff hints never
    become a ``Retry-After: 0`` invitation to hammer the server."""
    hint = getattr(exc, "retry_after", None)
    if isinstance(hint, (int, float)) and hint > 0:
        return max(default, float(hint))
    return default


# ---------------------------------------------------------------------------
# per-request deadline propagation
# ---------------------------------------------------------------------------

_DEADLINE: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "pio_request_deadline", default=None)


@contextlib.contextmanager
def deadline_scope(budget_seconds: float):
    """Set the ambient per-request deadline for the enclosed work. Nested
    scopes only shrink the deadline, never extend it. Retry loops under
    the scope stop sleeping once the budget cannot cover the next delay."""
    new = time.monotonic() + max(0.0, budget_seconds)
    current = _DEADLINE.get()
    token = _DEADLINE.set(min(new, current) if current is not None else new)
    try:
        yield
    finally:
        _DEADLINE.reset(token)


def remaining_deadline() -> float | None:
    """Seconds left in the ambient request deadline (None = no deadline)."""
    deadline = _DEADLINE.get()
    if deadline is None:
        return None
    return max(0.0, deadline - time.monotonic())


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

def _prop(props: Mapping[str, str], key: str, default: str) -> str:
    """Source property, else PIO_RESILIENCE_<key> env, else default."""
    v = props.get(key)
    if v is not None:
        return v
    return os.environ.get(f"PIO_RESILIENCE_{key}", default)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter, deadline-aware.

    ``delay(n) = uniform(0, min(max_delay, base_delay * multiplier**n))``
    for 0-based retry index ``n`` (full jitter — parallel clients that
    failed together do NOT retry together, unlike the engine server's old
    fixed 1s bind sleep). ``deadline`` bounds the TOTAL time budget of
    one resilient call including sleeps; the ambient
    :func:`deadline_scope` tightens it further per request.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: bool = True
    #: lower bound of the jitter window as a fraction of the cap: 0.0 is
    #: classic full jitter; 0.5 is "equal jitter" for callers that need a
    #: guaranteed minimum wait (e.g. bind retries waiting out a
    #: predecessor's port) without giving up decorrelation
    jitter_floor: float = 0.0
    deadline: float | None = None

    def backoff(self, retry_index: int, rng: random.Random) -> float:
        """Delay before retry number ``retry_index`` (0-based)."""
        cap = min(self.max_delay,
                  self.base_delay * (self.multiplier ** retry_index))
        if not self.jitter:
            return cap
        return rng.uniform(cap * min(max(self.jitter_floor, 0.0), 1.0), cap)

    @classmethod
    def from_properties(
        cls,
        props: Mapping[str, str],
        max_attempts: int = 3,
        base_delay: float = 0.05,
        max_delay: float = 2.0,
    ) -> "RetryPolicy":
        """Build from ``RETRY_*`` storage-source properties with
        ``PIO_RESILIENCE_RETRY_*`` env fallbacks."""
        deadline_ms = float(_prop(props, "RETRY_DEADLINE_MS", "0"))
        return cls(
            max_attempts=max(1, int(_prop(
                props, "RETRY_MAX_ATTEMPTS", str(max_attempts)))),
            base_delay=float(_prop(
                props, "RETRY_BASE_DELAY_MS", str(base_delay * 1e3))) / 1e3,
            max_delay=float(_prop(
                props, "RETRY_MAX_DELAY_MS", str(max_delay * 1e3))) / 1e3,
            jitter=_prop(props, "RETRY_JITTER", "true").lower() != "false",
            deadline=deadline_ms / 1e3 if deadline_ms > 0 else None,
        )


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Consecutive-failure breaker with deterministic transitions.

    CLOSED —(``failure_threshold`` consecutive failures)→ OPEN;
    OPEN —(``reset_timeout`` elapsed on the injected clock)→ HALF_OPEN,
    which admits one probe at a time; ``success_threshold`` probe
    successes close it, any probe failure re-opens and re-arms the timer.
    """

    def __init__(
        self,
        name: str = "breaker",
        failure_threshold: int = 5,
        reset_timeout: float = 30.0,
        success_threshold: int = 1,
        clock: Clock = SYSTEM_CLOCK,
    ):
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout = reset_timeout
        self.success_threshold = max(1, success_threshold)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._successes = 0
        self._opened_at = 0.0
        self._probing = False
        self._opens = 0  # lifetime count of CLOSED/HALF_OPEN -> OPEN

    @property
    def state(self) -> str:
        with self._lock:
            return self._peek_state()

    @property
    def opens(self) -> int:
        """Lifetime CLOSED/HALF_OPEN -> OPEN count, read under the
        breaker lock like ``state`` (trips happen on request threads;
        status readers live elsewhere)."""
        with self._lock:
            return self._opens

    def _peek_state(self) -> str:
        if self._state == OPEN:
            if self._clock.monotonic() - self._opened_at >= self.reset_timeout:
                return HALF_OPEN
        return self._state

    def before_call(self) -> None:
        """Raise :class:`CircuitOpenError` unless a call may proceed."""
        with self._lock:
            state = self._peek_state()
            if state == CLOSED:
                return
            if state == HALF_OPEN:
                if self._state == OPEN:  # first probe since reset elapsed
                    self._state = HALF_OPEN
                    self._successes = 0
                    self._probing = False
                if self._probing:
                    raise CircuitOpenError(self.name, self._retry_after())
                self._probing = True
                return
            raise CircuitOpenError(self.name, self._retry_after())

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state == HALF_OPEN:
                self._probing = False
                self._successes += 1
                if self._successes >= self.success_threshold:
                    self._state = CLOSED
                    logger.info("circuit breaker %s closed", self.name)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._trip()
                return
            self._failures += 1
            if self._state == CLOSED and self._failures >= self.failure_threshold:
                self._trip()

    def release_probe(self) -> None:
        """Free a half-open probe slot WITHOUT judging the backend — for
        callers interrupted (KeyboardInterrupt/SystemExit) before the
        probe produced a verdict. Without this the slot leaks and the
        breaker wedges open in any process that survives the interrupt."""
        with self._lock:
            self._probing = False

    def _trip(self) -> None:
        self._state = OPEN
        self._opened_at = self._clock.monotonic()
        self._failures = 0
        self._probing = False
        self._opens += 1
        logger.warning("circuit breaker %s opened (retry in %.1fs)",
                       self.name, self.reset_timeout)

    def _retry_after(self) -> float:
        elapsed = self._clock.monotonic() - self._opened_at
        return max(0.0, self.reset_timeout - elapsed)

    @classmethod
    def from_properties(
        cls,
        name: str,
        props: Mapping[str, str],
        clock: Clock = SYSTEM_CLOCK,
        failure_threshold: int = 5,
        reset_timeout: float = 30.0,
    ) -> "CircuitBreaker | None":
        """``BREAKER_*`` properties; ``BREAKER_THRESHOLD=0`` disables."""
        threshold = int(_prop(props, "BREAKER_THRESHOLD",
                              str(failure_threshold)))
        if threshold <= 0:
            return None
        return cls(
            name=name,
            failure_threshold=threshold,
            reset_timeout=float(_prop(
                props, "BREAKER_RESET_S", str(reset_timeout))),
            success_threshold=max(1, int(_prop(
                props, "BREAKER_SUCCESSES", "1"))),
            clock=clock,
        )


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

class ResilienceMetrics:
    """Lock-guarded counters for one named policy instance."""

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


# ---------------------------------------------------------------------------
# the composed wrapper
# ---------------------------------------------------------------------------

class Resilience:
    """A named retry-policy + circuit-breaker pair around callables.

    ``classify(exc) -> bool`` overrides the default isinstance check
    against ``retryable`` (e.g. "HTTP 5xx is transient, 4xx is not").
    Non-retryable exceptions pass through untouched — they are
    application errors, not backend-health signals — and do not count
    against the breaker.
    """

    def __init__(
        self,
        name: str,
        policy: RetryPolicy | None = None,
        breaker: CircuitBreaker | None = None,
        clock: Clock = SYSTEM_CLOCK,
        retryable: Iterable[type[BaseException]] = TRANSIENT_ERRORS,
        classify: Callable[[BaseException], bool] | None = None,
        rng: random.Random | None = None,
        register: bool = True,
    ):
        self.name = name
        self.policy = policy or RetryPolicy()
        self.breaker = breaker
        self.clock = clock
        self.retryable = tuple(retryable)
        self.classify = classify
        self.metrics = ResilienceMetrics()
        self._rng = rng or random.Random()
        if register:
            _register(self)

    # -- classification -----------------------------------------------------
    def _is_retryable(self, exc: BaseException) -> bool:
        if isinstance(exc, StorageUnavailableError):
            # terminal: a NESTED policy already exhausted its own budget
            # (e.g. chaos wrapping a remote backend) — re-retrying it
            # would multiply attempts exactly when the backend is down
            return False
        if self.classify is not None:
            return bool(self.classify(exc))
        return isinstance(exc, self.retryable)

    # -- the wrapper --------------------------------------------------------
    def call(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        """Run ``fn`` under the policy; raises
        :class:`StorageUnavailableError` when the backend stays down."""
        m = self.metrics
        m.bump("calls")
        start = self.clock.monotonic()
        retry_index = 0
        while True:
            if self.breaker is not None:
                try:
                    self.breaker.before_call()
                except CircuitOpenError as exc:
                    m.bump("short_circuits")
                    raise StorageUnavailableError(
                        self.name, str(exc),
                        retry_after=exc.retry_after) from exc
            m.bump("attempts")
            try:
                result = fn(*args, **kwargs)
            except StorageUnavailableError:
                # a NESTED policy already exhausted its budget: the
                # backend is down — count the failure, release any
                # half-open probe slot, but never re-retry a terminal
                # error (that would multiply attempts during an outage)
                if self.breaker is not None:
                    self.breaker.record_failure()
                m.bump("failures")
                raise
            except BaseException as exc:
                if not isinstance(exc, Exception):
                    # interrupt (KeyboardInterrupt/SystemExit): not a
                    # backend health signal — don't move the breaker,
                    # but DO free a held half-open probe slot
                    if self.breaker is not None:
                        self.breaker.release_probe()
                    raise
                if not self._is_retryable(exc):
                    # an application-level error means the backend
                    # RESPONDED (ES 4xx, SQL/auth error): not a health
                    # failure — and a half-open probe slot MUST be
                    # released here or the breaker wedges open forever
                    if self.breaker is not None:
                        self.breaker.record_success()
                    raise
                if self.breaker is not None:
                    self.breaker.record_failure()
                m.bump("failures")
                delay = self.policy.backoff(retry_index, self._rng)
                if not self._may_retry(retry_index, start, delay):
                    m.bump("unavailable")
                    raise StorageUnavailableError(
                        self.name, str(exc),
                        retry_after=retry_after_hint(
                            exc, self.policy.base_delay * 2),
                    ) from exc
                retry_index += 1
                m.bump("retries")
                self.clock.sleep(delay)
                continue
            if self.breaker is not None:
                self.breaker.record_success()
            return result

    def _may_retry(self, retry_index: int, start: float, delay: float) -> bool:
        if retry_index + 1 >= self.policy.max_attempts:
            return False
        if self.policy.deadline is not None:
            elapsed = self.clock.monotonic() - start
            if elapsed + delay >= self.policy.deadline:
                return False
        ambient = remaining_deadline()
        if ambient is not None and delay >= ambient:
            return False
        return True

    # -- reporting ----------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        out: dict[str, Any] = self.metrics.snapshot()
        if self.breaker is not None:
            out["breaker"] = {
                "state": self.breaker.state,
                "opens": self.breaker.opens,
            }
        return out

    @classmethod
    def from_properties(
        cls,
        name: str,
        props: Mapping[str, str],
        clock: Clock = SYSTEM_CLOCK,
        retryable: Iterable[type[BaseException]] = TRANSIENT_ERRORS,
        classify: Callable[[BaseException], bool] | None = None,
        max_attempts: int = 3,
        base_delay: float = 0.05,
        max_delay: float = 2.0,
        failure_threshold: int = 5,
        reset_timeout: float = 30.0,
    ) -> "Resilience":
        """Per-source wiring used by the storage backends: ``RETRY_*`` and
        ``BREAKER_*`` properties with ``PIO_RESILIENCE_*`` env fallbacks."""
        return cls(
            name=name,
            policy=RetryPolicy.from_properties(
                props, max_attempts=max_attempts, base_delay=base_delay,
                max_delay=max_delay),
            breaker=CircuitBreaker.from_properties(
                name, props, clock=clock,
                failure_threshold=failure_threshold,
                reset_timeout=reset_timeout),
            clock=clock,
            retryable=retryable,
            classify=classify,
        )


def resilient(resilience: Resilience, fn: Callable[..., Any],
              *args: Any, **kwargs: Any) -> Any:
    """THE policy gate for backend I/O: every remote-backend network call
    site routes through this wrapper."""
    return resilience.call(fn, *args, **kwargs)


# ---------------------------------------------------------------------------
# registry (metrics exposure through api/stats.py)
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Resilience] = {}
_REGISTRY_LOCK = threading.Lock()


def _register(r: Resilience) -> None:
    with _REGISTRY_LOCK:
        _REGISTRY[r.name] = r  # latest instance wins (re-created sources)


def get_resilience(name: str) -> Resilience | None:
    with _REGISTRY_LOCK:
        return _REGISTRY.get(name)


def record_fallback(name: str) -> None:
    """Count a graceful-degradation fallback under ``name`` — e.g. the
    query batcher retrying a failed batch query-by-query, or /reload
    keeping the last-known-good model. Creates (and registers) a
    counter-only policy entry on first use so the event shows up in
    ``registry_snapshot()`` next to the backend counters."""
    with _REGISTRY_LOCK:
        r = _REGISTRY.get(name)
    if r is None:
        candidate = Resilience(name, policy=RetryPolicy(max_attempts=1),
                               register=False)
        with _REGISTRY_LOCK:
            # atomic create-or-adopt: a concurrent first fallback must
            # not bump a discarded instance
            r = _REGISTRY.setdefault(name, candidate)
    r.metrics.bump("fallbacks")


def registry_snapshot() -> dict[str, dict[str, Any]]:
    """Per-backend counters for ``api/stats.py`` and the status pages."""
    with _REGISTRY_LOCK:
        items = list(_REGISTRY.items())
    return {name: r.snapshot() for name, r in sorted(items)}


def reset_registry() -> None:
    """Test isolation hook."""
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
