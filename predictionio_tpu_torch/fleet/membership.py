"""Health-driven fleet membership with mark-down/mark-up hysteresis (a
copy of the JAX package's ``fleet/membership.py``).

Every backend's ``/healthz`` AND ``/readyz`` are probed on a background
loop (the engine server reports not-ready while a ``/reload`` is in
flight or after ``/drain``, so a replica mid-model-swap drains here
automatically). Hysteresis keeps a
flapping replica from oscillating the routing table: ``down_after``
consecutive probe failures mark a backend DOWN, ``up_after``
consecutive successes mark it UP again. A DOWN backend stops receiving
routed traffic but keeps being probed — mark-up is automatic.

The probe clock is injectable (:class:`~predictionio_tpu_torch.utils.
resilience.Clock`) and the loop can be driven synchronously
(:meth:`FleetMembership.probe_once`) so hysteresis transitions are
deterministic in tests without wall-time sleeps.

**Probe-starvation guard** (the 1s-probe-under-GIL-saturation pitfall,
the docs/fleet.md "Healthy fleet marked down under load" runbook): a
probe that TIMES OUT
against a replica whose data path is demonstrably fine — breaker
closed, a successful forwarded exchange within the grace window — is
probe starvation, not replica death. The guard counts it
(``pio_router_probe_starved_total``), logs a pointed warning, and does
NOT advance the failure streak, so a saturated-but-serving fleet never
talks itself into a mark-down spiral. Hard probe failures (refused,
reset, non-200) and timeouts without recent data-path proof still
count against the streak exactly as before.

Concurrency: per-:class:`Backend` mutable state (probe streaks, state,
in-flight count) sits under the backend's own lock; the backend LIST is
lock-guarded too — the scale controller adds and removes replicas at
runtime (fleet/controller.py), so every view takes a snapshot copy.
Handler threads read state through the locked accessors.
"""

from __future__ import annotations

import dataclasses
import logging
import socket
import threading
from typing import Sequence

from predictionio_tpu_torch.fleet.transport import BackendTransport, fan_out
from predictionio_tpu_torch.utils.resilience import (
    SYSTEM_CLOCK,
    CircuitBreaker,
    Clock,
    Resilience,
    RetryPolicy,
)

logger = logging.getLogger(__name__)

UP, DOWN = "up", "down"

STABLE, CANARY = "stable", "canary"


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One replica's address and rollout group, parsed from
    ``host:port`` (stable) / ``pio router --canary-backend`` (canary).
    Behind a multi-engine gateway (fleet/gateway.py) the spec also
    names the ENGINE whose group this replica belongs to, so flattened
    fleet snapshots and metric labels attribute every replica to its
    tenant ("" for the classic single-engine router)."""

    host: str
    port: int
    group: str = STABLE
    id: str = ""
    engine: str = ""

    def __post_init__(self):
        if not self.id:
            object.__setattr__(self, "id", f"{self.host}:{self.port}")

    @classmethod
    def parse(cls, addr: str, group: str = STABLE,
              engine: str = "") -> "BackendSpec":
        host, sep, port = addr.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(f"backend address {addr!r} is not host:port")
        return cls(host=host or "127.0.0.1", port=int(port), group=group,
                   engine=engine)


class Backend:
    """One replica: transport pool, resilience policy (breaker), and
    lock-guarded membership state."""

    def __init__(self, spec: BackendSpec,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 5.0,
                 clock: Clock = SYSTEM_CLOCK):
        self.spec = spec
        self.transport = BackendTransport(spec.host, spec.port)
        #: max_attempts=1 — the ROUTER owns retries (on a different
        #: replica, never this one); the policy contributes breaker
        #: accounting and failure classification per attempt
        self.resilience = Resilience(
            f"router/{spec.id}",
            policy=RetryPolicy(max_attempts=1),
            breaker=CircuitBreaker(
                f"router/{spec.id}",
                failure_threshold=breaker_threshold,
                reset_timeout=breaker_reset_s,
                clock=clock),
            clock=clock,
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._state = UP
        self._ok_streak = 0
        self._fail_streak = 0
        self._last_error: str | None = None
        self._inflight = 0
        self._transitions = 0
        self._last_data_ok: float | None = None
        self._probe_starved = 0

    # -- membership state (locked at writers and readers) -------------------
    @property
    def id(self) -> str:
        return self.spec.id

    @property
    def group(self) -> str:
        return self.spec.group

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def is_routable(self) -> bool:
        """UP and not breaker-open. A half-open breaker stays routable:
        its single admitted probe is exactly how the breaker re-learns
        the replica's health."""
        with self._lock:
            if self._state != UP:
                return False
        breaker = self.resilience.breaker
        return breaker is None or breaker.state != "open"

    def begin(self) -> None:
        with self._lock:
            self._inflight += 1

    def done(self) -> None:
        with self._lock:
            self._inflight -= 1

    # -- probe-starvation guard (module docstring) ---------------------------
    def record_data_ok(self) -> None:
        """A forwarded exchange succeeded — the data-path proof the
        starvation guard checks before trusting a probe timeout."""
        with self._lock:
            self._last_data_ok = self._clock.monotonic()

    def data_ok_within(self, grace_s: float) -> bool:
        with self._lock:
            last = self._last_data_ok
        return (last is not None
                and self._clock.monotonic() - last <= grace_s)

    def record_probe_starved(self) -> None:
        with self._lock:
            self._probe_starved += 1

    @property
    def probe_starved(self) -> int:
        with self._lock:
            return self._probe_starved

    def record_probe(self, ok: bool, error: str | None,
                     down_after: int, up_after: int) -> str | None:
        """Fold one probe result into the hysteresis streaks. Returns
        the new state when a transition happened, else None."""
        with self._lock:
            if ok:
                self._ok_streak += 1
                self._fail_streak = 0
                self._last_error = None
                if self._state == DOWN and self._ok_streak >= up_after:
                    self._state = UP
                    self._transitions += 1
                    return UP
            else:
                self._fail_streak += 1
                self._ok_streak = 0
                self._last_error = error
                if self._state == UP and self._fail_streak >= down_after:
                    self._state = DOWN
                    self._transitions += 1
                    return DOWN
        return None

    def mark_down(self, error: str) -> bool:
        """Immediate mark-down from the DATA path (a forward failed
        hard) — the probe loop will mark it back up. Returns True on an
        actual transition."""
        with self._lock:
            self._ok_streak = 0
            self._last_error = error
            if self._state == UP:
                self._state = DOWN
                self._transitions += 1
                return True
        return False

    def snapshot(self) -> dict:
        with self._lock:
            doc = {
                "id": self.spec.id,
                "group": self.spec.group,
                # the single-engine router's snapshot shape is pinned
                # by the pre-gateway suite: the engine key appears only
                # when a gateway stamped one
                **({"engine": self.spec.engine} if self.spec.engine
                   else {}),
                "state": self._state,
                "inflight": self._inflight,
                "okStreak": self._ok_streak,
                "failStreak": self._fail_streak,
                "transitions": self._transitions,
                "probeStarved": self._probe_starved,
                **({"lastError": self._last_error}
                   if self._last_error else {}),
            }
        breaker = self.resilience.breaker
        if breaker is not None:
            doc["breaker"] = {"state": breaker.state, "opens": breaker.opens}
        return doc

    def close(self) -> None:
        self.transport.close()


class FleetMembership:
    """The probe loop + routable-backend views (module docstring)."""

    def __init__(self, backends: Sequence[Backend],
                 probe_interval_s: float = 1.0,
                 probe_timeout_s: float = 1.0,
                 down_after: int = 2,
                 up_after: int = 2,
                 starvation_grace_s: float = 10.0):
        self._backends = list(backends)
        self._backends_lock = threading.Lock()
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.down_after = max(1, down_after)
        self.up_after = max(1, up_after)
        #: how recent a data-path success must be for a probe TIMEOUT
        #: to count as starvation rather than death (module docstring)
        self.starvation_grace_s = starvation_grace_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # guards the start/stop lifecycle (NOT the probe cycle):
        # start() is reachable from the router's admin-sync thread via
        # gateway registration, so the check-then-spawn must not race a
        # concurrent start()/stop()
        self._lifecycle = threading.Lock()

    # -- views --------------------------------------------------------------
    @property
    def backends(self) -> list[Backend]:
        """Snapshot copy — the list mutates at runtime (scale events)."""
        with self._backends_lock:
            return list(self._backends)

    def routable(self, group: str | None = None,
                 exclude: frozenset[str] | tuple = ()) -> list[Backend]:
        return [
            b for b in self.backends
            if (group is None or b.group == group)
            and b.id not in exclude
            and b.is_routable()
        ]

    def by_id(self, backend_id: str) -> Backend | None:
        return next((b for b in self.backends if b.id == backend_id), None)

    def snapshot(self) -> list[dict]:
        return [b.snapshot() for b in self.backends]

    def probe_starved_total(self) -> int:
        return sum(b.probe_starved for b in self.backends)

    # -- runtime scale events (fleet/controller.py) --------------------------
    def add(self, backend: Backend) -> None:
        """Join a replica at runtime — the probe loop picks it up on
        its next pass; join it DOWN (``backend.mark_down``) when the
        process behind it is still starting."""
        with self._backends_lock:
            if any(b.id == backend.id for b in self._backends):
                raise ValueError(f"backend {backend.id!r} already joined")
            self._backends.append(backend)
        logger.info("fleet backend %s joined membership", backend.id)

    def remove(self, backend_id: str) -> Backend | None:
        """Detach a replica: it stops being routable/probed NOW. The
        caller owns the drain story (the supervisor drains via
        /readyz before SIGTERM — fleet/supervisor.py)."""
        with self._backends_lock:
            backend = next((b for b in self._backends
                            if b.id == backend_id), None)
            if backend is not None:
                self._backends.remove(backend)
        if backend is not None:
            backend.close()
            logger.info("fleet backend %s left membership", backend_id)
        return backend

    # -- probing ------------------------------------------------------------
    def probe_backend(self, backend: Backend) \
            -> tuple[bool, str | None, bool]:
        """One health probe: ``/healthz`` then ``/readyz``, both must
        answer 200 inside ``probe_timeout_s`` each. Returns
        ``(ok, error, timed_out)`` — the timeout flag feeds the
        starvation guard, which must distinguish "slow to answer" from
        "refused/reset/unready" (only the former is starvation)."""
        for path in ("/healthz", "/readyz"):
            try:
                response = backend.transport.request(
                    "GET", path, timeout=self.probe_timeout_s)
            except (TimeoutError, socket.timeout) as exc:
                return False, f"{path}: {exc}", True
            except Exception as exc:  # transport/protocol failures
                return False, f"{path}: {exc}", False
            if response.status != 200:
                return False, f"{path}: HTTP {response.status}", False
        return True, None, False

    def _probe_and_record(self, backend: Backend) -> None:
        ok, error, timed_out = self.probe_backend(backend)
        if not ok and timed_out and self._starved(backend):
            # probe starvation, not replica death (module docstring):
            # the data path is succeeding, so the timeout says the
            # PROBE lost a scheduling race, and marking the replica
            # down would concentrate load on the survivors — the
            # mark-down spiral the runbook describes
            backend.record_probe_starved()
            logger.warning(
                "fleet backend %s probe timed out while its data path "
                "is healthy (breaker closed, success within %.0fs) — "
                "counting pio_router_probe_starved_total, NOT marking "
                "down. Size PIO_ROUTER_PROBE_TIMEOUT_S for the "
                "replica's p99 under load (docs/fleet.md, \"Healthy "
                "fleet marked down under load\")",
                backend.id, self.starvation_grace_s)
            return
        transition = backend.record_probe(
            ok, error, self.down_after, self.up_after)
        if transition is not None:
            log = logger.warning if transition == DOWN else logger.info
            log("fleet backend %s marked %s%s", backend.id, transition,
                f" ({error})" if error else "")

    def _starved(self, backend: Backend) -> bool:
        breaker = backend.resilience.breaker
        return ((breaker is None or breaker.state == "closed")
                and backend.data_ok_within(self.starvation_grace_s))

    def probe_once(self) -> None:
        """One synchronous probe pass over every backend — the loop
        body, also the deterministic test hook. Backends are probed
        CONCURRENTLY: a black-holed replica eats its own probe timeout,
        not everyone else's — sequential probing made one partitioned
        backend stretch every pass by its timeout, delaying mark-down
        and mark-up of healthy-streak transitions fleet-wide."""
        fan_out(self.backends, self._probe_and_record)

    def _run(self) -> None:
        while not self._stop.is_set():
            self.probe_once()
            # Event.wait doubles as the interval sleep AND the prompt
            # stop signal (a bare sleep would hold stop() for a full
            # interval)
            self._stop.wait(self.probe_interval_s)

    def start(self) -> None:
        with self._lifecycle:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="pio-fleet-probe", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lifecycle:
            thread, self._thread = self._thread, None
        if thread is not None:
            # join OUTSIDE the lifecycle lock: a probe pass can run up
            # to the probe timeout, and holding the lock here would
            # stall a concurrent start() for that long
            thread.join(timeout=5)
        for backend in self.backends:
            backend.close()
