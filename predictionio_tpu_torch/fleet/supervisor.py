"""The process supervisor (a copy of the JAX package's
``fleet/supervisor.py``): respawn dead children, damp crash loops, drain
before kill.

``pio deploy --workers N --supervise`` owns its N-1 worker siblings
through it, each a :class:`SpawnSpec` whose ``spawn`` starts a process
from the ``spawn`` context (a sibling respawned by a parent that has
CUDA up must not be forked from it):

- **liveness**: the pid (``poll()``), plus an optional bounded
  ``/healthz`` probe for children with an address; children are checked
  concurrently (``fleet/transport.fan_out``), so one wedged child eats
  only its own probe timeout;
- **respawn with damping**: a dead child restarts after a full-jitter
  exponential backoff (:class:`~predictionio_tpu_torch.utils.resilience.RetryPolicy`
  delays) on the injectable
  :class:`~predictionio_tpu_torch.utils.resilience.Clock`, so the whole
  schedule is deterministic under ``ManualClock``;
- **crash-loop damping**: ``crash_loop_threshold`` deaths inside
  ``crash_loop_window_s`` latch the child into a give-up state
  (``pio_fleet_crash_loop``) instead of spawning it again and again;
- **drain before kill**: a child with an address is drained first
  (``POST /drain`` flips its ``/readyz`` to 503, confirmed by a bounded
  poll, then a settle period), then SIGTERM with a grace window, then
  SIGKILL. Worker siblings share one port and have no address of their
  own, so they go straight to SIGTERM;
- **whole-pool shutdown**: :meth:`FleetSupervisor.shutdown` stops every
  child, which is what a SIGTERM of the deploy process routes into.

Every probe and drain exchange carries a timeout, and the loop never
calls ``time.sleep``: waits ride the injected clock or the stop event.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from collections import deque
from typing import Any, Callable

from predictionio_tpu_torch.fleet.transport import BackendTransport, fan_out
from predictionio_tpu_torch.obs.registry import Metric
from predictionio_tpu_torch.utils.envcfg import env_field
from predictionio_tpu_torch.utils.resilience import (
    SYSTEM_CLOCK,
    Clock,
    RetryPolicy,
)

logger = logging.getLogger(__name__)

#: child lifecycle states
RUNNING, BACKOFF, CRASH_LOOPED, STOPPED = (
    "running", "backoff", "crash_looped", "stopped")

REPLICA, WORKER = "replica", "worker"


@dataclasses.dataclass(frozen=True)
class SpawnSpec:
    """One supervised child, declaratively: a stable identity, how to
    (re)launch it, and — for replicas — the address whose ``/healthz``
    and drain surfaces the supervisor talks to. ``spawn`` returns a
    process handle satisfying the ``subprocess.Popen`` slice the
    supervisor uses: ``pid``, ``poll()`` (None while alive),
    ``terminate()``, ``kill()``, ``wait(timeout=...)``."""

    id: str
    spawn: Callable[[], Any]
    role: str = REPLICA
    #: ``host:port`` probed for liveness and drained on removal; None
    #: (worker siblings on a shared SO_REUSEPORT port): pid only
    address: str | None = None
    group: str = "stable"


class ProcessHandle:
    """``multiprocessing.Process`` adapted to the Popen handle contract
    (``poll``/``terminate``/``kill``/``wait``), starting the process if
    it is not started yet (``subprocess.Popen`` satisfies it natively)."""

    def __init__(self, process):
        self._process = process
        if process.pid is None:
            process.start()

    @property
    def pid(self) -> int:
        return self._process.pid

    def poll(self) -> int | None:
        return self._process.exitcode

    def terminate(self) -> None:
        self._process.terminate()

    def kill(self) -> None:
        self._process.kill()

    def wait(self, timeout: float | None = None) -> int | None:
        self._process.join(timeout)
        return self._process.exitcode


def _env_field(key: str, default, cast):
    """A ``PIO_FLEET_<KEY>``-overridable default, read when the config
    is built."""
    return env_field("PIO_FLEET_", key, default, cast)


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Supervision knobs, each overridable by ``PIO_FLEET_<KEY>``."""

    #: supervision pass cadence (liveness checks + due respawns)
    poll_interval_s: float = _env_field("POLL_INTERVAL_S", 0.5, float)
    #: socket bound per /healthz probe and per drain exchange
    probe_timeout_s: float = _env_field("PROBE_TIMEOUT_S", 1.0, float)
    #: consecutive failed /healthz probes on a LIVE pid before the
    #: child is declared wedged and recycled; 0 disables (pid-only).
    #: Generous by default: a GIL-saturated child answers late, and
    #: recycling a healthy-but-busy process is worse than waiting
    unhealthy_after: int = _env_field("UNHEALTHY_AFTER", 10, int)
    #: full-jitter exponential respawn backoff (RetryPolicy semantics)
    backoff_base_s: float = _env_field("BACKOFF_BASE_S", 0.5, float)
    backoff_max_s: float = _env_field("BACKOFF_MAX_S", 30.0, float)
    backoff_multiplier: float = _env_field("BACKOFF_MULTIPLIER", 2.0, float)
    #: crash-loop damping: this many deaths inside the window latches
    #: the child into give-up instead of respawning forever
    crash_loop_threshold: int = _env_field("CRASH_LOOP_THRESHOLD", 5, int)
    crash_loop_window_s: float = _env_field("CRASH_LOOP_WINDOW_S", 60.0, float)
    #: drain-before-kill bounds: how long to wait for /readyz to
    #: acknowledge the drain, poll cadence, and the settle period that
    #: lets in-flight work finish before SIGTERM
    drain_timeout_s: float = _env_field("DRAIN_TIMEOUT_S", 10.0, float)
    drain_poll_s: float = _env_field("DRAIN_POLL_S", 0.25, float)
    drain_settle_s: float = _env_field("DRAIN_SETTLE_S", 1.0, float)
    #: SIGTERM grace before SIGKILL
    term_grace_s: float = _env_field("TERM_GRACE_S", 5.0, float)
    #: accessKey appended to POST /drain for children launched with a
    #: server key: without it a keyed child answers 401 and the drain
    #: degrades to a bare SIGTERM
    drain_key: str | None = _env_field("DRAIN_KEY", None, str)

    def backoff_policy(self) -> RetryPolicy:
        # the supervisor loops; the policy only gives the delays
        return RetryPolicy(
            base_delay=self.backoff_base_s,
            max_delay=self.backoff_max_s,
            multiplier=self.backoff_multiplier,
            jitter=True,
        )


class _Child:
    """Mutable supervision state for one spec. Guarded by the
    supervisor-wide lock; the spawn/probe/drain I/O itself runs outside
    it (one child's slow exchange must not freeze the bookkeeping)."""

    def __init__(self, spec: SpawnSpec):
        self.spec = spec
        self.handle: Any | None = None
        self.state = STOPPED
        self.deaths: deque[float] = deque()
        self.respawns = 0
        self.unhealthy_streak = 0
        self.next_spawn_at = 0.0
        self.last_exit: int | str | None = None
        #: ordered action log ("spawn"/"death"/"drain"/"terminate"/
        #: "kill"/"give_up") — the drain-before-kill ordering pin
        self.events: list[str] = []
        self._transport: BackendTransport | None = None

    def transport(self) -> BackendTransport | None:
        if self.spec.address is None:
            return None
        if self._transport is None:
            host, _, port = self.spec.address.rpartition(":")
            self._transport = BackendTransport(host or "127.0.0.1",
                                               int(port), pool_size=2)
        return self._transport

    def close_transport(self) -> None:
        if self._transport is not None:
            self._transport.close()
            self._transport = None

    def snapshot(self) -> dict:
        doc = {
            "id": self.spec.id,
            "role": self.spec.role,
            "state": self.state,
            "respawns": self.respawns,
            "deaths": len(self.deaths),
        }
        if self.spec.address:
            doc["address"] = self.spec.address
        if self.handle is not None:
            doc["pid"] = self.handle.pid
        if self.last_exit is not None:
            doc["lastExit"] = self.last_exit
        return doc


class FleetSupervisor:
    """The supervision loop over a set of :class:`SpawnSpec` children
    (module docstring). ``on_respawn(spec)`` / ``on_give_up(spec)``
    hooks let the owner log or alert."""

    def __init__(self, specs=(), config: SupervisorConfig | None = None,
                 clock: Clock = SYSTEM_CLOCK,
                 rng=None,
                 on_respawn: Callable[[SpawnSpec], None] | None = None,
                 on_give_up: Callable[[SpawnSpec], None] | None = None):
        import random

        self.config = config or SupervisorConfig()
        self.clock = clock
        self._rng = rng or random.Random()
        self._policy = self.config.backoff_policy()
        self._lock = threading.Lock()
        self._children: dict[str, _Child] = {}
        #: removed/shut-down children keep their event logs around for
        #: the drain-ordering tests and post-mortem snapshots
        self._retired: dict[str, _Child] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.on_respawn = on_respawn
        self.on_give_up = on_give_up
        for spec in specs:
            self.add(spec, start=False)

    # -- membership of the supervised set ------------------------------------
    def add(self, spec: SpawnSpec, start: bool = True) -> None:
        """Adopt (and optionally immediately spawn) a new child."""
        child = _Child(spec)
        with self._lock:
            if spec.id in self._children:
                raise ValueError(f"duplicate supervised child {spec.id!r}")
            self._children[spec.id] = child
        if start:
            self._spawn(child)

    def remove(self, spec_id: str, drain: bool = True,
               reason: str | None = None) -> bool:
        """Stop owning ``spec_id``: drain (children with an address),
        SIGTERM with a grace window, SIGKILL stragglers. Returns False
        for an unknown id. ``reason`` stamps the child's event log, so a
        retirement is attributable."""
        with self._lock:
            child = self._children.pop(spec_id, None)
            if child is not None and reason:
                # only attributed removals stamp the log — unattributed
                # ones keep the pinned ["spawn", "drain", ...] shape
                child.events.append(f"remove:{reason}")
        if child is None:
            return False
        self._drain_and_stop(child, drain=drain)
        with self._lock:
            self._retired[spec_id] = child
        return True

    def children(self) -> list[dict]:
        with self._lock:
            return [c.snapshot() for c in self._children.values()]

    def child_pid(self, spec_id: str) -> int | None:
        with self._lock:
            child = self._children.get(spec_id)
        if child is None or child.handle is None:
            return None
        return child.handle.pid

    def child_events(self, spec_id: str) -> list[str]:
        with self._lock:
            child = (self._children.get(spec_id)
                     or self._retired.get(spec_id))
            return list(child.events) if child is not None else []

    def crash_looped(self) -> bool:
        with self._lock:
            return any(c.state == CRASH_LOOPED
                       for c in self._children.values())

    # -- spawning + death bookkeeping ----------------------------------------
    def _spawn(self, child: _Child) -> None:
        try:
            handle = child.spec.spawn()
        except Exception:
            logger.exception("spawn of %s failed", child.spec.id)
            self._record_death(child, "spawn-failed")
            return
        with self._lock:
            child.handle = handle
            child.state = RUNNING
            child.unhealthy_streak = 0
            child.events.append("spawn")
        logger.info("supervised child %s up (pid %d)", child.spec.id,
                    handle.pid)

    def _record_death(self, child: _Child, exit_code) -> None:
        now = self.clock.monotonic()
        cfg = self.config
        with self._lock:
            child.events.append("death")
            child.last_exit = exit_code
            child.handle = None
            child.deaths.append(now)
            # only deaths inside the crash-loop window count toward the
            # latch AND toward the backoff index — a child that ran
            # stably for longer than the window restarts from the base
            # delay, not from wherever its history left off
            while child.deaths and now - child.deaths[0] > cfg.crash_loop_window_s:
                child.deaths.popleft()
            if len(child.deaths) >= max(2, cfg.crash_loop_threshold):
                child.state = CRASH_LOOPED
                child.events.append("give_up")
                spec = child.spec
            else:
                retry_index = len(child.deaths) - 1
                delay = self._policy.backoff(retry_index, self._rng)
                child.next_spawn_at = now + delay
                child.state = BACKOFF
                logger.warning(
                    "supervised child %s died (exit %s); respawn in "
                    "%.2fs (death %d in window)", child.spec.id,
                    exit_code, delay, len(child.deaths))
                return
        logger.error(
            "supervised child %s is crash-looping (%d deaths in %.0fs) "
            "— giving up; pio_fleet_crash_loop=1 until an operator "
            "fixes it and restarts", spec.id, cfg.crash_loop_threshold,
            cfg.crash_loop_window_s)
        if self.on_give_up is not None:
            self.on_give_up(spec)

    def _respawn_due(self, child: _Child) -> None:
        self._spawn(child)
        if child.state == RUNNING:
            with self._lock:
                child.respawns += 1
            if self.on_respawn is not None:
                self.on_respawn(child.spec)

    # -- the supervision pass -------------------------------------------------
    def poll_once(self) -> None:
        """One supervision pass — the loop body and the deterministic
        test hook. Children are checked concurrently: a black-holed
        /healthz eats its own probe timeout, not the pass."""
        with self._lock:
            children = list(self._children.values())
        fan_out(children, self._check_child)

    def _check_child(self, child: _Child) -> None:
        with self._lock:
            state = child.state
            handle = child.handle
        if state == RUNNING and handle is not None:
            code = handle.poll()
            if code is not None:
                self._record_death(child, code)
                return
            self._health_check(child)
        elif state == BACKOFF \
                and self.clock.monotonic() >= child.next_spawn_at:
            self._respawn_due(child)

    def _health_check(self, child: _Child) -> None:
        cfg = self.config
        transport = child.transport()
        if transport is None or cfg.unhealthy_after <= 0:
            return
        try:
            response = transport.request("GET", "/healthz",
                                         timeout=cfg.probe_timeout_s)
            ok = response.status == 200
        except Exception:  # noqa: BLE001 — a probe failure is a data point
            ok = False
        with self._lock:
            if ok:
                child.unhealthy_streak = 0
                return
            child.unhealthy_streak += 1
            wedged = child.unhealthy_streak >= cfg.unhealthy_after
            handle = child.handle
        if not wedged or handle is None:
            return
        # a live pid that stopped answering /healthz for a sustained
        # streak is wedged (deadlocked, out of memory, spinning):
        # recycle it through the normal death path so backoff and the
        # crash-loop latch apply
        logger.warning(
            "supervised child %s (pid %d) is alive but failed %d "
            "consecutive health probes — recycling", child.spec.id,
            handle.pid, child.unhealthy_streak)
        handle.kill()
        self._await(handle, cfg.term_grace_s)
        self._record_death(child, "unhealthy")

    # -- drain + stop ---------------------------------------------------------
    @staticmethod
    def _await(handle, timeout: float) -> None:
        try:
            handle.wait(timeout=timeout)
        except Exception:  # subprocess.TimeoutExpired — caller re-checks
            pass

    def _drain(self, child: _Child) -> None:
        """Flip the child's readiness off and wait, bounded, for work to
        stop arriving: ``POST /drain`` makes its ``/readyz`` answer 503
        (api/engine_server.py), a bounded poll confirms the flip, and a
        settle period lets in-flight requests finish."""
        cfg = self.config
        transport = child.transport()
        if transport is None:
            return
        with self._lock:
            child.events.append("drain")
        drain_path = "/drain"
        if cfg.drain_key:
            from urllib.parse import quote

            drain_path += f"?accessKey={quote(cfg.drain_key)}"
        try:
            response = transport.request("POST", drain_path,
                                         timeout=cfg.probe_timeout_s)
            if response.status != 200:
                # the child REFUSED the drain (key-authed server and
                # we hold no key, or no such route): the latch is not
                # set, so polling /readyz would burn the full drain
                # timeout for nothing — fall straight back to SIGTERM
                raise RuntimeError(f"HTTP {response.status}")
        except Exception as exc:  # noqa: BLE001 — degrade to the grace window
            logger.warning("drain request to %s failed (%s); falling "
                           "back to the SIGTERM grace window",
                           child.spec.id, exc)
            return
        deadline = self.clock.monotonic() + cfg.drain_timeout_s
        while self.clock.monotonic() < deadline:
            try:
                response = transport.request(
                    "GET", "/readyz", timeout=cfg.probe_timeout_s)
                if response.status != 200:
                    break               # drain acknowledged: not ready
            except Exception:  # noqa: BLE001 — the child may already be gone
                break
            self.clock.sleep(cfg.drain_poll_s)
        self.clock.sleep(cfg.drain_settle_s)

    def _drain_and_stop(self, child: _Child, drain: bool) -> None:
        handle = child.handle
        with self._lock:
            child.state = STOPPED
        if handle is not None and handle.poll() is None:
            if drain and child.spec.role == REPLICA:
                self._drain(child)
            with self._lock:
                child.events.append("terminate")
            handle.terminate()
            self._await(handle, self.config.term_grace_s)
            if handle.poll() is None:
                with self._lock:
                    child.events.append("kill")
                handle.kill()
                self._await(handle, self.config.term_grace_s)
        child.close_transport()

    def shutdown(self) -> None:
        """Stop the loop, then drain and stop every child, concurrently
        (the shutdown pays the slowest drain, not the sum). A SIGTERM of
        ``pio deploy --workers N --supervise`` routes here, so stopping
        the deploy stops the whole pool."""
        self.stop()
        with self._lock:
            children = list(self._children.values())
            self._children.clear()
            self._retired.update(
                (c.spec.id, c) for c in children)
        fan_out(children, lambda c: self._drain_and_stop(c, drain=True))

    # -- lifecycle ------------------------------------------------------------
    def start(self, loop: bool = True) -> None:
        """Spawn every not-yet-running child and start the loop.
        ``loop=False`` spawns only — tests drive :meth:`poll_once`
        themselves so the whole schedule rides the injected clock."""
        with self._lock:
            pending = [c for c in self._children.values()
                       if c.state == STOPPED and c.handle is None]
        for child in pending:
            self._spawn(child)
        if not loop or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="pio-fleet-supervisor", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            # Event.wait is the interval sleep AND the prompt stop signal
            self._stop.wait(self.config.poll_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def snapshot(self) -> dict:
        docs = self.children()
        return {
            "children": docs,
            "crashLooped": any(d["state"] == CRASH_LOOPED for d in docs),
            "respawns": sum(d["respawns"] for d in docs),
        }


def supervisor_collector(supervisor: FleetSupervisor):
    """Registry adapter (obs/registry.py): the crash-loop alarm gauge,
    per-child liveness, and respawn counters."""

    def collect() -> list[Metric]:
        docs = supervisor.children()
        crash = Metric(
            name="pio_fleet_crash_loop", kind="gauge",
            help="1 while any supervised child is latched in crash-loop "
                 "give-up",
            samples=[({}, 1.0 if any(d["state"] == CRASH_LOOPED
                                     for d in docs) else 0.0)])
        up = Metric(
            name="pio_fleet_child_up", kind="gauge",
            help="Supervised child state: 1 running, 0 anything else")
        respawns = Metric(
            name="pio_fleet_respawns_total", kind="counter",
            help="Times the supervisor restarted this child")
        for doc in docs:
            labels = {"child": doc["id"], "role": doc["role"]}
            up.samples.append(
                (labels, 1.0 if doc["state"] == RUNNING else 0.0))
            respawns.samples.append((labels, float(doc["respawns"])))
        return [crash, up, respawns]

    return collect
