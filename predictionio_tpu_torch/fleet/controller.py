"""The scale controller: the actor behind the autoscaling signals (a
copy of the JAX package's ``fleet/controller.py``).

The router exports the signals, ``pio_fleet_pressure`` and
``pio_slo_burn_rate{slo,window}`` on ``GET /fleet/metrics``. This
module is the controller that acts on them: a background loop that polls the router's own merged fleet
metrics and applies a hysteresis policy,

- **scale up** on SUSTAINED pressure above ``pressure_up`` (latency is
  queueing, not model time) or a fast-window SLO burn above
  ``burn_up`` (the incident is happening now),
- **scale down** only after a COOLDOWN of sustained quiet (pressure
  below ``pressure_down`` with both burn windows under 1.0),
- clamped to ``[min_replicas, max_replicas]``, with a global
  ``cooldown_s`` between actions so one hot scrape cannot ratchet the
  fleet,
- **dry-run first**: with ``dry_run`` the controller only EXPORTS its
  verdicts (``pio_fleet_desired_replicas`` vs actual, decision
  counters) so operators can watch it against production traffic
  before trusting it with actuation.

Everything is deterministic on the injectable Clock: ``tick()`` is the
loop body AND the test hook: a decision table drives it with scripted
signals on a ``ManualClock``. Actuation goes through a small interface so the
supervised-fleet actuator (spawn a replica via the supervisor, join it
to membership; detach + drain on the way down) and test doubles are
interchangeable.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import re
import threading
from typing import Callable

from predictionio_tpu_torch.fleet.membership import Backend, BackendSpec
from predictionio_tpu_torch.fleet.supervisor import (
    CRASH_LOOPED,
    FleetSupervisor,
    SpawnSpec,
    _env_field,
)
from predictionio_tpu_torch.obs.registry import Metric
from predictionio_tpu_torch.utils.resilience import SYSTEM_CLOCK, Clock

logger = logging.getLogger(__name__)

UP, DOWN, HOLD, ERROR = "up", "down", "hold", "error"

#: decision counter keys (cooldown_hold = a verdict suppressed by the
#: global action cooldown; actuation_failed = the actuator said no)
DECISIONS = (UP, DOWN, HOLD, ERROR, "cooldown_hold", "actuation_failed")

#: decision attribution — every verdict carries WHY (docs/fleet.md
#: "Per-tenant elasticity"): `burn` (fast-window SLO burn tripped),
#: `pressure` (queue-bound), `quiet` (sustained calm), `steady`,
#: `cooldown`, `signals_unreadable`, or the actuator's own refusal
#: (`budget_exhausted`, `crash_loop`, ...). The lone-default unlabeled
#: exposition is untouched — reasons surface on the per-engine
#: `pio_fleet_scale_decisions_total{engine,decision,reason}` family and
#: in snapshots only.
REASON_BURN = "burn"
REASON_PRESSURE = "pressure"
REASON_QUIET = "quiet"
REASON_STEADY = "steady"
REASON_COOLDOWN = "cooldown"
REASON_SIGNALS = "signals_unreadable"


@dataclasses.dataclass(frozen=True)
class ScaleSignals:
    """One poll of the autoscaling contract. ``pressure`` is None when
    the fleet scrape produced no pressure gauge (no traffic yet, or
    every replica scrape failed) — the controller treats that as
    neither hot nor quiet."""

    pressure: float | None
    fast_burn: float = 0.0
    slow_burn: float = 0.0


@dataclasses.dataclass(frozen=True)
class ScalePolicy:
    """Controller knobs, ``PIO_FLEET_*`` env-overridable at
    construction (docs/fleet.md "Autoscaling" has the table)."""

    min_replicas: int = _env_field("MIN_REPLICAS", 1, int)
    max_replicas: int = _env_field("MAX_REPLICAS", 4, int)
    #: scale-up triggers: queue-bound pressure, or the classic 5m-fast
    #: burn threshold for a 99.9% objective (14.4 = the page line)
    pressure_up: float = _env_field("PRESSURE_UP", 0.5, float)
    burn_up: float = _env_field("BURN_UP", 14.4, float)
    #: scale-down trigger: pressure at or below this AND both burn
    #: windows under 1.0 (budget spend at sustainable rate)
    pressure_down: float = _env_field("PRESSURE_DOWN", 0.1, float)
    #: how long a trigger must hold before it becomes a verdict
    up_sustain_s: float = _env_field("UP_SUSTAIN_S", 15.0, float)
    down_sustain_s: float = _env_field("DOWN_SUSTAIN_S", 120.0, float)
    #: minimum gap between ACTIONS (and dry-run verdicts): one hot
    #: scrape must not ratchet the fleet replica-by-replica
    cooldown_s: float = _env_field("COOLDOWN_S", 60.0, float)
    #: poll cadence of the background loop
    interval_s: float = _env_field("SCALE_INTERVAL_S", 5.0, float)
    #: export decisions without actuating (the rollout posture)
    dry_run: bool = False


class ScaleController:
    """Hysteresis policy loop over ``read_signals`` + an actuator
    (module docstring)."""

    def __init__(self, policy: ScalePolicy,
                 read_signals: Callable[[], ScaleSignals],
                 actuator, clock: Clock = SYSTEM_CLOCK):
        self.policy = policy
        self.read_signals = read_signals
        self.actuator = actuator
        self.clock = clock
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(DECISIONS, 0)
        #: ``(decision, reason) -> count`` — the attribution behind the
        #: per-engine decision counters; ``_counts`` stays the pinned
        #: unlabeled view
        self._reasons: dict[tuple[str, str], int] = {}
        self._last_decision: str | None = None
        self._last_reason: str | None = None
        self._hot_since: float | None = None
        self._quiet_since: float | None = None
        self._last_action_at: float | None = None
        self._desired: int | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- the decision engine --------------------------------------------------
    def tick(self) -> str:
        """One evaluation — the loop body and the deterministic test
        hook. Returns the decision taken."""
        p = self.policy
        now = self.clock.monotonic()
        try:
            signals = self.read_signals()
        except Exception as exc:  # noqa: BLE001 — a failed scrape is a held tick
            logger.warning("scale signals unreadable: %s", exc)
            return self._count(ERROR, REASON_SIGNALS)
        current = self.actuator.current()
        hot = ((signals.pressure is not None
                and signals.pressure >= p.pressure_up)
               or signals.fast_burn >= p.burn_up)
        quiet = (signals.pressure is not None
                 and signals.pressure <= p.pressure_down
                 and signals.fast_burn < 1.0 and signals.slow_burn < 1.0)
        if hot:
            if self._hot_since is None:     # not `or`: t=0 is a real time
                self._hot_since = now
            self._quiet_since = None
        elif quiet:
            if self._quiet_since is None:
                self._quiet_since = now
            self._hot_since = None
        else:
            # neither hot nor quiet resets BOTH sustain windows — the
            # hysteresis that keeps a flapping signal from scaling
            self._hot_since = self._quiet_since = None
        delta = 0
        if hot and now - self._hot_since >= p.up_sustain_s:
            delta = 1
        elif quiet and now - self._quiet_since >= p.down_sustain_s:
            delta = -1
        desired = min(p.max_replicas, max(p.min_replicas, current + delta))
        if desired == current:
            self._set_desired(desired)
            return self._count(HOLD, REASON_STEADY)
        with self._lock:
            last_action = self._last_action_at
        if last_action is not None and now - last_action < p.cooldown_s:
            self._set_desired(current)
            return self._count("cooldown_hold", REASON_COOLDOWN)
        # a verdict: record it, restart the sustain windows, and (when
        # not dry-running) actuate one step. The reason names the
        # TRIGGER: a scale-up is attributed to the fast-window burn when
        # it tripped (it outranks pressure in the arbiter too), else to
        # pressure; a scale-down is always "quiet" (both conditions must
        # hold by construction)
        self._set_desired(desired)
        with self._lock:
            self._last_action_at = now
        self._hot_since = self._quiet_since = None
        decision = UP if desired > current else DOWN
        reason = (REASON_QUIET if decision == DOWN
                  else REASON_BURN if signals.fast_burn >= p.burn_up
                  else REASON_PRESSURE)
        if p.dry_run:
            logger.info("scale %s verdict (dry-run): desired %d vs "
                        "actual %d", decision, desired, current)
            return self._count(decision, reason)
        acted = (self.actuator.add_replica() if decision == UP
                 else self.actuator.remove_replica())
        out = self._count(decision, reason)
        if not acted:
            # attribute the refusal AFTER the verdict so lastDecision
            # reads the failure: the actuator says why when it can
            # (ArbitratedActuator.last_refusal carries the arbiter's
            # budget verdict)
            self._count("actuation_failed",
                        getattr(self.actuator, "last_refusal", None)
                        or "actuator_refused")
            logger.warning("scale %s actuation failed (desired %d, "
                           "actual %d)", decision, desired, current)
        return out

    def _count(self, decision: str, reason: str) -> str:
        with self._lock:
            self._counts[decision] += 1
            key = (decision, reason)
            self._reasons[key] = self._reasons.get(key, 0) + 1
            self._last_decision = decision
            self._last_reason = reason
        return decision

    @property
    def last_action_at(self) -> float | None:
        """Clock time of the last up/down verdict — the arbiter's
        cooldown-seniority input (None = never acted)."""
        with self._lock:
            return self._last_action_at

    def _set_desired(self, desired: int) -> None:
        with self._lock:
            self._desired = desired

    # -- reporting ------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            desired = self._desired
            reasons = dict(self._reasons)
            last_decision = self._last_decision
            last_reason = self._last_reason
        by_reason: dict[str, dict[str, int]] = {}
        for (decision, reason), n in reasons.items():
            by_reason.setdefault(decision, {})[reason] = n
        return {
            "dryRun": self.policy.dry_run,
            "minReplicas": self.policy.min_replicas,
            "maxReplicas": self.policy.max_replicas,
            "desiredReplicas": desired,
            "actualReplicas": self.actuator.current(),
            "decisions": counts,
            "decisionReasons": by_reason,
            "lastDecision": last_decision,
            "lastReason": last_reason,
        }

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="pio-fleet-scaler", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.policy.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def controller_collector(controller: ScaleController):
    """Registry adapter: desired vs actual replica gauges + decision
    counters — the whole dry-run trust story is these families."""

    def collect() -> list[Metric]:
        snap = controller.snapshot()
        out = [
            Metric(name="pio_fleet_desired_replicas", kind="gauge",
                   help="Replica count the scale controller wants "
                        "(compare with pio_fleet_actual_replicas; in "
                        "--scale-dry-run only this moves)",
                   samples=[({}, float(snap["desiredReplicas"]
                                       if snap["desiredReplicas"]
                                       is not None
                                       else snap["actualReplicas"]))]),
            Metric(name="pio_fleet_actual_replicas", kind="gauge",
                   help="Replicas the actuator currently owns",
                   samples=[({}, float(snap["actualReplicas"]))]),
            Metric(name="pio_fleet_scale_dry_run", kind="gauge",
                   help="1 while the controller only exports verdicts",
                   samples=[({}, 1.0 if snap["dryRun"] else 0.0)]),
        ]
        decisions = Metric(
            name="pio_fleet_scale_decisions_total", kind="counter",
            help="Scale controller verdicts by outcome")
        for decision, n in sorted(snap["decisions"].items()):
            decisions.samples.append(({"decision": decision}, float(n)))
        out.append(decisions)
        return out

    return collect


# ---------------------------------------------------------------------------
# signal reader + the supervised-fleet actuator
# ---------------------------------------------------------------------------

def fleet_signals_reader(service) -> Callable[[], ScaleSignals]:
    """Read the autoscaling contract off the router's OWN merged fleet
    metrics — the controller consumes exactly what an external operator
    would scrape from ``GET /fleet/metrics`` (docs/fleet.md), so
    trusting the dry-run gauges means trusting the real inputs. The
    Metric families are consumed BEFORE text rendering
    (``fleet_metrics_families``): same scrape, same merge, without a
    render→reparse round-trip stealing serving CPU every tick. Burn
    rates come from the router's SLO engine (what clients experienced:
    sheds spend budget)."""

    def read() -> ScaleSignals:
        pressure: float | None = None
        for family in service.fleet_metrics_families():
            if family.name == "pio_fleet_pressure" and family.samples:
                pressure = family.samples[0][1]
        burns = service.slo.max_burns()
        return ScaleSignals(pressure=pressure,
                            fast_burn=burns.get("fast", 0.0),
                            slow_burn=burns.get("slow", 0.0))

    return read


class MembershipCountActuator:
    """Dry-run stand-in when no replica command is configured: the
    controller can still evaluate and export verdicts against the real
    membership count, but actuation always refuses (nothing owns the
    replicas)."""

    def __init__(self, membership, group: str = "stable"):
        self.membership = membership
        self.group = group

    def current(self) -> int:
        return sum(1 for b in self.membership.backends
                   if b.group == self.group)

    def add_replica(self) -> bool:
        return False

    def remove_replica(self, reason: str | None = None) -> bool:
        return False


class SupervisedFleetActuator:
    """Actuation against a supervisor-owned replica set.

    Scale-up: ``make_spec(index)`` yields a fresh :class:`SpawnSpec`
    (the CLI's ``--replica-cmd`` template), the supervisor spawns it,
    and its backend joins membership marked DOWN — the probe loop marks
    it up once it actually serves, so the router never races a replica
    that is still importing torch. Scale-down: newest-first victim,
    DETACHED from membership before the supervisor's drain-then-SIGTERM
    sequence, so no new traffic can land after the verdict."""

    def __init__(self, supervisor: FleetSupervisor, membership,
                 make_spec: Callable[[int], SpawnSpec],
                 breaker_threshold: int = 3, breaker_reset_s: float = 5.0,
                 clock: Clock = SYSTEM_CLOCK):
        self.supervisor = supervisor
        self.membership = membership
        self.make_spec = make_spec
        self.breaker_threshold = breaker_threshold
        self.breaker_reset_s = breaker_reset_s
        self.clock = clock
        self._lock = threading.Lock()
        #: spec ids this actuator owns, spawn order (LIFO victims)
        self._owned: list[str] = []
        self._index = itertools.count(1)

    def adopt(self, spec_id: str) -> None:
        """Register a replica spawned at launch time (the CLI's initial
        ``--replicas``) as scale-managed."""
        with self._lock:
            self._owned.append(spec_id)

    def current(self) -> int:
        """Owned replicas that still count as capacity — a crash-looped
        child is NOT capacity (scaling up past a latched spec is
        exactly what an operator wants while triaging it)."""
        with self._lock:
            owned = set(self._owned)
        return sum(1 for doc in self.supervisor.children()
                   if doc["id"] in owned and doc["state"] != CRASH_LOOPED)

    def add_replica(self) -> bool:
        with self._lock:
            owned = set(self._owned)
        if any(doc["id"] in owned and doc["state"] == CRASH_LOOPED
               for doc in self.supervisor.children()):
            # a latched child means the replica SPEC is broken: another
            # spawn of the same command would latch too, and since
            # latched children don't count as capacity the min-replica
            # clamp would demand a fresh (identically broken) spawn
            # every cooldown forever — leaking children and DOWN
            # backends. Refuse until an operator clears the crash loop;
            # desired>actual + actuation_failed climbing is the alarm.
            logger.warning(
                "scale-up refused: a crash-looped replica is latched "
                "(pio_fleet_crash_loop=1) — triage it before the "
                "controller spawns more of the same spec "
                "(docs/fleet.md crash-loop runbook)")
            return False
        spec = self.make_spec(next(self._index))
        if spec.address is None:
            logger.warning("replica spec %s has no address; cannot "
                           "join membership", spec.id)
            return False
        try:
            self.supervisor.add(spec)
        except Exception:
            logger.exception("scale-up spawn of %s failed", spec.id)
            return False
        backend = Backend(BackendSpec.parse(spec.address, spec.group),
                          breaker_threshold=self.breaker_threshold,
                          breaker_reset_s=self.breaker_reset_s,
                          clock=self.clock)
        # join DOWN: the membership probe loop marks it up when the
        # child actually answers /healthz + /readyz
        backend.mark_down("starting")
        self.membership.add(backend)
        with self._lock:
            self._owned.append(spec.id)
        logger.info("scale-up: replica %s spawning at %s", spec.id,
                    spec.address)
        return True

    def remove_replica(self, reason: str | None = None) -> bool:
        with self._lock:
            if not self._owned:
                return False
            spec_id = self._owned.pop()
        address = next((doc.get("address")
                        for doc in self.supervisor.children()
                        if doc["id"] == spec_id), None)
        if address is not None:
            # detach FIRST: this router stops routing there before the
            # drain begins (other routers notice via /readyz)
            self.membership.remove(address)
        self.supervisor.remove(spec_id, drain=True, reason=reason)
        logger.info("scale-down: replica %s drained and stopped%s",
                    spec_id, f" ({reason})" if reason else "")
        return True


# ---------------------------------------------------------------------------
# per-tenant elasticity: the arbiter, the per-engine policy resolver,
# and the scale set that runs one controller per engine group
# (docs/fleet.md "Per-tenant elasticity")
# ---------------------------------------------------------------------------

class CapacityArbiter:
    """The fleet-wide replica budget and its contention policy.

    Every per-engine scale-up flows through :meth:`request_up` (via
    :class:`ArbitratedActuator`). With ``budget == 0`` (unlimited) every
    request is granted — each engine's own ``max_replicas`` clamp is the
    only ceiling. With a budget, the arbiter enforces a GLOBAL device/
    HBM replica count across every registered tenant:

    - **used capacity** sums each tenant actuator's ``current()`` —
      which already excludes crash-looped children
      (:meth:`SupervisedFleetActuator.current`), so a latched replica
      frees its budget slot exactly as it stops counting as capacity;
    - when the budget is spent, a scale-up may **preempt** an IDLE
      tenant's above-min replica: the victim must be quiet (fast burn
      under 1.0, pressure under its own ``pressure_up``) and above its
      ``min_replicas`` floor, and it is retired through the actuator's
      drain-then-retire path — never killed. Hot-vs-hot contention is a
      deny, not a tug-of-war;
    - **priority** is burn-rate-weighted: fast-window burn beats
      pressure beats cooldown seniority (longest since last action
      wins ties) — both for picking the preemption victim (lowest
      priority) and for the scale set's tick ordering, so when two
      tenants want the last slot the hotter one asks first.
    """

    def __init__(self, budget: int = 0, clock: Clock = SYSTEM_CLOCK):
        self.budget = max(0, int(budget or 0))
        self.clock = clock
        self._lock = threading.Lock()
        self._tenants: dict[str, dict] = {}
        self._grants: dict[str, int] = {}
        self._denials: dict[str, int] = {}
        self._preemptions: dict[str, int] = {}

    def register(self, name: str, policy: ScalePolicy, actuator,
                 last_action: Callable[[], float | None] | None = None
                 ) -> None:
        with self._lock:
            self._tenants[name] = {
                "policy": policy, "actuator": actuator,
                "signals": None, "last_action": last_action,
            }

    def observe(self, name: str, signals: ScaleSignals | None) -> None:
        """The scale set pushes each engine's latest sweep signals here
        — one fleet scrape feeds N tenants AND the arbiter."""
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is not None:
                tenant["signals"] = signals

    def used(self) -> int:
        """Replicas currently counting against the budget (crash-looped
        children are excluded by the actuators themselves)."""
        with self._lock:
            actuators = [t["actuator"] for t in self._tenants.values()]
        return sum(a.current() for a in actuators)

    def priority(self, name: str) -> tuple[float, float, float]:
        """``(fast_burn, pressure, seniority)`` — compared
        lexicographically: burn beats pressure beats cooldown seniority
        (seconds since the tenant's last scale action; never-acted =
        infinitely senior)."""
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                return (0.0, 0.0, 0.0)
            signals = tenant["signals"]
            last_action = tenant["last_action"]
        fast = signals.fast_burn if signals is not None else 0.0
        pressure = (signals.pressure
                    if signals is not None and signals.pressure is not None
                    else 0.0)
        last = last_action() if last_action is not None else None
        seniority = (float("inf") if last is None
                     else self.clock.monotonic() - last)
        return (fast, pressure, seniority)

    def _bump(self, table: dict[str, int], name: str) -> None:
        with self._lock:
            table[name] = table.get(name, 0) + 1

    def _pick_victim(self, requester: str):
        """The lowest-priority IDLE tenant holding an above-min replica,
        or None. Idle = fast burn under 1.0 AND pressure under its own
        scale-up threshold (an unknown pressure — no traffic — is
        idle). ``current()`` is read outside the lock: actuators take
        their own locks and may call back into the supervisor."""
        with self._lock:
            items = [(name, dict(t)) for name, t in self._tenants.items()]
        candidates = []
        for name, tenant in items:
            if name == requester:
                continue
            signals = tenant["signals"]
            if signals is not None and signals.fast_burn >= 1.0:
                continue
            if signals is not None and signals.pressure is not None \
                    and signals.pressure >= tenant["policy"].pressure_up:
                continue
            if tenant["actuator"].current() <= tenant["policy"].min_replicas:
                continue
            candidates.append((name, tenant["actuator"]))
        if not candidates:
            return None
        return min(candidates, key=lambda nv: self.priority(nv[0]))

    def request_up(self, name: str) -> tuple[bool, str]:
        """``(granted, reason)`` — reason is the attribution string the
        controller counts on denial (``budget_exhausted``) and the log
        line on preemption (``preempted_<victim>``)."""
        if self.budget <= 0:
            self._bump(self._grants, name)
            return True, "unbudgeted"
        if self.used() < self.budget:
            self._bump(self._grants, name)
            return True, "within_budget"
        victim = self._pick_victim(name)
        if victim is not None:
            victim_name, actuator = victim
            # drain-then-retire, never kill: the victim's replica goes
            # through the actuator's detach-membership-first +
            # supervisor-drain sequence, same as any scale-down
            if actuator.remove_replica(
                    reason=f"preempted_by_{name}"):
                self._bump(self._preemptions, victim_name)
                self._bump(self._grants, name)
                logger.info(
                    "budget preemption: %s's above-min replica drained "
                    "for high-priority tenant %s", victim_name, name)
                return True, f"preempted_{victim_name}"
        self._bump(self._denials, name)
        return False, "budget_exhausted"

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "budget": self.budget or None,
                "grants": dict(self._grants),
                "denials": dict(self._denials),
                "preemptions": dict(self._preemptions),
            }


class ArbitratedActuator:
    """Wraps a tenant's actuator so every scale-up consults the
    :class:`CapacityArbiter` first. On denial, ``last_refusal`` carries
    the arbiter's verdict for the controller's ``actuation_failed``
    attribution."""

    def __init__(self, name: str, inner, arbiter: CapacityArbiter):
        self.name = name
        self.inner = inner
        self.arbiter = arbiter
        self.last_refusal: str | None = None

    def current(self) -> int:
        return self.inner.current()

    def add_replica(self) -> bool:
        granted, verdict = self.arbiter.request_up(self.name)
        if not granted:
            self.last_refusal = verdict
            return False
        if self.inner.add_replica():
            self.last_refusal = None
            return True
        self.last_refusal = getattr(self.inner, "last_refusal", None) \
            or "actuator_refused"
        return False

    def remove_replica(self, reason: str | None = None) -> bool:
        return self.inner.remove_replica(reason=reason)


#: ScalePolicy field -> (env key suffix, cast) for the per-engine
#: ``PIO_FLEET_ENGINE_<NAME>_<KEY>`` overrides — same suffixes as the
#: global ``PIO_FLEET_<KEY>`` table (docs/fleet.md)
_POLICY_ENV_KEYS: dict[str, tuple[str, type]] = {
    "min_replicas": ("MIN_REPLICAS", int),
    "max_replicas": ("MAX_REPLICAS", int),
    "pressure_up": ("PRESSURE_UP", float),
    "burn_up": ("BURN_UP", float),
    "pressure_down": ("PRESSURE_DOWN", float),
    "up_sustain_s": ("UP_SUSTAIN_S", float),
    "down_sustain_s": ("DOWN_SUSTAIN_S", float),
    "cooldown_s": ("COOLDOWN_S", float),
    "interval_s": ("SCALE_INTERVAL_S", float),
}


def engine_scale_policy(name: str, dry_run: bool = False,
                        base: dict | None = None,
                        **overrides) -> ScalePolicy:
    """Resolve one tenant's :class:`ScalePolicy` with the documented
    precedence: explicit per-engine override (the ``--engine
    ...,min-replicas=,max-replicas=`` flag keys) beats
    ``PIO_FLEET_ENGINE_<NAME>_<KEY>`` env beats the router-wide
    ``base`` (the global ``--scale-*`` flags) beats the global
    ``PIO_FLEET_<KEY>`` env/defaults that :class:`ScalePolicy` itself
    reads. Engine names sanitize to env tokens by replacing every
    non-alphanumeric with ``_`` and upper-casing (``rec-v2`` →
    ``REC_V2``)."""
    token = re.sub(r"[^A-Za-z0-9]", "_", name).upper()
    kwargs = {k: v for k, v in overrides.items() if v is not None}
    for field, (key, cast) in _POLICY_ENV_KEYS.items():
        if field in kwargs:
            continue
        raw = os.environ.get(f"PIO_FLEET_ENGINE_{token}_{key}")
        if raw is not None:
            try:
                kwargs[field] = cast(raw)
                continue
            except ValueError:
                logger.warning(
                    "ignoring unparseable PIO_FLEET_ENGINE_%s_%s=%r",
                    token, key, raw)
        if base and base.get(field) is not None:
            kwargs[field] = base[field]
    return ScalePolicy(dry_run=dry_run, **kwargs)


class EngineScaleSet:
    """One :class:`ScaleController` per engine group under a shared
    :class:`CapacityArbiter` — the per-tenant elasticity loop
    (docs/fleet.md).

    Each tenant keeps its OWN hysteresis, sustain windows, cooldown and
    min/max bounds (engine A's cooldown never delays engine B), but the
    sweep is shared: ``tick_all`` fetches the router's merged fleet
    metric families ONCE, splits the per-engine ``pio_fleet_pressure``
    samples and per-engine SLO burns out of the one scrape, pushes each
    tenant's signals to the arbiter, then ticks the controllers in
    DESCENDING priority order — when two hot tenants want the last
    budget slot, the burn-weighted winner asks first. One scrape per
    sweep, not per tenant: N engines cost the same fan-out as one."""

    def __init__(self, service, arbiter: CapacityArbiter,
                 interval_s: float = 5.0, clock: Clock = SYSTEM_CLOCK):
        self.service = service
        self.arbiter = arbiter
        self.interval_s = interval_s
        self.clock = clock
        self._lock = threading.Lock()
        self._controllers: dict[str, ScaleController] = {}
        #: latest sweep's per-engine signals; readers raise on a missing
        #: entry so a failed sweep counts an ERROR tick per controller
        self._sweep: dict[str, ScaleSignals] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def gateway(self):
        return self.service.gateway

    def add_engine(self, name: str, policy: ScalePolicy,
                   actuator) -> ScaleController:
        """Register one tenant: its actuator is wrapped so scale-ups
        consult the arbiter, and its controller reads signals from the
        shared sweep cache."""
        wrapped = ArbitratedActuator(name, actuator, self.arbiter)
        controller = ScaleController(
            policy, self._reader_for(name), wrapped, clock=self.clock)
        self.arbiter.register(
            name, policy, wrapped,
            last_action=lambda: controller.last_action_at)
        with self._lock:
            self._controllers[name] = controller
        return controller

    def controllers(self) -> dict[str, ScaleController]:
        with self._lock:
            return dict(self._controllers)

    def get(self, name: str) -> ScaleController | None:
        with self._lock:
            return self._controllers.get(name)

    def _reader_for(self, name: str) -> Callable[[], ScaleSignals]:
        def read() -> ScaleSignals:
            with self._lock:
                signals = self._sweep.get(name)
            if signals is None:
                raise RuntimeError(
                    f"no fleet signals for engine {name!r} this sweep")
            return signals

        return read

    def sweep_signals(self) -> dict[str, ScaleSignals]:
        """ONE fleet scrape split per engine: the labeled
        ``pio_fleet_pressure{engine}`` samples (the unlabeled sample
        serves the lone implicit default engine) plus each engine
        group's own SLO burn windows."""
        with self._lock:
            names = list(self._controllers)
        pressures: dict[str | None, float] = {}
        for family in self.service.fleet_metrics_families():
            if family.name != "pio_fleet_pressure":
                continue
            for labels, value in family.samples:
                pressures[labels.get("engine")] = value
        gateway = self.service.gateway
        sweep: dict[str, ScaleSignals] = {}
        for name in names:
            pressure = pressures.get(name)
            if pressure is None and not gateway.labeled:
                pressure = pressures.get(None)
            group = gateway.get(name)
            burns = group.slo.max_burns() if group is not None else {}
            sweep[name] = ScaleSignals(
                pressure=pressure,
                fast_burn=burns.get("fast", 0.0),
                slow_burn=burns.get("slow", 0.0))
        return sweep

    def tick_all(self) -> list[str]:
        """One sweep — the loop body and the deterministic test hook.
        Returns the engine names in the order they were ticked."""
        try:
            sweep = self.sweep_signals()
        except Exception as exc:  # noqa: BLE001 — a failed sweep holds every tenant
            logger.warning("fleet sweep unreadable: %s", exc)
            sweep = {}
        with self._lock:
            self._sweep = sweep
            controllers = dict(self._controllers)
        for name in controllers:
            self.arbiter.observe(name, sweep.get(name))
        # descending priority: the hottest tenant's scale-up reaches
        # the arbiter first, so "two tenants want the last slot" is
        # decided by burn > pressure > seniority, not dict order
        order = sorted(controllers,
                       key=self.arbiter.priority, reverse=True)
        for name in order:
            controllers[name].tick()
        return order

    def snapshot(self) -> dict:
        with self._lock:
            controllers = dict(self._controllers)
        return {
            "budget": self.arbiter.budget or None,
            "used": self.arbiter.used(),
            "arbiter": self.arbiter.snapshot(),
            "engines": {name: controller.snapshot()
                        for name, controller in controllers.items()},
        }

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="pio-fleet-scale-set", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.tick_all()
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def scale_set_collector(scale_set: EngineScaleSet):
    """Registry adapter for the per-tenant loop. A lone implicit
    default engine delegates to :func:`controller_collector` — the
    unlabeled exposition stays byte-identical.
    Explicitly multi-engine deployments export the same families with
    an ``engine`` label, the decision counters gain ``reason``
    attribution, and the budget/arbiter families appear."""

    def collect() -> list[Metric]:
        from predictionio_tpu_torch.obs.registry import merge_families

        controllers = scale_set.controllers()
        if not scale_set.gateway.labeled and len(controllers) == 1:
            (controller,) = controllers.values()
            return controller_collector(controller)()
        desired = Metric(
            name="pio_fleet_desired_replicas", kind="gauge",
            help="Replica count the scale controller wants "
                 "(compare with pio_fleet_actual_replicas; in "
                 "--scale-dry-run only this moves)")
        actual = Metric(
            name="pio_fleet_actual_replicas", kind="gauge",
            help="Replicas the actuator currently owns")
        dry = Metric(
            name="pio_fleet_scale_dry_run", kind="gauge",
            help="1 while the controller only exports verdicts")
        decisions = Metric(
            name="pio_fleet_scale_decisions_total", kind="counter",
            help="Scale controller verdicts by engine, outcome and "
                 "reason (docs/fleet.md \"Per-tenant elasticity\")")
        for name, controller in controllers.items():
            snap = controller.snapshot()
            labels = {"engine": name}
            desired.samples.append(
                (labels, float(snap["desiredReplicas"]
                               if snap["desiredReplicas"] is not None
                               else snap["actualReplicas"])))
            actual.samples.append((labels, float(snap["actualReplicas"])))
            dry.samples.append((labels, 1.0 if snap["dryRun"] else 0.0))
            for decision, reasons in sorted(
                    snap["decisionReasons"].items()):
                for reason, n in sorted(reasons.items()):
                    decisions.samples.append(
                        ({"engine": name, "decision": decision,
                          "reason": reason}, float(n)))
        arbiter = scale_set.arbiter.snapshot()
        budget = Metric(
            name="pio_fleet_replica_budget", kind="gauge",
            help="Fleet-wide replica budget the CapacityArbiter "
                 "enforces (0 = unlimited)",
            samples=[({}, float(arbiter["budget"] or 0))])
        used = Metric(
            name="pio_fleet_replica_budget_used", kind="gauge",
            help="Replicas currently counting against the budget "
                 "(crash-looped children excluded)",
            samples=[({}, float(scale_set.arbiter.used()))])
        preempt = Metric(
            name="pio_fleet_preemptions_total", kind="counter",
            help="Above-min replicas drained from this (victim) engine "
                 "to free budget for a higher-priority tenant")
        denials = Metric(
            name="pio_fleet_budget_denials_total", kind="counter",
            help="Scale-ups the arbiter refused for lack of budget "
                 "and preemptable capacity")
        for name, n in sorted(arbiter["preemptions"].items()):
            preempt.samples.append(({"engine": name}, float(n)))
        for name, n in sorted(arbiter["denials"].items()):
            denials.samples.append(({"engine": name}, float(n)))
        return merge_families(
            [desired, actual, dry, decisions, budget, used, preempt,
             denials])

    return collect
