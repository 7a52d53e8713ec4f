"""ExperimentController: online A/B over gateway engines, one verdict (a
copy of the JAX package's ``experiment/controller.py``).

``pio experiment`` deploys top-k grid points as named engines behind
the multi-tenant gateway; this controller owns what happens next:

    define → ramp → measure → promote | abort

- **define** — variants (engine name + traffic weight + the grid
  point they came from) are registered; the experiment immediately
  starts splitting bare-path query traffic by weight.
- **ramp** — guardrails are live (a breaching variant auto-aborts,
  exactly the CanaryController discipline, one controller per
  variant) but no promotion verdict is taken: the first
  ``ramp_s`` seconds are warmup — caches fill, JITs compile — and
  must not decide an experiment.
- **measure** — after ``measure_s`` seconds AND ``min_requests``
  routed outcomes on every surviving variant, each survivor gets an
  online score: success rate folded with conversion rate
  (``conversion_weight``), conversions arriving through the
  attribution loop (docs/experimentation.md). Best score wins.
- **promote** — the winner becomes the gateway default engine and the
  losers are retired; **abort** — every variant breached, nothing is
  promoted, the default engine is untouched.

Coherence: like the canary plane, outcome WINDOWS stay local to each
worker — only verdicts (variant aborts, state transitions, the
decision) and conversion counts (which arrive over the admin endpoint,
not per-request) ride the seq'd cumulative ``experiment`` doc on the
worker admin spool. Whichever ``--workers`` sibling first satisfies
the decision thresholds decides; the others adopt, and a respawned
worker adopts the verdict from the spool before serving (the e2e test
pins that round-trip).

Time is injectable (:class:`~predictionio_tpu_torch.utils.resilience.Clock`)
so the whole lifecycle runs under ``ManualClock`` in tests; the
controller never sleeps — ticks ride the router's admin sync loop,
which waits on an Event (the banned-sleep lint contract over
``experiment/``).
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
from typing import Callable, Sequence

from predictionio_tpu_torch.fleet.canary import CanaryController, GuardrailConfig
from predictionio_tpu_torch.obs.registry import Metric
from predictionio_tpu_torch.utils.envcfg import env_field
from predictionio_tpu_torch.utils.resilience import SYSTEM_CLOCK, Clock

logger = logging.getLogger(__name__)

#: experiment lifecycle states
RAMP, MEASURE, PROMOTED, ABORTED = "RAMP", "MEASURE", "PROMOTED", "ABORTED"

#: attribution surface: response/request headers + body fields
EXPERIMENT_HEADER = "X-PIO-Experiment"
VARIANT_HEADER = "X-PIO-Variant"
EXPERIMENT_FIELD = "experimentId"
VARIANT_FIELD = "variantId"


def _env_field(key: str, default, cast):
    return env_field("PIO_EXPERIMENT_", key, default, cast)


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """One experiment arm: a named gateway engine plus where it came
    from (the grid point index and offline score, for the runbook)."""

    name: str
    weight_pct: float
    grid_idx: int = -1
    offline_score: float | None = None

    def to_doc(self) -> dict:
        return {"name": self.name, "weightPct": self.weight_pct,
                "gridIdx": self.grid_idx, "offlineScore": self.offline_score}

    @classmethod
    def from_doc(cls, doc: dict) -> "VariantSpec":
        return cls(name=str(doc["name"]),
                   weight_pct=float(doc.get("weightPct", 0.0)),
                   grid_idx=int(doc.get("gridIdx", -1)),
                   offline_score=doc.get("offlineScore"))


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Lifecycle knobs (``PIO_EXPERIMENT_*`` env-overridable defaults,
    the ServerConfig discipline)."""

    name: str
    #: warmup before the measure clock starts — guardrails live,
    #: verdicts not
    ramp_s: float = _env_field("RAMP_S", 5.0, float)
    #: minimum measure period before any promotion verdict
    measure_s: float = _env_field("MEASURE_S", 30.0, float)
    #: routed outcomes required on EVERY surviving variant
    min_requests: int = _env_field("MIN_REQUESTS", 20, int)
    #: how much of the online score is conversion rate (0..1);
    #: the rest is success rate
    conversion_weight: float = _env_field("CONVERSION_WEIGHT", 0.5, float)
    guardrail: GuardrailConfig = dataclasses.field(
        default_factory=GuardrailConfig)

    def to_doc(self) -> dict:
        g = self.guardrail
        return {"name": self.name, "rampS": self.ramp_s,
                "measureS": self.measure_s,
                "minRequests": self.min_requests,
                "conversionWeight": self.conversion_weight,
                "guardrail": {"minRequests": g.min_requests,
                              "maxErrorRate": g.max_error_rate,
                              "maxP99Ms": g.max_p99_ms,
                              "window": g.window}}

    @classmethod
    def from_doc(cls, doc: dict) -> "ExperimentConfig":
        g = doc.get("guardrail") or {}
        return cls(
            name=str(doc["name"]),
            ramp_s=float(doc.get("rampS", 5.0)),
            measure_s=float(doc.get("measureS", 30.0)),
            min_requests=int(doc.get("minRequests", 20)),
            conversion_weight=float(doc.get("conversionWeight", 0.5)),
            guardrail=GuardrailConfig(
                min_requests=int(g.get("minRequests", 20)),
                max_error_rate=float(g.get("maxErrorRate", 0.5)),
                max_p99_ms=float(g.get("maxP99Ms", 0.0)),
                window=int(g.get("window", 200))))


class _Variant:
    """Mutable per-arm state: the guardrail rides a CanaryController
    (window + breach + abort latch, all its tested semantics) with the
    variant's traffic weight standing in for the canary weight."""

    def __init__(self, spec: VariantSpec,
                 guardrail: GuardrailConfig,
                 rng: random.Random | None = None):
        self.spec = spec
        self.canary = CanaryController(weight_pct=max(0.1, spec.weight_pct),
                                       guardrail=guardrail, rng=rng)
        self.requests = 0
        self.errors = 0
        self.conversions = 0

    @property
    def aborted(self) -> bool:
        return self.canary.aborted

    def success_rate(self) -> float:
        if self.requests <= 0:
            return 0.0
        return (self.requests - self.errors) / self.requests

    def conversion_rate(self) -> float:
        if self.requests <= 0:
            return 0.0
        return min(1.0, self.conversions / self.requests)


class ExperimentController:
    """The lifecycle state machine (module docstring). All state under
    one lock; gateway actions and the change callback run OUTSIDE it
    (the gateway has its own lock, and ``on_change`` re-enters
    :meth:`state_doc`)."""

    def __init__(self, gateway=None, clock: Clock = SYSTEM_CLOCK,
                 rng: random.Random | None = None,
                 on_change: Callable[[], None] | None = None):
        self._gateway = gateway
        self._clock = clock
        self._rng = rng or random.Random()
        self.on_change = on_change
        self._lock = threading.Lock()
        self._seq = 0
        self._config: ExperimentConfig | None = None
        self._variants: dict[str, _Variant] = {}
        self._state = ""
        self._started_at = 0.0
        self._measure_started_at = 0.0
        self._decision: dict | None = None

    # -- lifecycle -----------------------------------------------------------
    def define(self, config: ExperimentConfig,
               variants: Sequence[VariantSpec]) -> None:
        """Start (or replace) THE experiment: traffic splits
        immediately, the ramp clock starts now."""
        if not variants:
            raise ValueError("an experiment needs at least one variant")
        names = [v.name for v in variants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate variant names: {names}")
        with self._lock:
            self._config = config
            self._variants = {
                v.name: _Variant(v, config.guardrail, rng=self._rng)
                for v in variants}
            self._state = RAMP
            self._started_at = self._clock.monotonic()
            self._measure_started_at = 0.0
            self._decision = None
            self._seq += 1
        logger.info("experiment %s: RAMP with variants %s",
                    config.name, names)
        self._changed()

    def abort(self, reason: str = "operator abort") -> None:
        with self._lock:
            if self._config is None or self._state in (PROMOTED, ABORTED):
                return
            for variant in self._variants.values():
                if not variant.aborted:
                    variant.canary.abort(reason)
            self._state = ABORTED
            self._decision = {"winner": None, "reason": reason,
                              "at": self._clock.monotonic()}
            self._seq += 1
        self._changed()

    # -- routing -------------------------------------------------------------
    def assign(self) -> tuple[str, str] | None:
        """Pick a variant for one bare-path query: weighted among the
        surviving arms. Returns ``(experiment, variant)`` or None when
        no experiment is splitting traffic."""
        with self._lock:
            if self._config is None or self._state not in (RAMP, MEASURE):
                return None
            live = [v for v in self._variants.values() if not v.aborted]
            if not live:
                return None
            total = sum(max(0.0, v.spec.weight_pct) for v in live)
            if total <= 0.0:
                choice = live[0]
            else:
                roll = self._rng.random() * total
                acc = 0.0
                choice = live[-1]
                for v in live:
                    acc += max(0.0, v.spec.weight_pct)
                    if roll < acc:
                        choice = v
                        break
            return (self._config.name, choice.spec.name)

    # -- outcome + conversion feed -------------------------------------------
    def record(self, variant: str, ok: bool, latency_s: float) -> bool:
        """Fold one routed outcome into the variant's window; returns
        True when THIS sample tripped the variant's guardrail (the
        abort is already latched and published)."""
        with self._lock:
            v = self._variants.get(variant)
            if v is None or self._state not in (RAMP, MEASURE):
                return False
            v.requests += 1
            if not ok:
                v.errors += 1
            tripped = v.canary.record("canary", ok, latency_s)
            if tripped:
                self._seq += 1
                name = self._config.name if self._config else "?"
        if tripped:
            logger.warning("experiment %s: variant %s auto-aborted",
                           name, variant)
            self._changed()
        self.tick()
        return tripped

    def record_conversions(self, variant: str, count: int) -> bool:
        """Fold attributed conversions in (from the admin endpoint —
        ``pio experiment conversions`` tails the event store and posts
        per-variant totals). Cumulative: ``count`` is the variant's
        TOTAL so far; adoption takes the max, so replays and sibling
        spools never double-count."""
        with self._lock:
            v = self._variants.get(variant)
            if v is None:
                return False
            if count <= v.conversions:
                return True
            v.conversions = int(count)
            self._seq += 1
        self._changed()
        self.tick()
        return True

    def online_score(self, v: _Variant) -> float:
        w = self._config.conversion_weight if self._config else 0.5
        w = min(1.0, max(0.0, w))
        return (1.0 - w) * v.success_rate() + w * v.conversion_rate()

    # -- the state machine ---------------------------------------------------
    def tick(self) -> bool:
        """Advance the lifecycle on the injected clock; returns True
        when the state changed. Called from the router's admin sync
        loop and opportunistically from the outcome feed."""
        actions: list[tuple[str, str]] = []
        changed = False
        with self._lock:
            if self._config is None or self._state in (PROMOTED, ABORTED):
                return False
            now = self._clock.monotonic()
            live = [v for v in self._variants.values() if not v.aborted]
            if not live:
                # every arm breached: nothing to promote
                self._state = ABORTED
                self._decision = {"winner": None, "at": now,
                                  "reason": "all variants aborted"}
                actions = [("retire", v.spec.name)
                           for v in self._variants.values()]
                self._seq += 1
                changed = True
            elif self._state == RAMP:
                if now - self._started_at >= self._config.ramp_s:
                    self._state = MEASURE
                    self._measure_started_at = now
                    self._seq += 1
                    changed = True
            elif self._state == MEASURE:
                ready = (now - self._measure_started_at
                         >= self._config.measure_s
                         and all(v.requests >= self._config.min_requests
                                 for v in live))
                if ready:
                    winner = max(live, key=self.online_score)
                    self._state = PROMOTED
                    self._decision = {
                        "winner": winner.spec.name, "at": now,
                        "reason": (f"online score "
                                   f"{self.online_score(winner):.4f}"),
                        "scores": {v.spec.name:
                                   round(self.online_score(v), 6)
                                   for v in self._variants.values()}}
                    actions = [("default", winner.spec.name)] + [
                        ("retire", v.spec.name)
                        for v in self._variants.values()
                        if v.spec.name != winner.spec.name]
                    self._seq += 1
                    changed = True
            if changed:
                state, name = self._state, self._config.name
        if changed:
            logger.info("experiment %s: %s%s", name, state,
                        f" — {self._decision}" if self._decision else "")
            self._apply_gateway(actions)
            self._changed()
        return changed

    def _apply_gateway(self, actions: list[tuple[str, str]]) -> None:
        """Promotion = default-engine switch + loser retire on the
        gateway. Idempotent under the sibling race: whoever decides
        first wins, a second application is a no-op (the retire of an
        already-retired engine raises KeyError, the default switch to
        the current default is harmless)."""
        if self._gateway is None:
            return
        for action, engine in actions:
            try:
                if action == "default":
                    self._gateway.set_default(engine)
                else:
                    self._gateway.retire(engine)
            except (KeyError, ValueError) as exc:
                logger.info("experiment gateway %s(%s) skipped: %s",
                            action, engine, exc)

    def _changed(self) -> None:
        cb = self.on_change
        if cb is not None:
            cb()

    # -- shared-admin-state round-trip (api/router_server.py) ----------------
    def state_doc(self) -> dict | None:
        """The experiment as a seq'd cumulative document for the worker
        admin spool; None when nothing was ever defined."""
        with self._lock:
            if self._config is None:
                return None
            return {
                "seq": self._seq,
                "state": self._state,
                "config": self._config.to_doc(),
                "startedAt": self._started_at,
                "measureStartedAt": self._measure_started_at,
                "decision": dict(self._decision) if self._decision else None,
                "variants": [
                    {**v.spec.to_doc(),
                     "aborted": v.aborted,
                     "conversions": v.conversions}
                    for v in self._variants.values()],
            }

    def adopt_state(self, doc: dict | None) -> bool:
        """Diff-apply a sibling's :meth:`state_doc`: only a NEWER seq
        mutates, local outcome windows survive (adopting a variant's
        abort latch goes through the canary's own diff-applying
        ``adopt_state``), and conversion counts merge by max.
        Malformed documents are ignored — a torn spool entry must
        never take the experiment plane down."""
        if not isinstance(doc, dict):
            return False
        try:
            seq = int(doc["seq"])
            config = ExperimentConfig.from_doc(doc["config"])
            state = str(doc["state"])
            variant_docs = list(doc["variants"])
        except (KeyError, TypeError, ValueError) as exc:
            logger.warning("ignoring malformed experiment doc: %s", exc)
            return False
        with self._lock:
            if seq <= self._seq:
                return False
            fresh = (self._config is None
                     or self._config.name != config.name
                     or set(self._variants)
                     != {str(d.get("name")) for d in variant_docs})
            if fresh:
                self._variants = {}
            self._config = config
            self._state = state
            self._started_at = float(doc.get("startedAt") or 0.0)
            self._measure_started_at = float(
                doc.get("measureStartedAt") or 0.0)
            decision = doc.get("decision")
            self._decision = dict(decision) \
                if isinstance(decision, dict) else None
            for vdoc in variant_docs:
                try:
                    spec = VariantSpec.from_doc(vdoc)
                except (KeyError, TypeError, ValueError):
                    continue
                v = self._variants.get(spec.name)
                if v is None:
                    v = _Variant(spec, config.guardrail, rng=self._rng)
                    self._variants[spec.name] = v
                else:
                    v.spec = spec
                if bool(vdoc.get("aborted")) and not v.aborted:
                    v.canary.abort("sibling abort (spool)")
                v.conversions = max(v.conversions,
                                    int(vdoc.get("conversions") or 0))
            self._seq = seq
        return True

    # -- observability -------------------------------------------------------
    def snapshot(self) -> dict | None:
        """The operator view (``pio status --router`` / GET
        /fleet/experiments): lifecycle + per-variant online evidence."""
        with self._lock:
            if self._config is None:
                return None
            return {
                "name": self._config.name,
                "state": self._state,
                "seq": self._seq,
                "decision": dict(self._decision) if self._decision else None,
                "variants": [
                    {"name": v.spec.name,
                     "weightPct": v.spec.weight_pct,
                     "gridIdx": v.spec.grid_idx,
                     "offlineScore": v.spec.offline_score,
                     "aborted": v.aborted,
                     "requests": v.requests,
                     "errors": v.errors,
                     "conversions": v.conversions,
                     "onlineScore": round(self.online_score(v), 6)}
                    for v in self._variants.values()],
            }

    def collector(self) -> list[Metric]:
        """``pio_experiment_state{experiment,variant}`` (0=aborted,
        1=serving, 2=promoted winner) + per-variant conversion/request
        counters + the online score gauge, for the router /metrics."""
        with self._lock:
            if self._config is None:
                return []
            name = self._config.name
            winner = (self._decision or {}).get("winner")
            state_samples, conv, reqs, scores = [], [], [], []
            for v in self._variants.values():
                labels = {"experiment": name, "variant": v.spec.name}
                code = 0.0 if v.aborted else \
                    (2.0 if v.spec.name == winner else 1.0)
                state_samples.append((labels, code))
                conv.append((labels, float(v.conversions)))
                reqs.append((labels, float(v.requests)))
                scores.append((labels, self.online_score(v)))
        return [
            Metric("pio_experiment_state", "gauge",
                   "Experiment variant state: 0 aborted, 1 serving, "
                   "2 promoted winner.", samples=state_samples),
            Metric("pio_experiment_conversions_total", "counter",
                   "Attributed conversions folded into each variant's "
                   "online score.", samples=conv),
            Metric("pio_experiment_requests_total", "counter",
                   "Routed outcomes recorded per experiment variant.",
                   samples=reqs),
            Metric("pio_experiment_online_score", "gauge",
                   "Current per-variant online score (success rate "
                   "folded with conversion rate).", samples=scores),
        ]
