"""Multi-tenant gateway: one router, many engines (a copy of the JAX
package's ``fleet/gateway.py``).

The reference PredictionIO serves many apps/engines but makes each
deployed engine its own process+port. The gateway puts N engines behind
one ``pio router``: an **EngineTable** maps engine names to fully independent
backend groups —

- each engine gets its OWN :class:`~predictionio_tpu_torch.fleet.membership.
  FleetMembership` (probe loop + hysteresis), per-replica breakers,
  :class:`~predictionio_tpu_torch.fleet.canary.CanaryController`, hedging
  state and :class:`~predictionio_tpu_torch.fleet.stats.RouterStats` — a
  dying tenant's probes, breakers and canary verdicts never touch a
  sibling's (blast-radius isolation);
- requests select the engine by **path**
  (``/engines/<name>/queries.json``) or the ``X-PIO-Engine`` header;
  bare ``/queries.json`` keeps routing to the configured DEFAULT
  engine, so every existing single-engine client, test and bench is
  untouched;
- admission is **per-app fair**: a token-bucket quota per engine
  (qps + burst + per-engine in-flight cap, env/CLI-tunable) answers
  over-quota requests with ``429 + Retry-After``, while the 503 shed
  stays a GLOBAL-pressure verdict through ONE shared
  :class:`~predictionio_tpu_torch.fleet.router.AdmissionGate` — one tenant's
  burst spends its own budget, never a sibling's;
- the table mutates at runtime (``POST /fleet/engines``: register /
  retire / re-weight) and propagates across ``--workers`` siblings via
  the seq'd admin-state spool (``fleet/workers.py``) as a CUMULATIVE
  document, so a
  respawned worker adopts the WHOLE table at boot, not the launch-time
  config.

Route resolution is a precompiled O(1) dict hit on the request path:
the route table is REBUILT (a fresh dict, atomically swapped) on every
table mutation, so the per-request cost is one ``dict.get`` and — for
bare ``/queries.json`` only — one header lookup. No per-request regex,
no allocation. Mutation-vs-read safety rides the CPython object-swap
contract (readers grab the current dict reference once), the same
discipline as the serving-path codec tables.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import threading
from typing import Mapping

from predictionio_tpu_torch.api.http_base import retry_after_header
from predictionio_tpu_torch.fleet.router import (
    AdmissionGate,
    FleetRouter,
    RouterConfig,
    RouterResponse,
)
from predictionio_tpu_torch.fleet.stats import router_collector
from predictionio_tpu_torch.obs.aggregate import relabel
from predictionio_tpu_torch.obs.registry import Metric
from predictionio_tpu_torch.obs.slo import SLOEngine, labeled_burn_metric
from predictionio_tpu_torch.obs.trace import active_trace
from predictionio_tpu_torch.utils.resilience import SYSTEM_CLOCK, Clock

logger = logging.getLogger(__name__)

#: bare query path — routes to the default engine
QUERIES_PATH = "/queries.json"
#: engine selection header for bare-path clients (lower-cased at the
#: router's single-buffer parser, so the lookup key is lower too)
ENGINE_HEADER = "X-PIO-Engine"
_ENGINE_HEADER_LC = ENGINE_HEADER.lower()

#: engine names share the request-id charset discipline: path- and
#: label-safe, bounded (validated at REGISTRATION time only — the
#: request path never pays a regex; an invalid name in a path or
#: header simply misses the table and 404s)
ENGINE_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

DEFAULT_ENGINE = "default"

#: fraction of the shared admission gate that must be free before a
#: tenant may spend burst credits — borrowed capacity must be capacity
#: nobody else is queueing for (an uncapped gate always has headroom)
FLEET_IDLE_HEADROOM = 0.5


def engine_query_path(name: str) -> str:
    return f"/engines/{name}/queries.json"


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One tenant's declaration: its backend groups, launch canary
    weight, and admission quota. Quota fields default to ``None`` =
    inherit the router-wide ``PIO_ROUTER_ENGINE_*`` defaults; ``0`` is
    an EXPLICIT unlimited."""

    name: str
    backends: tuple[str, ...] = ()
    canary_backends: tuple[str, ...] = ()
    canary_weight_pct: float = 0.0
    #: token-bucket rate (requests/second); None inherits, 0 unlimited
    quota_qps: float | None = None
    #: bucket depth; None inherits (then max(1, qps))
    quota_burst: float | None = None
    #: per-engine concurrent in-flight cap; None inherits, 0 uncapped
    max_inflight: int | None = None
    #: burst-credit reservoir cap (weighted fair queueing): unused
    #: quota accrues as credits, spendable during a burst while the
    #: fleet has headroom; None inherits ``PIO_ROUTER_ENGINE_BURST_
    #: CREDITS``, 0 disables (docs/fleet.md "Per-tenant elasticity")
    burst_credits: float | None = None
    #: per-engine scale bounds consumed by the elasticity loop
    #: (fleet/controller.py EngineScaleSet); None inherits the global
    #: PIO_FLEET_MIN/MAX_REPLICAS defaults
    min_replicas: int | None = None
    max_replicas: int | None = None

    def __post_init__(self):
        if not ENGINE_NAME_RE.match(self.name):
            raise ValueError(
                f"engine name {self.name!r} must match "
                f"{ENGINE_NAME_RE.pattern}")
        object.__setattr__(self, "backends", tuple(self.backends))
        object.__setattr__(self, "canary_backends",
                           tuple(self.canary_backends))

    def to_doc(self) -> dict:
        return {
            "name": self.name,
            "backends": list(self.backends),
            "canaryBackends": list(self.canary_backends),
            "canaryWeightPct": self.canary_weight_pct,
            "quotaQps": self.quota_qps,
            "quotaBurst": self.quota_burst,
            "maxInflight": self.max_inflight,
            "burstCredits": self.burst_credits,
            "minReplicas": self.min_replicas,
            "maxReplicas": self.max_replicas,
        }

    @classmethod
    def from_doc(cls, doc: Mapping) -> "EngineSpec":
        def opt(key, cast):
            value = doc.get(key)
            return None if value is None else cast(value)

        return cls(
            name=str(doc["name"]),
            backends=tuple(str(b) for b in doc.get("backends") or ()),
            canary_backends=tuple(
                str(b) for b in doc.get("canaryBackends") or ()),
            canary_weight_pct=float(doc.get("canaryWeightPct") or 0.0),
            quota_qps=opt("quotaQps", float),
            quota_burst=opt("quotaBurst", float),
            max_inflight=opt("maxInflight", int),
            burst_credits=opt("burstCredits", float),
            min_replicas=opt("minReplicas", int),
            max_replicas=opt("maxReplicas", int),
        )

    def topology_key(self) -> tuple:
        """Everything that requires REBUILDING the group when it
        changes (backend sets); quota and weight apply in place."""
        return (self.backends, self.canary_backends)

    def quota_key(self) -> tuple:
        return (self.quota_qps, self.quota_burst, self.max_inflight,
                self.burst_credits)


#: `pio router --engine` flag grammar: comma-separated key=value pairs.
#: `replicas`/`port-base` are consumed by the CLI (per-engine
#: supervisor spawns from the --replica-cmd template); the rest map
#: onto EngineSpec fields. Backend lists use `+` between addresses
#: (`,` is the pair separator).
_ENGINE_FLAG_KEYS = frozenset({
    "name", "backend", "canary", "weight", "qps", "burst",
    "max-inflight", "replicas", "port-base",
    "credits", "min-replicas", "max-replicas",
})


def parse_engine_flag(text: str) -> dict:
    """``name=rec,backend=h:p+h:p,canary=h:p,weight=10,qps=100,
    burst=200,max-inflight=64,replicas=2,port-base=8300`` → a typed
    dict (the CLI builds the EngineSpec and supervisor specs from it).
    Raises ValueError with a pointed message on bad grammar."""
    raw: dict[str, str] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition("=")
        key = key.strip()
        if not sep or key not in _ENGINE_FLAG_KEYS:
            raise ValueError(
                f"--engine entry {part!r}: expected key=value with key "
                f"in {sorted(_ENGINE_FLAG_KEYS)}")
        raw[key] = value.strip()
    if "name" not in raw:
        raise ValueError(f"--engine {text!r} needs name=<engine>")
    if not ENGINE_NAME_RE.match(raw["name"]):
        raise ValueError(
            f"--engine name {raw['name']!r} must match "
            f"{ENGINE_NAME_RE.pattern}")

    def addrs(key: str) -> tuple[str, ...]:
        value = raw.get(key, "")
        return tuple(a for a in (p.strip() for p in value.split("+")) if a)

    def num(key: str, cast):
        if key not in raw:
            return None
        try:
            return cast(raw[key])
        except ValueError:
            raise ValueError(
                f"--engine {raw['name']}: {key}={raw[key]!r} is not "
                f"a {cast.__name__}")

    return {
        "name": raw["name"],
        "backends": addrs("backend"),
        "canary_backends": addrs("canary"),
        "weight": num("weight", float),
        "qps": num("qps", float),
        "burst": num("burst", float),
        "max_inflight": num("max-inflight", int),
        "replicas": num("replicas", int),
        "port_base": num("port-base", int),
        "credits": num("credits", float),
        "min_replicas": num("min-replicas", int),
        "max_replicas": num("max-replicas", int),
    }


class EngineQuota:
    """Per-engine admission budget: a token bucket (qps, burst) plus an
    in-flight cap, on the injectable clock so refill/burst behavior is
    deterministic under ``ManualClock``. ``try_admit`` returns None on
    admission (an in-flight slot is held until :meth:`release`) or a
    Retry-After hint in seconds — the 429 the gateway answers with, so
    one tenant's burst queues against its OWN budget and never a
    sibling's. Unlimited (qps=0, max_inflight=0) costs one uncontended
    lock acquisition per request.

    With ``burst_credits`` > 0 the bucket gains a weighted-fair
    reservoir: refill that would overflow the bucket cap (the tenant
    running UNDER its quota) accrues as credits instead of vanishing,
    and a credit substitutes for a token during a burst — but only
    while the fleet has admission headroom (``fleet_idle``), so
    borrowed capacity is capacity nobody else was using and compliant
    tenants' p99 stays pinned."""

    def __init__(self, qps: float = 0.0, burst: float = 0.0,
                 max_inflight: int = 0, burst_credits: float = 0.0,
                 clock: Clock = SYSTEM_CLOCK):
        self.qps = max(0.0, float(qps or 0.0))
        self.burst = (float(burst) if burst and burst > 0
                      else max(1.0, self.qps))
        self.max_inflight = max(0, int(max_inflight or 0))
        self.burst_credits = max(0.0, float(burst_credits or 0.0))
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = clock.monotonic()
        self._inflight = 0
        self._credits = 0.0
        self._credit_spends = 0

    @property
    def limited(self) -> bool:
        return self.qps > 0 or self.max_inflight > 0

    def try_admit(self, fleet_idle: bool = False) -> float | None:
        """None = admitted (call :meth:`release` when done); else the
        seconds-until-a-token-exists hint for Retry-After.
        ``fleet_idle`` gates credit spends: the caller (the gateway)
        passes whether the shared admission gate has headroom."""
        with self._lock:
            spend = 0  # 0 = free (unlimited qps), 1 = token, 2 = credit
            if self.qps > 0:
                now = self._clock.monotonic()
                tokens = self._tokens + (now - self._last) * self.qps
                if tokens > self.burst:
                    if self.burst_credits > 0:
                        self._credits = min(self.burst_credits,
                                            self._credits
                                            + tokens - self.burst)
                    tokens = self.burst
                self._tokens = tokens
                self._last = now
                if tokens >= 1.0:
                    spend = 1
                elif fleet_idle and self._credits >= 1.0:
                    spend = 2
                else:
                    return max(0.001, (1.0 - tokens) / self.qps)
            if self.max_inflight and self._inflight >= self.max_inflight:
                # no refill schedule to size the hint from: one qps
                # beat when a rate exists, else a short constant (the
                # header layer jitters every hint anyway)
                return 1.0 / self.qps if self.qps > 0 else 0.25
            if spend == 1:
                self._tokens -= 1.0
            elif spend == 2:
                self._credits -= 1.0
                self._credit_spends += 1
            self._inflight += 1
            return None

    def release(self) -> None:
        with self._lock:
            self._inflight -= 1

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "limited": self.limited,
                "qps": self.qps or None,
                "burst": self.burst if self.qps > 0 else None,
                "maxInflight": self.max_inflight or None,
                "inflight": self._inflight,
                "tokens": (round(self._tokens, 3)
                           if self.qps > 0 else None),
                "burstCredits": self.burst_credits or None,
                "credits": (round(self._credits, 3)
                            if self.burst_credits > 0 else None),
                "creditSpends": self._credit_spends,
            }


class EngineGroup:
    """One tenant behind the gateway: its own :class:`FleetRouter`
    (membership, breakers, canary, hedging, stats — everything the
    single-engine router owns) plus its admission quota and a
    per-engine SLO engine for the burn-rate gauges."""

    def __init__(self, spec: EngineSpec, config: RouterConfig,
                 admission: AdmissionGate, clock: Clock = SYSTEM_CLOCK,
                 router: FleetRouter | None = None,
                 stamped: bool = True):
        self.spec = spec
        self._config = config
        self._clock = clock
        if router is None:
            engine_config = dataclasses.replace(
                config,
                backends=spec.backends,
                canary_backends=spec.canary_backends,
                canary_weight_pct=spec.canary_weight_pct,
                engines=())
            # `stamped` False = the IMPLICIT lone default engine: its
            # backend snapshots keep the pre-gateway shape (no engine
            # key) so the single-engine suite and dashboards see no
            # change; explicit/runtime engines stamp their name
            router = FleetRouter(engine_config, admission=admission,
                                 engine=spec.name if stamped else "",
                                 clock=clock)
        self.router = router
        self.quota = self._build_quota(spec)
        #: per-engine SLO ring: what THIS tenant's clients experienced
        #: (the per-engine autoscaling-signal contract, docs/fleet.md)
        self.slo = SLOEngine(clock=clock)

    def _build_quota(self, spec: EngineSpec) -> EngineQuota:
        cfg = self._config
        return EngineQuota(
            qps=(spec.quota_qps if spec.quota_qps is not None
                 else cfg.engine_quota_qps),
            burst=(spec.quota_burst if spec.quota_burst is not None
                   else cfg.engine_quota_burst),
            max_inflight=(spec.max_inflight if spec.max_inflight is not None
                          else cfg.engine_max_inflight),
            burst_credits=(spec.burst_credits
                           if spec.burst_credits is not None
                           else cfg.engine_burst_credits),
            clock=self._clock)

    @property
    def name(self) -> str:
        return self.spec.name

    def apply_quota(self, spec: EngineSpec) -> None:
        """Re-weight in place: swap the quota object (readers grab the
        attribute once; in-flight slots held on the OLD bucket release
        against it harmlessly) and remember the new spec."""
        # pio: lint-ignore[shared-state-race]: lock-free reference swap — readers grab self.spec/self.quota once per request (GIL-atomic); stale reads for one request are the documented re-weight semantics
        self.spec = dataclasses.replace(
            spec, backends=self.spec.backends,
            canary_backends=self.spec.canary_backends)
        # pio: lint-ignore[shared-state-race]: same swap discipline — in-flight slots release against the old bucket harmlessly (docstring)
        self.quota = self._build_quota(spec)

    def start(self) -> None:
        self.router.start()

    def close(self) -> None:
        self.router.close()

    def spec_doc(self) -> dict:
        return self.spec.to_doc()

    def snapshot(self) -> dict:
        backends = self.router.membership.snapshot()
        groups: dict[str, dict] = {}
        for b in backends:
            g = groups.setdefault(b["group"], {"size": 0, "up": 0,
                                               "down": 0})
            g["size"] += 1
            g["up" if b["state"] == "up" else "down"] += 1
        return {
            "name": self.name,
            "groups": groups,
            "backends": backends,
            "canary": self.router.canary.snapshot(),
            "quota": self.quota.snapshot(),
            "router": self.router.stats.snapshot(),
        }


class EngineGateway:
    """The EngineTable + request-path dispatch (module docstring).

    Concurrency: the ``_groups`` and ``_routes`` dicts are REPLACED,
    never mutated — handler threads read the current reference once per
    request (GIL-atomic), table mutations build fresh dicts under
    ``_lock`` and swap. Per-group state (membership, canary, quota)
    carries its own locks."""

    def __init__(self, config: RouterConfig, clock: Clock = SYSTEM_CLOCK,
                 default_router: FleetRouter | None = None):
        self.config = config
        self._clock = clock
        #: ONE gate across every engine: 503 = global pressure
        self.admission = (default_router._admission
                          if default_router is not None
                          else AdmissionGate(config.max_inflight))
        self._lock = threading.Lock()
        self._started = False
        groups: dict[str, EngineGroup] = {}
        specs = [s if isinstance(s, EngineSpec) else EngineSpec.from_doc(s)
                 for s in config.engines]
        if default_router is not None:
            # legacy explicit-router construction
            # (RouterServer(config, router)): wrap it as the default
            # engine; declared engines ride alongside
            default_spec = EngineSpec(
                name=config.default_engine,
                backends=tuple(config.backends),
                canary_backends=tuple(config.canary_backends),
                canary_weight_pct=config.canary_weight_pct)
            groups[default_spec.name] = EngineGroup(
                default_spec, config, self.admission, clock,
                router=default_router)
        elif (config.backends or config.canary_backends or not specs):
            # the single-engine configuration (and the empty one):
            # config.backends ARE the default engine — zero breakage
            default_spec = EngineSpec(
                name=config.default_engine,
                backends=tuple(config.backends),
                canary_backends=tuple(config.canary_backends),
                canary_weight_pct=config.canary_weight_pct)
            if any(s.name == default_spec.name for s in specs):
                raise ValueError(
                    f"--engine name {default_spec.name!r} collides with "
                    "the default engine built from --backend; name it "
                    "differently or declare every engine explicitly")
            groups[default_spec.name] = EngineGroup(
                default_spec, config, self.admission, clock,
                stamped=bool(specs))
        for spec in specs:
            if spec.name in groups:
                raise ValueError(f"duplicate engine {spec.name!r}")
            groups[spec.name] = EngineGroup(spec, config,
                                            self.admission, clock)
        self._groups = groups
        if config.default_engine in groups:
            self.default_engine = config.default_engine
        elif config.default_engine != DEFAULT_ENGINE:
            # an EXPLICIT default (--default-engine / the env var) that
            # names no engine is a typo — silently falling back would
            # misroute every legacy bare-/queries.json client onto
            # whichever engine happened to be declared first
            raise ValueError(
                f"default engine {config.default_engine!r} is not in "
                f"the engine table {sorted(groups)}")
        else:
            self.default_engine = next(iter(groups))
        #: engine labels appear on metric families once the deployment
        #: is EXPLICITLY multi-engine — the lone implicit default
        #: engine keeps the pre-gateway exposition byte-for-byte
        self._explicit = bool(specs)
        self._routes = self._compile_routes(groups, self.default_engine)

    # -- views ----------------------------------------------------------------
    @property
    def labeled(self) -> bool:
        return self._explicit or len(self._groups) > 1

    def groups(self) -> list[EngineGroup]:
        return list(self._groups.values())

    def get(self, name: str) -> EngineGroup | None:
        return self._groups.get(name)

    @property
    def default_group(self) -> EngineGroup:
        return self._groups[self.default_engine]

    def is_query_path(self, path: str) -> bool:
        """The O(1) routed-path test the HTTP handler runs per request."""
        return path in self._routes

    def engine_names(self) -> list[str]:
        return list(self._groups)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            self._started = True
            groups = self._groups
        for group in groups.values():
            group.start()

    def close(self) -> None:
        with self._lock:
            self._started = False
            groups = self._groups
        for group in groups.values():
            group.close()

    # -- table mutation (all under _lock; dicts swapped, never mutated) -------
    @staticmethod
    def _compile_routes(groups: Mapping[str, EngineGroup],
                        default: str) -> dict[str, str]:
        routes = {engine_query_path(name): name for name in groups}
        routes[QUERIES_PATH] = default
        return routes

    def _swap(self, groups: dict[str, EngineGroup],
              default: str | None = None) -> None:
        """Caller holds ``_lock``. Publish a new table atomically:
        groups first, then the route dict compiled FROM it — a reader
        that wins a route hit always finds the group."""
        # pio: lint-ignore[shared-state-race]: writers serialize on _lock; readers deliberately take none — dict references are swapped whole (GIL-atomic) in groups-then-routes order so a route hit always finds its group
        self._groups = groups
        if default is not None:
            # pio: lint-ignore[shared-state-race]: same publish discipline — a reader sees either the old or the new default, both valid tables
            self.default_engine = default
        # pio: lint-ignore[shared-state-race]: same publish discipline — routes compiled FROM the already-published groups
        self._routes = self._compile_routes(groups, self.default_engine)

    def register(self, spec: EngineSpec) -> EngineGroup:
        """Add an engine at runtime. Its membership probe loop starts
        immediately (when the gateway is live), so a dead backend is
        marked down within ``down_after`` probes just like a launch
        backend."""
        with self._lock:
            if spec.name in self._groups:
                raise ValueError(f"engine {spec.name!r} already registered")
            group = EngineGroup(spec, self.config, self.admission,
                                self._clock)
            groups = dict(self._groups)
            groups[spec.name] = group
            self._swap(groups)
            started = self._started
        if started:
            group.start()
        logger.info("engine %s registered (%d backends)",
                    spec.name, len(spec.backends))
        return group

    def retire(self, name: str) -> EngineGroup:
        """Remove an engine: it leaves the route table first (new
        requests 404), then its probe loop and transports close.
        Retiring the default engine is refused — bare ``/queries.json``
        must always resolve."""
        with self._lock:
            if name == self.default_engine:
                raise ValueError(
                    f"engine {name!r} is the default engine; point "
                    "defaultEngine elsewhere before retiring it")
            group = self._groups.get(name)
            if group is None:
                raise KeyError(name)
            groups = dict(self._groups)
            del groups[name]
            self._swap(groups)
        group.close()
        logger.info("engine %s retired", name)
        return group

    def set_default(self, name: str) -> None:
        with self._lock:
            if name not in self._groups:
                raise KeyError(name)
            self._swap(dict(self._groups), default=name)

    # -- the request path -----------------------------------------------------
    def resolve(self, path: str,
                headers: Mapping[str, str]) -> "EngineGroup | None":
        """One dict hit on the path; bare ``/queries.json`` consults
        the ``X-PIO-Engine`` header (absent → default engine). Returns
        None for an unknown engine (the caller's 404)."""
        name = self._routes.get(path)
        if name is None:
            return None
        if path == QUERIES_PATH:
            header = headers.get(_ENGINE_HEADER_LC)
            if header is not None:
                name = header
        return self._groups.get(name)

    def route(self, path: str, body: bytes, headers: Mapping[str, str],
              request_id: str) -> RouterResponse:
        """Resolve → per-engine quota (429) → the engine's own
        FleetRouter (global-pressure 503 shed, pick/forward/retry/
        hedge). The response carries the resolved engine for the
        access log, root trace span and SLO attribution."""
        group = self.resolve(path, headers)
        if group is None:
            trace = active_trace()
            if trace is not None:
                trace.tags["outcome"] = "unknown_engine"
            wanted = (headers.get(_ENGINE_HEADER_LC)
                      if path == QUERIES_PATH else path)
            return RouterResponse.error(
                404, f"unknown engine for {wanted!r} "
                     "(GET /fleet/engines lists the registered table)")
        # ONE quota reference for admit AND release: a concurrent
        # runtime re-quota swaps group.quota, and releasing against the
        # fresh bucket would drive its in-flight count negative (and
        # quietly widen the cap by the number of in-flight requests)
        quota = group.quota
        # Burst credits only spend into idle fleet capacity: gate on
        # the SHARED admission gate's headroom so borrowed slots are
        # slots no compliant tenant was using.
        fleet_idle = self.admission.headroom() >= FLEET_IDLE_HEADROOM
        hint = quota.try_admit(fleet_idle=fleet_idle)
        if hint is not None:
            group.router.stats.bump_throttled()
            trace = active_trace()
            if trace is not None:
                trace.tags["outcome"] = "quota_throttled"
            out = RouterResponse.error(
                429, f"engine {group.name!r} is over its request "
                     "quota; retry shortly",
                {"Retry-After": retry_after_header(hint)})
            out.engine = group.name
            return out
        try:
            out = group.router.route(body, headers, request_id)
        finally:
            quota.release()
        out.engine = group.name
        return out

    def record_outcome(self, engine: str | None, ok: bool,
                       latency_s: float) -> None:
        """Feed the per-engine SLO ring (handler-measured walltime)."""
        if engine is None:
            return
        group = self._groups.get(engine)
        if group is not None:
            group.slo.record(ok=ok, latency_s=latency_s)

    # -- shared admin state (the cumulative engines document) -----------------
    def table_doc(self) -> dict:
        """The WHOLE table as a JSON-able document: specs + per-engine
        canary state. Published into the worker admin spool on every
        mutation so a respawned sibling adopts everything from one
        read (fleet/workers.py)."""
        groups = self._groups
        return {
            "defaultEngine": self.default_engine,
            "table": [
                {"spec": g.spec_doc(),
                 "canary": g.router.canary.state_doc()}
                for g in groups.values()
            ],
        }

    def adopt_table(self, doc: Mapping) -> bool:
        """Diff-apply a sibling's :meth:`table_doc`: register engines
        we lack, retire engines the document dropped, re-apply quotas
        and canary state ONLY where they differ (an identical document
        re-read every sync pass must be a no-op — see
        CanaryController.adopt_state). Returns True when anything
        changed. Individual malformed entries are skipped with a
        warning; they must never take the sync loop down."""
        table = doc.get("table")
        if not isinstance(table, list):
            return False
        changed = False
        want: dict[str, tuple[EngineSpec, dict | None]] = {}
        #: engines whose entry was PRESENT but unreadable (torn spool
        #: write, version skew): they must be exempt from the
        #: retire-what's-absent pass below — conflating "unparseable"
        #: with "deliberately dropped" would retire a healthy tenant
        #: locally AND, via this worker's next cumulative publish,
        #: fleet-wide. If even the NAME is unreadable, skip retirement
        #: entirely this cycle (the next committed doc settles it).
        unparsed: set[str] = set()
        doc_complete = True
        for entry in table:
            try:
                spec = EngineSpec.from_doc(entry["spec"])
            except (KeyError, TypeError, ValueError) as exc:
                logger.warning("ignoring malformed engine entry %r: %s",
                               entry, exc)
                try:
                    unparsed.add(str(entry["spec"]["name"]))
                except (KeyError, TypeError):
                    doc_complete = False
                continue
            canary = entry.get("canary")
            want[spec.name] = (spec, canary if isinstance(canary, dict)
                               else None)
        if not want:
            return False
        default = doc.get("defaultEngine")
        for name, (spec, canary) in want.items():
            group = self._groups.get(name)
            if group is None:
                try:
                    group = self.register(spec)
                except ValueError as exc:
                    logger.warning("cannot adopt engine %s: %s", name, exc)
                    continue
                changed = True
            elif group.spec.topology_key() != spec.topology_key():
                # backend sets changed: rebuild the group (breaker and
                # probe state restart clean against the new replicas)
                try:
                    self.retire(name)
                    group = self.register(spec)
                    changed = True
                except (KeyError, ValueError) as exc:
                    logger.warning("cannot rebuild engine %s: %s",
                                   name, exc)
                    continue
            elif group.spec.quota_key() != spec.quota_key():
                group.apply_quota(spec)
                changed = True
            if canary is not None and group.router.canary.adopt_state(
                    canary):
                changed = True
        if default in want and default in self._groups \
                and default != self.default_engine:
            self.set_default(default)
            changed = True
        if doc_complete:
            for name in list(self._groups):
                if name not in want and name not in unparsed \
                        and name != self.default_engine:
                    try:
                        self.retire(name)
                        changed = True
                    except (KeyError, ValueError):
                        pass
        return changed

    # -- admin mutations behind POST /fleet/engines ---------------------------
    def admin_mutate(self, doc: Mapping) -> dict:
        """Apply one ``POST /fleet/engines`` action and return the new
        table snapshot. Raises ValueError with an operator-readable
        message on a bad request (the HTTP layer's 400/404/409)."""
        action = doc.get("action")
        if action == "register":
            engine = doc.get("engine")
            if not isinstance(engine, dict):
                raise ValueError(
                    'register needs {"engine": {"name": ..., '
                    '"backends": [...]}}')
            try:
                spec = EngineSpec.from_doc(engine)
            except (KeyError, TypeError, ValueError) as exc:
                raise ValueError(f"invalid engine spec: {exc}")
            self.register(spec)
            return self.snapshot()
        name = doc.get("name")
        if not isinstance(name, str):
            raise ValueError('expected {"action": ..., "name": <engine>}')
        if action == "retire":
            try:
                self.retire(name)
            except KeyError:
                raise ValueError(f"unknown engine {name!r}")
            return self.snapshot()
        group = self._groups.get(name)
        if group is None:
            raise ValueError(f"unknown engine {name!r}")
        if action == "quota":
            # a key ABSENT from the document keeps the engine's current
            # value (a partial re-quota must not silently reset the
            # fields it did not mention); an explicit JSON null resets
            # that field to the router-wide PIO_ROUTER_ENGINE_* default
            def field(key: str, current, cast):
                if key not in doc:
                    return current
                return None if doc[key] is None else cast(doc[key])

            try:
                spec = dataclasses.replace(
                    group.spec,
                    quota_qps=field("quotaQps", group.spec.quota_qps,
                                    float),
                    quota_burst=field("quotaBurst",
                                      group.spec.quota_burst, float),
                    max_inflight=field("maxInflight",
                                       group.spec.max_inflight, int),
                    burst_credits=field("burstCredits",
                                        group.spec.burst_credits, float))
            except (TypeError, ValueError) as exc:
                raise ValueError(f"invalid quota: {exc}")
            group.apply_quota(spec)
            return self.snapshot()
        if action == "weight":
            try:
                weight = float(doc["weight"])
            except (KeyError, TypeError, ValueError):
                raise ValueError('weight needs {"weight": <0..100>}')
            if not 0.0 <= weight <= 100.0:
                raise ValueError("weight must be within 0..100")
            group.router.canary.set_weight(weight)
            return self.snapshot()
        if action == "default":
            self.set_default(name)
            return self.snapshot()
        raise ValueError(
            f"unknown action {action!r}: expected register | retire | "
            "quota | weight | default")

    def snapshot(self) -> dict:
        """``GET /fleet/engines``: the table with per-engine health,
        canary and quota state — what ``pio status --router`` prints."""
        groups = self._groups
        return {
            "defaultEngine": self.default_engine,
            "engines": [g.snapshot() for g in groups.values()],
        }

    # -- registry adapter -----------------------------------------------------
    def collector(self):
        """Per-engine labeled metric families. Single implicit engine:
        byte-identical to the pre-gateway ``router_collector`` output
        (plus the ``pio_router_engines`` gauge) — existing dashboards
        and the pinned single-engine suite see no label change. Multi-
        engine: every router family gains ``engine=<name>`` (merged
        into ONE family per name — duplicate HELP/TYPE blocks are
        invalid exposition), plus the quota gauges and the per-engine
        SLO burn family."""

        def collect() -> list[Metric]:
            groups = self._groups
            labeled = self.labeled
            out: list[Metric] = []
            if not labeled:
                group = groups[self.default_engine]
                out.extend(router_collector(
                    group.router.stats, group.router.membership,
                    group.router.canary)())
            else:
                merged: dict[str, Metric] = {}
                inflight = Metric(
                    name="pio_router_engine_inflight", kind="gauge",
                    help="Requests currently in flight per engine "
                         "(quota-layer view; the global admission "
                         "gate is pio_router_backend_inflight's sum)")
                qps = Metric(
                    name="pio_router_engine_quota_qps", kind="gauge",
                    help="Configured token-bucket rate per engine "
                         "(0 = unlimited)")
                credits = Metric(
                    name="pio_router_engine_burst_credits", kind="gauge",
                    help="Accrued burst credits per engine (weighted "
                         "fair queueing reservoir; only engines with a "
                         "credit cap emit a sample)")
                spends = Metric(
                    name="pio_router_engine_credit_spends_total",
                    kind="counter",
                    help="Admissions paid with a burst credit instead "
                         "of a bucket token (fleet had headroom)")
                for name, group in groups.items():
                    fams = router_collector(
                        group.router.stats, group.router.membership,
                        group.router.canary)()
                    for fam in relabel(fams, {"engine": name}):
                        have = merged.get(fam.name)
                        if have is None:
                            merged[fam.name] = fam
                        else:
                            have.samples.extend(fam.samples)
                            have.histograms.extend(fam.histograms)
                    labels = {"engine": name}
                    quota = group.quota
                    inflight.samples.append(
                        (labels, float(quota.inflight)))
                    qps.samples.append((labels, float(quota.qps)))
                    if quota.burst_credits > 0:
                        snap = quota.snapshot()
                        credits.samples.append(
                            (labels, float(snap["credits"] or 0.0)))
                        spends.samples.append(
                            (labels, float(snap["creditSpends"])))
                out.extend(merged.values())
                out.append(inflight)
                out.append(qps)
                if credits.samples:
                    out.append(credits)
                    out.append(spends)
                out.append(labeled_burn_metric(
                    [({"engine": name}, group.slo)
                     for name, group in groups.items()],
                    name="pio_router_engine_slo_burn_rate",
                    help="Per-engine error-budget burn rate by SLO and "
                         "window — the per-tenant autoscaling signal "
                         "(docs/fleet.md \"Multi-engine routing\")"))
            out.append(Metric(
                name="pio_router_engines", kind="gauge",
                help="Engines registered in this router's EngineTable",
                samples=[({}, float(len(groups)))]))
            return out

        return collect


__all__ = [
    "DEFAULT_ENGINE",
    "ENGINE_HEADER",
    "ENGINE_NAME_RE",
    "EngineGateway",
    "EngineGroup",
    "EngineQuota",
    "EngineSpec",
    "engine_query_path",
    "parse_engine_flag",
]
