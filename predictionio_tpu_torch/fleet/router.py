"""The fleet routing core: pick, forward, retry, hedge, degrade (a copy
of the JAX package's ``fleet/router.py``).

One request's life through :meth:`FleetRouter.route`:

1. **admission** — bounded in-flight slots; a saturated fleet sheds
   with 503 + Retry-After instead of queueing into collapse;
2. **deadline** — ``X-PIO-Deadline-Ms`` (tightened by the router's own
   ``request_deadline_ms``) becomes an absolute deadline; an already
   -dead request is never forwarded, and every forward carries the
   REMAINING budget so the backend's own expiry machinery sees the
   end-to-end number;
3. **pick** — the canary controller splits traffic stable/canary by
   weight; within the group the least-loaded routable replica wins
   (UP per membership, breaker not open). A group with no routable
   replica spills to the other group (degraded-but-correct, counted)
   rather than failing the request;
4. **forward** — the exchange runs under the backend's per-replica
   :class:`~predictionio_tpu_torch.utils.resilience.Resilience` (breaker
   accounting, transient classification via the shared
   ``is_transient_http_status`` contract);
5. **hedge** (opt-in) — when the primary has not answered after a
   p99-derived delay and a second routable replica exists, a hedge
   fires there and the first answer wins (tail-latency insurance, The
   Tail at Scale);
6. **retry** — a failed or breaker-open replica gets ONE transparent
   retry on a DIFFERENT routable replica, never the same one;
7. **outcome** — canary guardrails fold the result in (5xx/transport
   failures count against the canary; client-side 4xx do not) and may
   auto-abort the rollout.

A request only surfaces 5xx to the client when every routable replica
failed it: "zero 5xx while a healthy replica exists".
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Callable, Mapping

from predictionio_tpu_torch.api.http_base import (
    parse_deadline_budget,
    retry_after_header,
)
from predictionio_tpu_torch.fleet.canary import CanaryController, GuardrailConfig
from predictionio_tpu_torch.fleet.membership import (
    CANARY,
    Backend,
    BackendSpec,
    FleetMembership,
)
from predictionio_tpu_torch.fleet.stats import RouterStats
from predictionio_tpu_torch.fleet.transport import UpstreamResponse
from predictionio_tpu_torch.obs.histogram import LatencyHistogram
from predictionio_tpu_torch.obs.trace import (
    PARENT_SPAN_HEADER,
    TRACE_ID_HEADER,
    Trace,
    active_trace,
)
from predictionio_tpu_torch.utils.resilience import (
    SYSTEM_CLOCK,
    Clock,
    StorageUnavailableError,
    TransientError,
    is_transient_http_status,
    resilient,
)

logger = logging.getLogger(__name__)

#: request headers the router forwards verbatim to the backend (plus
#: the recomputed deadline and the correlation id); the experiment
#: attribution pair is how an assigned variant id reaches the engine
#: server's response stamp + feedback event (experiment/controller.py)
_FORWARD_HEADERS = ("content-type", "accept",
                    "x-pio-experiment", "x-pio-variant")


class UpstreamStatusError(TransientError):
    """The upstream ANSWERED with a transient status (5xx/429) — a
    health signal for the breaker, but the response itself survives on
    the exception so the router can still return it when no other
    replica is available."""

    def __init__(self, backend_id: str, response: UpstreamResponse):
        super().__init__(f"upstream {backend_id} answered "
                         f"HTTP {response.status}")
        self.response = response


@dataclasses.dataclass
class RouterResponse:
    """What the HTTP layer writes back: status, raw body bytes (passed
    through, never re-encoded), content type, extra headers — plus the
    routing metadata the access log and traces report (which replica
    answered, how many attempts it took, whether the hedge/retry
    machinery fired, and — behind a multi-engine gateway — WHICH
    deployment the request resolved to: before the ``engine`` field the
    access log and root trace spans had nowhere to record that)."""

    status: int
    body: bytes
    content_type: str = "application/json; charset=UTF-8"
    headers: dict[str, str] = dataclasses.field(default_factory=dict)
    #: routing metadata (None/0/False on non-routed responses)
    backend_id: str | None = None
    group: str | None = None
    attempts: int = 0
    hedged: bool = False
    retried: bool = False
    #: the engine (tenant) this request resolved to (fleet/gateway.py);
    #: None on non-routed responses and on pre-resolution rejects
    engine: str | None = None

    @classmethod
    def error(cls, status: int, message: str,
              headers: dict[str, str] | None = None) -> "RouterResponse":
        import json

        return cls(status, json.dumps({"message": message}).encode(),
                   headers=headers or {})


class AdmissionGate:
    """The bounded-admission in-flight counter, factored out of
    :class:`FleetRouter` so a multi-engine gateway (fleet/gateway.py)
    can share ONE gate across every engine group: the 503 shed is a
    verdict about GLOBAL router pressure — per-engine budgets are the
    quota layer's job (429, ``EngineQuota``), and an engine-local 503
    would let one tenant's burst masquerade as fleet saturation."""

    def __init__(self, max_inflight: int):
        self.max_inflight = max_inflight
        self._inflight = 0
        self._lock = threading.Lock()

    def admit(self) -> bool:
        with self._lock:
            if self._inflight >= self.max_inflight:
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._inflight -= 1

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def headroom(self) -> float:
        """Free fraction of the gate, 0.0 (saturated) .. 1.0 (idle).
        An uncapped gate always reports full headroom. The burst-credit
        layer (fleet/gateway.py) reads this to decide whether borrowed
        capacity is really idle capacity."""
        if self.max_inflight <= 0:
            return 1.0
        with self._lock:
            return max(0.0, 1.0 - self._inflight / self.max_inflight)


class HedgePolicy:
    """When and how late to fire a tail-latency hedge.

    The delay derives from the observed upstream latency distribution:
    ``quantile`` (default p99) of everything the router has seen,
    clamped to ``[min_delay_ms, max_delay_ms]``. Until ``min_samples``
    observations exist the clamp floor applies — hedging too eagerly on
    no data would double fleet load for nothing. Deterministic given
    its observation history (pinned on ManualClock-style tests: no
    clock reads, no randomness)."""

    def __init__(self, min_delay_ms: float = 10.0,
                 max_delay_ms: float = 500.0,
                 quantile: float = 0.99,
                 min_samples: int = 20):
        self.min_delay_s = min_delay_ms / 1e3
        self.max_delay_s = max_delay_ms / 1e3
        self.quantile = quantile
        self.min_samples = min_samples
        self._latency = LatencyHistogram()

    def observe(self, seconds: float) -> None:
        self._latency.observe(seconds)

    def delay_s(self) -> float:
        """Seconds to wait for the primary before hedging."""
        snap = self._latency.snapshot()
        if snap.count < self.min_samples:
            return self.min_delay_s
        q = snap.quantile(self.quantile)
        if q is None:
            return self.min_delay_s
        return min(self.max_delay_s, max(self.min_delay_s, q))

    def should_hedge(self, alternates: int,
                     remaining_budget: float | None) -> bool:
        """A hedge needs somewhere to go and enough budget that the
        hedged attempt could still answer in time."""
        if alternates <= 0:
            return False
        if remaining_budget is not None \
                and remaining_budget <= self.delay_s():
            return False
        return True


def _env_field(key: str, default, cast):
    """``PIO_ROUTER_<KEY>`` env-overridable frozen-dataclass default,
    read at construction time (the ServerConfig discipline; shared
    implementation in utils/envcfg.py)."""
    from predictionio_tpu_torch.utils.envcfg import env_field

    return env_field("PIO_ROUTER_", key, default, cast)


def _cast_bool(raw: str) -> bool:
    return raw.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """`pio router` knobs (docs/fleet.md has the full table)."""

    ip: str = "0.0.0.0"
    port: int = 8100
    #: stable replica addresses, ``host:port`` — these become the
    #: DEFAULT engine's backend group (fleet/gateway.py)
    backends: tuple[str, ...] = ()
    #: canary replica addresses (the new model generation)
    canary_backends: tuple[str, ...] = ()
    #: named engine groups behind this one router
    #: (:class:`~predictionio_tpu_torch.fleet.gateway.EngineSpec` instances;
    #: `pio router --engine name=...,backend=...`): each engine gets
    #: its OWN membership, breakers, canary controller, hedging state
    #: and quota — blast-radius isolation per tenant (docs/fleet.md
    #: "Multi-engine routing")
    engines: tuple = ()
    #: the engine bare ``/queries.json`` routes to — zero breakage for
    #: single-engine clients. When ``backends`` above is non-empty it
    #: names the engine built from them; otherwise it must name one of
    #: ``engines`` (falls back to the first declared engine)
    default_engine: str = _env_field("DEFAULT_ENGINE", "default", str)
    #: per-engine admission defaults for engines that do not set their
    #: own (PIO_ROUTER_ENGINE_*): token-bucket qps (0 = unlimited),
    #: burst (0 = max(1, qps)), and per-engine in-flight cap (0 = only
    #: the GLOBAL max_inflight applies). Over-quota requests answer
    #: 429 + Retry-After; the 503 shed stays a global-pressure verdict
    engine_quota_qps: float = _env_field("ENGINE_QPS", 0.0, float)
    engine_quota_burst: float = _env_field("ENGINE_BURST", 0.0, float)
    engine_max_inflight: int = _env_field("ENGINE_MAX_INFLIGHT", 0, int)
    #: burst-credit reservoir cap for engines that do not set their own
    #: (0 = credits off): under-quota refill accrues as credits, spent
    #: during bursts while the shared gate has headroom — weighted fair
    #: queueing atop the token bucket (docs/fleet.md "Per-tenant
    #: elasticity")
    engine_burst_credits: float = _env_field("ENGINE_BURST_CREDITS",
                                             0.0, float)
    #: membership probe loop (fleet/membership.py)
    probe_interval_s: float = _env_field("PROBE_INTERVAL_S", 1.0, float)
    probe_timeout_s: float = _env_field("PROBE_TIMEOUT_S", 1.0, float)
    down_after: int = _env_field("DOWN_AFTER", 2, int)
    up_after: int = _env_field("UP_AFTER", 2, int)
    #: per-backend breaker (utils/resilience.CircuitBreaker)
    breaker_threshold: int = _env_field("BREAKER_THRESHOLD", 3, int)
    breaker_reset_s: float = _env_field("BREAKER_RESET_S", 5.0, float)
    #: socket bound per upstream attempt (tightened by the deadline)
    upstream_timeout_s: float = _env_field("UPSTREAM_TIMEOUT_S", 30.0, float)
    #: bounded admission: concurrent requests in flight through the
    #: router; beyond it requests shed with 503 + Retry-After
    max_inflight: int = _env_field("MAX_INFLIGHT", 128, int)
    #: router-imposed request budget (0 = none); clients may only
    #: tighten via X-PIO-Deadline-Ms
    request_deadline_ms: float = _env_field("REQUEST_DEADLINE_MS", 0.0, float)
    #: tail-latency hedging (off by default: it spends fleet capacity)
    hedge: bool = _env_field("HEDGE", False, _cast_bool)
    hedge_min_delay_ms: float = _env_field("HEDGE_MIN_DELAY_MS", 10.0, float)
    hedge_max_delay_ms: float = _env_field("HEDGE_MAX_DELAY_MS", 500.0, float)
    #: initial canary traffic share (0..100) and guardrails
    canary_weight_pct: float = _env_field("CANARY_WEIGHT_PCT", 0.0, float)
    guardrail_min_requests: int = _env_field("GUARDRAIL_MIN_REQUESTS", 20, int)
    guardrail_max_error_rate: float = _env_field(
        "GUARDRAIL_MAX_ERROR_RATE", 0.5, float)
    guardrail_max_p99_ms: float = _env_field("GUARDRAIL_MAX_P99_MS", 0.0, float)
    guardrail_window: int = _env_field("GUARDRAIL_WINDOW", 200, int)
    #: when set, /fleet/canary and /stop require ?accessKey=<router_key>
    router_key: str | None = None
    #: structured access logs; None defers to PIO_ACCESS_LOG
    access_log: bool | None = None
    #: per-request root spans on the forward path (admission, pick,
    #: attempt/retry/hedge), with trace context forwarded to replicas
    #: so the fleet trace stitches back together; None defers to the
    #: PIO_TRACE env var (the ServerConfig discipline)
    tracing: bool | None = None
    #: socket bound for every scrape-time fan-out fetch — worker peers,
    #: replica /metrics behind /fleet/metrics, /traces.json stitching.
    #: Every cross-process fetch on these paths must be timed (the
    #: untimed-blocking-io lint contract): a wedged peer costs one
    #: timeout, never a hung scrape
    scrape_timeout_s: float = _env_field("SCRAPE_TIMEOUT_S", 2.0, float)
    #: directory where `--workers N` processes register their loopback
    #: peer endpoints (fleet/workers.py) so a /metrics scrape landing
    #: on one worker can report all of them; None = no worker peering
    worker_spool_dir: str | None = None
    #: cadence of the shared-admin-state sync loop under `--workers N`
    #: (fleet/workers.py admin spool): canary weight mutations and
    #: guardrail abort verdicts published by ANY worker are applied by
    #: every sibling within about this many seconds
    admin_sync_interval_s: float = _env_field("ADMIN_SYNC_INTERVAL_S",
                                              0.5, float)
    #: bind with SO_REUSEPORT so N router worker processes share one
    #: listen port (`pio router --workers N`): one CPython router tops
    #: out on its GIL long before the fleet does — workers scale the
    #: router tier horizontally exactly like replicas scale the model
    #: tier. Caveat: each worker holds its own canary/membership state
    #: (docs/fleet.md), so canary admin calls address ONE worker.
    reuse_port: bool = False

    def guardrail(self) -> GuardrailConfig:
        return GuardrailConfig(
            min_requests=self.guardrail_min_requests,
            max_error_rate=self.guardrail_max_error_rate,
            max_p99_ms=self.guardrail_max_p99_ms,
            window=self.guardrail_window,
        )


class FleetRouter:
    """Transport-free routing logic; the HTTP surface lives in
    api/router_server.py."""

    def __init__(self, config: RouterConfig,
                 membership: FleetMembership | None = None,
                 canary: CanaryController | None = None,
                 stats: RouterStats | None = None,
                 hedge_policy: HedgePolicy | None = None,
                 admission: AdmissionGate | None = None,
                 engine: str = "",
                 clock: Clock = SYSTEM_CLOCK):
        self.config = config
        #: which engine group this router serves, for snapshot/metric
        #: attribution ("" for the classic single-engine router)
        self.engine = engine
        if membership is None:
            backends = [
                Backend(BackendSpec.parse(addr, group, engine=engine),
                        breaker_threshold=config.breaker_threshold,
                        breaker_reset_s=config.breaker_reset_s,
                        clock=clock)
                for group, addrs in (("stable", config.backends),
                                     ("canary", config.canary_backends))
                for addr in addrs
            ]
            membership = FleetMembership(
                backends,
                probe_interval_s=config.probe_interval_s,
                probe_timeout_s=config.probe_timeout_s,
                down_after=config.down_after,
                up_after=config.up_after)
        self.membership = membership
        self.canary = canary or CanaryController(
            weight_pct=config.canary_weight_pct,
            guardrail=config.guardrail())
        if (self.canary.weight_pct > 0.0
                and not any(b.group == CANARY
                            for b in self.membership.backends)):
            # a positive weight with an empty canary set would send
            # weight% of picks through the spill path forever: the
            # group_spills alarm counter climbs on a healthy fleet and
            # the guardrail can never evaluate (no canary ever serves)
            logger.warning(
                "canary weight %.1f%% configured with no canary "
                "backends — forcing weight to 0", self.canary.weight_pct)
            self.canary.set_weight(0.0)
        self.stats = stats or RouterStats()
        self.hedge_policy = hedge_policy or HedgePolicy(
            min_delay_ms=config.hedge_min_delay_ms,
            max_delay_ms=config.hedge_max_delay_ms)
        #: bounded admission — shared across every engine group when a
        #: gateway fronts several (class docstring on AdmissionGate)
        self._admission = admission or AdmissionGate(config.max_inflight)
        #: fired (post-lock, best-effort) when the guardrail auto-abort
        #: latches — the HTTP layer publishes the verdict to the worker
        #: admin spool so every `--workers` sibling aborts too instead
        #: of each latching its own verdict (fleet/workers.py)
        self.on_canary_abort: "Callable[[], None] | None" = None
        #: rotation tiebreak for the least-loaded pick: under light or
        #: perfectly balanced load every replica's in-flight count is
        #: zero and a bare min() would pin all traffic to the first
        #: replica (itertools.count is a single C call, GIL-atomic)
        self._rr = itertools.count()
        #: hedge attempts run on pool threads so the handler can race
        #: primary vs hedge; sized for two attempts per admitted request
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * config.max_inflight),
            thread_name_prefix="pio-router-hedge")

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self.membership.start()

    def close(self) -> None:
        self.membership.stop()
        self._pool.shutdown(wait=False)

    # -- admission + deadline -----------------------------------------------
    def _admit(self) -> bool:
        return self._admission.admit()

    def _release(self) -> None:
        self._admission.release()

    @property
    def inflight(self) -> int:
        """In-flight requests through the admission gate — the GLOBAL
        count when the gate is shared across engine groups."""
        return self._admission.inflight

    def _deadline_budget(self, headers: Mapping[str, str]) -> float | None:
        """Seconds of budget via the shared engine-server contract
        (http_base.parse_deadline_budget: the client header may only
        tighten). Raises ValueError on a malformed header (the
        caller's 400)."""
        return parse_deadline_budget(self.config.request_deadline_ms,
                                     headers)

    # -- the route ----------------------------------------------------------
    def route(self, body: bytes, headers: Mapping[str, str],
              request_id: str) -> RouterResponse:
        """Forward one ``POST /queries.json`` (module docstring). The
        ambient trace (bound by the HTTP handler when tracing is on)
        gains admission/pick/attempt spans; with tracing off the
        ``active_trace()`` read is the whole cost."""
        trace = active_trace()
        if not self._admit():
            self.stats.bump("requests")
            self.stats.bump("sheds")
            if trace is not None:
                trace.tags["outcome"] = "shed"
            return RouterResponse.error(
                503, "fleet saturated; retry shortly",
                {"Retry-After": retry_after_header(1.0)})
        try:
            try:
                budget = self._deadline_budget(headers)
            except ValueError as exc:
                self.stats.bump("requests")
                return RouterResponse.error(400, str(exc))
            deadline = (time.monotonic() + budget
                        if budget is not None else None)
            group = self.canary.pick_group()
            self.stats.bump_request(group)
            return self._route_with_retry(group, body, headers,
                                          request_id, deadline, trace)
        finally:
            self._release()

    def _remaining(self, deadline: float | None) -> float | None:
        if deadline is None:
            return None
        return deadline - time.monotonic()

    def _pick(self, group: str, exclude: set[str]) -> tuple[Backend | None, str]:
        """Least-loaded routable replica in ``group``; an empty group
        spills to the other one (counted). Returns (backend, group it
        actually came from)."""
        candidates = self.membership.routable(group, exclude=exclude)
        actual = group
        if not candidates:
            other = "canary" if group == "stable" else "stable"
            candidates = self.membership.routable(other, exclude=exclude)
            if candidates:
                self.stats.bump("group_spills")
                actual = other
        if not candidates:
            return None, actual
        # read each in-flight count ONCE: concurrent requests move the
        # counts between reads, and a min()-then-filter over live reads
        # can produce an empty tie set mid-burst
        loads = [(b.inflight, b) for b in candidates]
        lowest = min(load for load, _ in loads)
        ties = [b for load, b in loads if load == lowest]
        return ties[next(self._rr) % len(ties)], actual

    def _route_with_retry(self, group: str, body: bytes,
                          headers: Mapping[str, str], request_id: str,
                          deadline: float | None,
                          trace: Trace | None = None) -> RouterResponse:
        tried: set[str] = set()
        last_failure: BaseException | None = None
        #: hedge firings survive a failed attempt here — the ``hedged``
        #: flag _forward returns is lost when the attempt RAISES, and
        #: deriving it from len(tried) conflated a failed hedge with a
        #: retry in the access log's routing verdict
        meta = {"hedges": 0}
        retried = False
        for attempt in (0, 1):
            remaining = self._remaining(deadline)
            if remaining is not None and remaining <= 0:
                self.stats.bump("expired")
                out = RouterResponse.error(
                    503, "request deadline exceeded before a replica "
                         "could answer",
                    {"Retry-After": retry_after_header(1.0)})
                # a deadline blown AFTER attempt 0 already exchanged
                # with replicas (possibly a hedge pair) — the access
                # log's routing verdict must count them, not say 0
                out.attempts = len(tried)
                out.retried = retried
                out.hedged = meta["hedges"] > 0
                return out
            backend, actual_group = self._pick(group, tried)
            if backend is None:
                if last_failure is not None:
                    break  # no replica left to retry on
                self.stats.bump("no_backend")
                return RouterResponse.error(
                    503, "no healthy replica available",
                    {"Retry-After": retry_after_header(
                        max(1.0, self.membership.probe_interval_s))})
            if attempt > 0:
                self.stats.bump("retries")
                retried = True
            try:
                response, served_id, hedged = self._forward(
                    backend, actual_group, tried, body, headers,
                    request_id, deadline, trace,
                    label="retry" if attempt else "attempt", meta=meta)
                out = self._passthrough(response)
                out.backend_id = served_id
                out.group = actual_group
                out.attempts = attempt + 1 + meta["hedges"]
                out.retried = retried
                out.hedged = hedged or meta["hedges"] > 0
                return out
            except StorageUnavailableError as exc:
                self.stats.bump("upstream_errors")
                last_failure = exc
                tried.add(backend.id)
                continue
        # every routable replica failed: surface the most informative
        # thing we have — a real upstream response when one exists.
        # Pure TRANSPORT failure (no replica even answered — the
        # whole-group-killed case) is a retryable 503 + Retry-After,
        # not a 502: the client's correct move is to back off and
        # retry once the group's replicas return, and a dead tenant
        # must degrade to FAST bounded 503s behind the gateway
        # (docs/fleet.md "Multi-engine routing")
        response = _embedded_response(last_failure)
        if response is not None:
            out = self._passthrough(response)
        else:
            out = RouterResponse.error(
                503, f"no replica reachable: {last_failure}",
                {"Retry-After": retry_after_header(1.0)})
        # every exchanged replica is in `tried` on this path (the
        # except clause adds non-hedge failures, _forward adds both
        # hedge-race ids), so its size IS the attempt count
        out.attempts = max(1, len(tried))
        out.retried = retried
        out.hedged = meta["hedges"] > 0
        return out

    def _passthrough(self, response: UpstreamResponse) -> RouterResponse:
        out = RouterResponse(
            status=response.status,
            body=response.body,
            content_type=response.header(
                "content-type", "application/json; charset=UTF-8"),
        )
        for name in ("retry-after", "x-pio-trace-id"):
            value = response.header(name)
            if value:
                out.headers["-".join(p.capitalize()
                                     for p in name.split("-"))] = value
        return out

    # -- forwarding (single + hedged) ---------------------------------------
    def _forward_headers(self, headers: Mapping[str, str],
                         request_id: str, deadline: float | None,
                         trace: Trace | None = None,
                         parent_span: str = "") -> dict[str, str]:
        fwd = {"X-PIO-Request-Id": request_id}
        for name in _FORWARD_HEADERS:
            value = headers.get(name)
            if value:
                fwd[name] = value
        if trace is not None:
            # cross-process stitching (obs/stitch.py): the replica's
            # trace segment joins THIS trace, nested under the attempt
            # span whose id rides the parent-span header
            fwd[TRACE_ID_HEADER] = trace.trace_id
            if parent_span:
                fwd[PARENT_SPAN_HEADER] = parent_span
        else:
            # an untraced router still relays CLIENT-supplied context
            # so an upstream tracer (another router tier, a test
            # harness) keeps its continuity through this hop
            for name in (TRACE_ID_HEADER.lower(),
                         PARENT_SPAN_HEADER.lower()):
                value = headers.get(name)
                if value:
                    fwd[name] = value
        if deadline is not None:
            # the REMAINING budget, floored at 1ms: the backend must
            # see the end-to-end deadline, not the client's original
            remaining_ms = max(1.0, (deadline - time.monotonic()) * 1e3)
            fwd["X-PIO-Deadline-Ms"] = f"{remaining_ms:.0f}"
        return fwd

    def _exchange(self, backend: Backend, group: str,
                  body: bytes, headers: Mapping[str, str],
                  request_id: str, deadline: float | None,
                  trace: Trace | None = None,
                  label: str = "attempt") -> UpstreamResponse:
        """ONE attempt against ONE replica under its resilience policy.
        Raises StorageUnavailableError on transport failure, transient
        status, or an open breaker; returns any other response.

        May run on a hedge pool thread, so the trace is passed
        EXPLICITLY (no ambient contextvar there) and spans are appended
        with the lock-free ``add_span`` contract: the attempt's span id
        is reserved up front — it must ride the forward headers before
        the exchange runs — and recorded once the exchange finishes,
        so a hedge loser lands as its own sibling span and can never
        corrupt the winner's subtree."""
        parent_span = trace.reserve_span_id() if trace is not None else ""

        def attempt() -> UpstreamResponse:
            nonlocal attempted
            attempted = True
            remaining = self._remaining(deadline)
            timeout = self.config.upstream_timeout_s
            if remaining is not None:
                timeout = max(0.001, min(timeout, remaining))
            response = backend.transport.request(
                "POST", "/queries.json",
                headers=self._forward_headers(headers, request_id,
                                              deadline, trace, parent_span),
                body=body, timeout=timeout)
            if is_transient_http_status(response.status):
                # the shared retryability contract (utils/resilience):
                # 5xx/429 are health signals; other statuses —
                # including the backend's 4xx — are application answers
                raise UpstreamStatusError(backend.id, response)
            return response

        backend.begin()
        t0 = time.perf_counter()
        ok = False
        attempted = False
        try:
            response = resilient(backend.resilience, attempt)
            ok = True
            return response
        except StorageUnavailableError as exc:
            cause = exc.__cause__
            if isinstance(cause, (ConnectionRefusedError,
                                  ConnectionResetError)):
                # nothing is listening / the peer died mid-exchange:
                # don't wait for the probe loop to notice (it will
                # mark it back up when the replica returns)
                if backend.mark_down(str(cause)):
                    logger.warning(
                        "fleet backend %s marked down from the data "
                        "path: %s", backend.id, cause)
            raise
        finally:
            t1 = time.perf_counter()
            dt = t1 - t0
            backend.done()
            if attempted:
                # a breaker short-circuit never reached the replica:
                # it says nothing about the replica's health, so it
                # must not feed the canary guardrail window (a burst
                # racing one half-open probe slot would spuriously
                # abort a recovered canary) or the latency histograms
                self.stats.observe_upstream(group, dt)
                if ok:
                    # data-path proof for the membership starvation
                    # guard: a probe timeout against a replica that
                    # just answered is starvation, not death
                    backend.record_data_ok()
                if trace is not None:
                    # the attempt span, under its pre-reserved id (the
                    # one the replica's segment names as its parent)
                    trace.add_span(
                        f"{label}[{backend.id}]"
                        + ("" if ok else "!failed"),
                        t0, t1, span_id=parent_span)
                if ok and self.config.hedge:
                    # the hedge-delay histogram only matters when
                    # hedging can fire; disabled, its lock+bisect
                    # stays off the path
                    self.hedge_policy.observe(dt)
                if self.canary.record(group, ok, dt):
                    self.stats.bump("canary_aborts")
                    if self.on_canary_abort is not None:
                        try:
                            self.on_canary_abort()
                        except Exception:  # noqa: BLE001 — the abort itself already latched
                            logger.exception(
                                "canary abort propagation failed")

    def _forward(self, backend: Backend, group: str, tried: set[str],
                 body: bytes, headers: Mapping[str, str], request_id: str,
                 deadline: float | None, trace: Trace | None = None,
                 label: str = "attempt", meta: dict | None = None,
                 ) -> tuple[UpstreamResponse, str, bool]:
        """The primary exchange, optionally raced against one hedge.
        Returns ``(response, served_backend_id, hedge_fired)`` — with a
        hedge in flight the WINNER may be either replica, and the
        access log / trace tags must name the one that actually
        answered. ``meta["hedges"]`` is bumped when the hedge FIRES, so
        the caller still knows about it when both attempts fail and
        this raises instead of returning."""
        if not self.config.hedge:
            return (self._exchange(backend, group, body, headers,
                                   request_id, deadline, trace, label),
                    backend.id, False)
        remaining = self._remaining(deadline)
        alternates = self.membership.routable(
            group, exclude=tried | {backend.id})
        if not self.hedge_policy.should_hedge(len(alternates), remaining):
            return (self._exchange(backend, group, body, headers,
                                   request_id, deadline, trace, label),
                    backend.id, False)
        primary: Future = self._pool.submit(
            self._exchange, backend, group, body, headers, request_id,
            deadline, trace, label)
        done, _ = wait([primary], timeout=self.hedge_policy.delay_s())
        if done:
            tried.add(backend.id)
            # raises through to the retry loop on failure
            return primary.result(), backend.id, False
        hedge_backend = min(alternates, key=lambda b: b.inflight)
        self.stats.bump("hedges")
        if meta is not None:
            meta["hedges"] += 1
        hedge: Future = self._pool.submit(
            self._exchange, hedge_backend, group, body, headers,
            request_id, deadline, trace, "hedge")
        tried.add(backend.id)
        tried.add(hedge_backend.id)
        pending = {primary, hedge}
        failure: BaseException | None = None
        while pending:
            remaining = self._remaining(deadline)
            done, pending = wait(
                pending, timeout=remaining, return_when=FIRST_COMPLETED)
            if not done:          # deadline expired while both pending
                break
            for fut in done:
                exc = fut.exception()
                if exc is None:
                    if fut is hedge:
                        self.stats.bump("hedge_wins")
                    winner = (hedge_backend.id if fut is hedge
                              else backend.id)
                    return fut.result(), winner, True
                failure = exc
        if failure is not None:
            raise failure
        raise StorageUnavailableError(
            "router/hedge", "deadline expired with attempts in flight",
            retry_after=1.0)


def _embedded_response(exc: BaseException | None) -> UpstreamResponse | None:
    """The upstream response a failure carried, when the failure was a
    transient HTTP status rather than a transport error."""
    seen: set[int] = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, UpstreamStatusError):
            return exc.response
        exc = exc.__cause__
    return None
