"""The Fleet Router server: ``pio router`` on :8100 (a copy of the JAX
package's ``api/router_server.py``; the router process imports no torch
and never touches the card).

A thin HTTP process fronting N engine-server replicas. Routes:

- ``POST /queries.json``   forwarded to a healthy replica of the
                           DEFAULT engine (retry on a different one,
                           optional hedging, canary split) — body bytes
                           pass through untouched in BOTH directions:
                           the router never pays a JSON parse on the
                           hot path. ``X-PIO-Engine: <name>`` selects a
                           named engine instead
- ``POST /engines/<name>/queries.json``
                           the same, path-addressed per engine — each
                           engine is an independent backend group with
                           its own membership/breakers/canary/quota
                           (fleet/gateway.py, docs/fleet.md
                           "Multi-engine routing")
- ``GET|POST /fleet/engines`` the EngineTable: status JSON, and
                           key-authed register/retire/quota/weight
                           mutations propagated across --workers
                           siblings via the admin spool
- ``GET /``, ``GET /fleet`` fleet status document: per-backend state,
                           breaker, in-flight, canary, router counters
- ``GET /fleet/metrics``   every replica's /metrics scraped (bounded),
                           re-exported with replica/group labels +
                           pio_fleet_scrape_ok + the fleet-wide
                           pio_fleet_pressure gauge (docs/fleet.md)
- ``GET /traces.json``     the router's own trace ring; with
                           ``?trace_id=`` the CROSS-PROCESS stitched
                           tree (fan-out to replicas and --workers
                           siblings; obs/stitch.py, `pio trace`)
- ``GET|POST /fleet/canary`` canary admin: read the rollout state;
                           POST ``{"weight": 25}`` to start/resize,
                           ``{"action": "abort"}`` to kill it
                           (key-authenticated when ``--router-key``)
- ``GET|POST /fleet/experiments`` the online A/B plane
                           (experiment/controller.py): define an
                           experiment over registered variant engines,
                           fold attributed conversions in, read the
                           lifecycle + per-variant online scores;
                           mutations propagate over the admin spool
- ``GET /healthz``         router process liveness
- ``GET /readyz``          503 until at least one replica is routable
- ``GET /stats.json``      router counters + upstream latency
- ``GET /metrics``         Prometheus exposition (backend state gauge,
                           retries/hedges/sheds, canary weight, the
                           per-replica breaker families)
- ``POST /stop``           shutdown (key-authenticated)

Correlation: an inbound ``X-PIO-Request-Id`` is propagated to the
chosen replica and echoed on the response; the replica's
``X-PIO-Trace-Id`` (when it traced the query) passes back to the
client. The HTTP handler goes one step beyond the engine server's
hot-path discipline (keep-alive, TCP_NODELAY, chunked-body rejection):
the router sits on EVERY fleet query and does no model work to hide
parse costs behind, so its connection loop is a minimal single-buffer
parser with ONE write per response instead of the stdlib
``BaseHTTPRequestHandler`` machinery (``_read_request`` docstring).
"""

from __future__ import annotations

import json
import logging
import socketserver
import threading
import time
from typing import Mapping
from urllib.parse import parse_qs

from predictionio_tpu_torch.api.http_base import (
    REQUEST_ID_HEADER,
    PlainTextPayload,
    RestServer,
    access_log_enabled,
    emit_access_log,
    ensure_access_log_handler,
    resolve_request_id,
    retry_after_header,
)
from predictionio_tpu_torch.experiment.controller import (
    EXPERIMENT_FIELD,
    EXPERIMENT_HEADER,
    VARIANT_FIELD,
    VARIANT_HEADER,
    ExperimentConfig,
    ExperimentController,
    VariantSpec,
)
from predictionio_tpu_torch.experiment.grid import eval_points_collector
from predictionio_tpu_torch.fleet.canary import GuardrailConfig
from predictionio_tpu_torch.fleet.gateway import (
    QUERIES_PATH,
    EngineGateway,
)
from predictionio_tpu_torch.fleet.router import (
    FleetRouter,
    RouterConfig,
    RouterResponse,
)
from predictionio_tpu_torch.fleet.transport import fan_out
from predictionio_tpu_torch.fleet.workers import WorkerHub
from predictionio_tpu_torch.obs.aggregate import (
    ExpositionParseError,
    merge_snapshots,
    merge_sources,
    parse_exposition,
    relabel,
    source_count_metric,
)
from predictionio_tpu_torch.obs.exporter import CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE
from predictionio_tpu_torch.obs.exporter import render_metrics, render_prometheus
from predictionio_tpu_torch.obs.registry import (
    HistogramFamily,
    Metric,
    MetricRegistry,
    resilience_collector,
    server_info_collector,
)
from predictionio_tpu_torch.obs.slo import SLOEngine, pressure_metric
from predictionio_tpu_torch.obs.stitch import stitch
from predictionio_tpu_torch.obs.trace import (
    TRACE_ID_HEADER,
    TraceLog,
    parse_trace_context,
    start_trace,
    tracing_default,
    use_trace,
)

logger = logging.getLogger(__name__)


class _Reject(Exception):
    def __init__(self, status: int, message: str,
                 headers: dict[str, str] | None = None):
        self.status = status
        self.message = message
        self.headers = headers


class RouterService:
    """Transport-free request logic over an :class:`EngineGateway` —
    one router process, N independent engine groups (fleet/gateway.py).
    ``self.router`` stays the DEFAULT engine's FleetRouter, so every
    single-engine consumer (tests, the supervisor/controller wiring,
    operator muscle memory) is untouched."""

    def __init__(self, gateway: EngineGateway):
        self.gateway = gateway
        self.config = gateway.config
        self.on_stop = lambda: None
        self.access_log = access_log_enabled(self.config.access_log)
        if self.access_log:
            ensure_access_log_handler()
        #: fleet tracing (docs/observability.md): the router opens the
        #: ROOT segment of every traced query and forwards context so
        #: replica segments stitch under its attempt spans
        self.tracing = (self.config.tracing
                        if self.config.tracing is not None
                        else tracing_default())
        self.trace_log = TraceLog()
        #: SLO engine (obs/slo.py): every routed query's outcome feeds
        #: the burn-rate gauges — at the ROUTER the availability SLO
        #: measures what CLIENTS see (sheds and all-replicas-down count
        #: against the budget even though no replica mis-served)
        self.slo = SLOEngine()
        self.request_latency = HistogramFamily(
            "pio_http_request_seconds",
            "HTTP request walltime by route (handler-measured)",
            "route", ("queries", "fleet", "metrics", "status", "traces"))
        self.registry = MetricRegistry()
        self.registry.register(self.request_latency.collect)
        #: per-engine router families (single implicit engine renders
        #: exactly the pre-gateway exposition; multi-engine adds the
        #: engine label + quota/burn families — fleet/gateway.py)
        self.registry.register(gateway.collector())
        self.registry.register(resilience_collector())
        self.registry.register(server_info_collector("router"))
        self.registry.register(self.slo.collector())
        #: `--workers N` peering (fleet/workers.py): a /metrics scrape
        #: landing on THIS worker merges every sibling's registry
        self.worker_hub: WorkerHub | None = (
            WorkerHub(self.config.worker_spool_dir,
                      metrics_text=lambda: render_prometheus(self.registry),
                      traces_snapshot=self.trace_log.snapshot,
                      timeout_s=self.config.scrape_timeout_s)
            if self.config.worker_spool_dir else None)
        #: shared admin state (fleet/workers.py): canary mutations and
        #: guardrail abort verdicts published by ANY worker are applied
        #: by every sibling's sync loop, and a respawned worker adopts
        #: the latest document at startup instead of the launch-time
        #: weight — admin no longer addresses ONE worker
        self._admin_lock = threading.Lock()
        self._admin_seq = 0
        self._admin_stop = threading.Event()
        self._admin_thread: threading.Thread | None = None
        #: optional self-healing attachments (`pio router --supervise`):
        #: the process supervisor and the scale controller register
        #: their collectors and appear in the /fleet document
        self.supervisor = None
        self.controller = None
        self.scale_set = None
        #: online A/B (experiment/controller.py): splits bare-path
        #: query traffic across variant engines, auto-promotes through
        #: the guardrail discipline; every verdict publishes to the
        #: admin spool (the `experiment` key of the cumulative doc).
        #: Ticks ride the admin sync loop's Event.wait below plus the
        #: outcome feed — the controller itself never sleeps.
        self.experiment = ExperimentController(
            gateway=self.gateway,
            on_change=lambda: self._publish_admin(
                {"action": "experiment"}))
        self.registry.register(self.experiment.collector)
        self.registry.register(eval_points_collector)
        if self.worker_hub is not None:
            self._wire_abort_hooks()
            self._sync_admin_once()     # respawn adoption
            self._admin_thread = threading.Thread(
                target=self._admin_sync_loop,
                name="pio-router-admin-sync", daemon=True)
            self._admin_thread.start()

    @property
    def router(self) -> FleetRouter:
        """The CURRENT default engine's FleetRouter — resolved per
        access, not captured at construction: a runtime
        ``{"action": "default"}`` table mutation must repoint
        /stats.json, the /fleet doc and the probe reporting too, or an
        operator would watch a retired engine's frozen counters while
        believing they see the default tenant."""
        return self.gateway.default_group.router

    def _wire_abort_hooks(self) -> None:
        """Every engine group's guardrail verdict publishes to the
        admin spool — idempotent, re-run after table mutations so
        runtime-registered engines latch their siblings too."""
        for group in self.gateway.groups():
            if group.router.on_canary_abort is None:
                group.router.on_canary_abort = self._publish_canary_abort

    def attach_supervisor(self, supervisor) -> None:
        from predictionio_tpu_torch.fleet.supervisor import supervisor_collector

        self.supervisor = supervisor
        self.registry.register(supervisor_collector(supervisor))

    def attach_controller(self, controller) -> None:
        from predictionio_tpu_torch.fleet.controller import controller_collector

        self.controller = controller
        self.registry.register(controller_collector(controller))

    def attach_scale_set(self, scale_set) -> None:
        """Per-tenant elasticity (`pio router --engine ... --supervise`
        with scaling armed): one ScaleController per engine behind a
        CapacityArbiter. Mutually exclusive with attach_controller —
        the scale-set collector owns the pio_fleet_desired_replicas /
        decisions families (labeled per engine when the gateway is)."""
        from predictionio_tpu_torch.fleet.controller import scale_set_collector

        self.scale_set = scale_set
        self.registry.register(scale_set_collector(scale_set))

    def close(self) -> None:
        self._admin_stop.set()
        if self._admin_thread is not None:
            self._admin_thread.join(timeout=5)
            self._admin_thread = None
        if self.worker_hub is not None:
            self.worker_hub.close()

    # -- shared admin state (fleet/workers.py) -------------------------------
    def _admin_sync_loop(self) -> None:
        # Event.wait doubles as interval sleep and prompt stop — the
        # membership-loop idiom, never a bare time.sleep
        while not self._admin_stop.wait(self.config.admin_sync_interval_s):
            try:
                self._sync_admin_once()
            except Exception:  # noqa: BLE001 — a torn read is the next pass's problem
                logger.exception("admin-state sync failed")
            try:
                # experiment lifecycle ticks ride this Event.wait loop
                # (the controller never sleeps on its own)
                self.experiment.tick()
            except Exception:  # noqa: BLE001
                logger.exception("experiment tick failed")

    def _sync_admin_once(self) -> None:
        hub = self.worker_hub
        if hub is None:
            return
        doc = hub.read_admin()
        if doc is None:
            return
        with self._admin_lock:
            if doc["seq"] <= self._admin_seq:
                return
            self._admin_seq = doc["seq"]
        self._apply_admin(doc)

    def _apply_admin(self, doc: dict) -> None:
        # cumulative engine-table documents (fleet/gateway.py): every
        # publish carries the WHOLE table (specs + per-engine canary
        # state), so a respawned worker adopts everything from the one
        # latest document — register/retire/quota/weight/abort all ride
        # the same diff-apply. The legacy action fields remain for
        # operator readability (and the pinned abort-doc shape).
        experiment = doc.get("experiment")
        if isinstance(experiment, dict):
            try:
                if self.experiment.adopt_state(experiment):
                    logger.info("adopted shared experiment state "
                                "(seq %s): %s", doc.get("seq"),
                                experiment.get("state"))
            except Exception:  # noqa: BLE001 — a bad doc must not kill the sync loop
                logger.exception("adopting shared experiment state "
                                 "failed (seq %s)", doc.get("seq"))
        fleet = doc.get("fleet")
        if isinstance(fleet, dict):
            try:
                changed = self.gateway.adopt_table(fleet)
            except Exception:  # noqa: BLE001 — a bad doc must not kill the sync loop
                logger.exception("adopting shared engine table failed "
                                 "(seq %s)", doc.get("seq"))
                return
            self._wire_abort_hooks()
            if changed:
                logger.info("adopted shared engine table (seq %d): %s",
                            doc["seq"], doc.get("action"))
            return
        action = doc.get("action")
        target = self.gateway.get(
            str(doc.get("engine") or self.gateway.default_engine))
        canary = (target or self.gateway.default_group).router.canary
        if action == "set_weight":
            try:
                weight = float(doc["weight"])
            except (KeyError, TypeError, ValueError):
                logger.warning("ignoring malformed admin doc: %r", doc)
                return
            guardrail = None
            g = doc.get("guardrail")
            if isinstance(g, dict):
                try:
                    guardrail = GuardrailConfig(
                        min_requests=int(g["minRequests"]),
                        max_error_rate=float(g["maxErrorRate"]),
                        max_p99_ms=float(g["maxP99Ms"]),
                        window=int(g["window"]))
                except (KeyError, TypeError, ValueError):
                    guardrail = None
            canary.set_weight(weight, guardrail=guardrail)
            logger.info("adopted shared canary weight %.1f%% (seq %d)",
                        weight, doc["seq"])
        elif action == "abort":
            canary.abort(
                str(doc.get("reason") or "sibling abort"))
            logger.warning("adopted sibling canary abort (seq %d): %s",
                           doc["seq"], doc.get("reason"))
        else:
            logger.warning("unknown admin action %r (seq %s)", action,
                           doc.get("seq"))

    def _publish_admin(self, doc: dict) -> None:
        hub = self.worker_hub
        if hub is None:
            return
        # every publish is CUMULATIVE: the whole engine table (specs +
        # per-engine canary state) and the experiment state ride along,
        # so the LATEST document alone is sufficient for a respawned
        # sibling — an action log would strand whichever mutation was
        # published second-to-last
        doc = {**doc, "fleet": self.gateway.table_doc()}
        experiment_doc = self.experiment.state_doc()
        if experiment_doc is not None:
            doc["experiment"] = experiment_doc
        # publish AND advance _admin_seq under the one lock: the sync
        # loop compares seq under the same lock, so it can never read
        # the freshly-committed document in a gap before the seq
        # advances and re-apply our own mutation (a re-applied
        # set_weight would clear the guardrail window a second time)
        with self._admin_lock:
            try:
                seq = hub.publish_admin(doc)
            except OSError:
                logger.exception("publishing admin state failed")
                return
            self._admin_seq = max(self._admin_seq, seq)

    def _publish_canary_abort(self) -> None:
        """FleetRouter.on_canary_abort hook: a guardrail verdict on
        THIS worker latches every sibling too — one worker's window
        seeing the breach first must not leave the others happily
        routing canary traffic. Shared by every engine group's hook:
        the published table carries EVERY canary's state, the legacy
        reason field names the (most recently) aborted one."""
        reason = None
        engine = None
        for group in self.gateway.groups():
            snap = group.router.canary.snapshot()
            if snap["aborted"] and snap.get("abortReason"):
                reason = snap["abortReason"]
                engine = group.name
                if group.name == self.gateway.default_engine:
                    break
        self._publish_admin({
            "action": "abort",
            "reason": reason or "guardrail abort",
            **({"engine": engine} if engine else {}),
        })

    # -- auth ---------------------------------------------------------------
    def _check_router_key(self, params: Mapping[str, str]) -> None:
        if self.config.router_key is None:
            return
        if params.get("accessKey") != self.config.router_key:
            raise _Reject(401, "invalid accessKey")

    # -- routes -------------------------------------------------------------
    def handle(self, method: str, path: str, params: Mapping[str, str],
               headers: Mapping[str, str], body: bytes,
               request_id: str) -> RouterResponse | tuple:
        """Returns a RouterResponse (raw passthrough) or the engine
        server's ``(status, payload[, headers])`` tuple shape."""
        try:
            if method == "POST" and self.gateway.is_query_path(path):
                # experiment split first: a bare-path query with no
                # explicit engine selection may be assigned to a
                # variant (experiment/controller.py) — the assignment
                # rides the X-PIO-Engine header into the same O(1)
                # resolution everything else uses, and the attribution
                # pair is forwarded to the replica + stamped on the
                # response
                assigned = self._experiment_assign(path, headers)
                if assigned is not None:
                    experiment_id, variant = assigned
                    headers = {**headers,
                               "x-pio-engine": variant,
                               "x-pio-experiment": experiment_id,
                               "x-pio-variant": variant}
                # O(1) engine resolution on the path (bare
                # /queries.json → default engine or X-PIO-Engine
                # header), per-engine quota, then the engine's own
                # pick/forward/retry/hedge (fleet/gateway.py)
                out = self.gateway.route(path, body, headers,
                                         request_id)
                if assigned is not None:
                    self._stamp_attribution(out, experiment_id, variant)
                return out
            if method == "GET" and path in ("/", "/fleet"):
                return (200, self.fleet_doc())
            if method == "GET" and path == "/stats.json":
                return (200, {"router": self.router.stats.snapshot(),
                              "canary": self.router.canary.snapshot(),
                              "engines": self.gateway.snapshot()})
            if path == "/fleet/engines":
                if method == "GET":
                    return (200, self.engines_doc())
                if method == "POST":
                    self._check_router_key(params)
                    return self.engines_admin(body)
            if method == "GET" and path == "/metrics":
                return (200, PlainTextPayload(
                    self.metrics_text(), PROMETHEUS_CONTENT_TYPE))
            if method == "GET" and path == "/fleet/metrics":
                return (200, PlainTextPayload(
                    self.fleet_metrics_text(), PROMETHEUS_CONTENT_TYPE))
            if method == "GET" and path == "/traces.json":
                trace_id = params.get("trace_id")
                if trace_id:
                    return self.stitched_trace(trace_id)
                return (200, {"tracing": self.tracing,
                              "traces": self.trace_log.snapshot()})
            if method == "GET" and path == "/healthz":
                return (200, {"status": "ok"})
            if method == "GET" and path == "/readyz":
                return self.readyz()
            if path == "/fleet/canary":
                if method == "GET":
                    return (200, self.router.canary.snapshot())
                if method == "POST":
                    self._check_router_key(params)
                    return self.canary_admin(body)
            if path == "/fleet/experiments":
                if method == "GET":
                    self.experiment.tick()
                    return (200,
                            {"experiment": self.experiment.snapshot()})
                if method == "POST":
                    self._check_router_key(params)
                    return self.experiments_admin(body)
            if method == "POST" and path == "/stop":
                self._check_router_key(params)
                threading.Thread(target=self.on_stop, daemon=True).start()
                return (200, {"message": "Shutting down"})
            return (404, {"message": f"no route for {method} {path}"})
        except _Reject as r:
            if r.headers:
                return (r.status, {"message": r.message}, r.headers)
            return (r.status, {"message": r.message})
        except Exception as e:
            logger.exception("unhandled error in %s %s", method, path)
            return (500, {"message": f"internal error: {e}"})

    # -- scrape-time aggregation (docs/fleet.md) ----------------------------
    def metrics_text(self) -> str:
        """This worker's exposition — merged with every live sibling's
        when `--workers N` peering is on (counters summed, histograms
        bucket-merged, gauges labeled per worker), so a scrape landing
        on one SO_REUSEPORT worker reports fleet-of-workers truth."""
        own = self.registry.collect()
        hub = self.worker_hub
        if hub is None:
            return render_metrics(own)
        sources: list[tuple[str, list]] = [(hub.worker_id, own)]
        for worker_id, body in hub.fetch_peer_bodies("/metrics"):
            try:
                sources.append((worker_id,
                                parse_exposition(body.decode())))
            except (ExpositionParseError, UnicodeDecodeError) as exc:
                logger.warning("worker %s exposition unparseable: %s",
                               worker_id, exc)
        merged = merge_sources(sources, source_label="worker")
        merged.append(source_count_metric(
            "pio_router_workers",
            "Live router worker processes folded into this scrape",
            len(sources)))
        return render_metrics(merged)

    def fleet_metrics_text(self) -> str:
        return render_metrics(self.fleet_metrics_families())

    def fleet_metrics_families(self) -> list[Metric]:
        """Scrape every replica's ``/metrics`` (bounded per replica by
        ``scrape_timeout_s``) across EVERY engine group and re-export
        with ``replica``/``group`` labels — plus ``engine=<name>`` when
        the deployment is explicitly multi-engine (the single implicit
        engine keeps the pre-gateway label set; obs/aggregate.relabel
        never overwrites a label a replica already exports, so a
        replica's own ``engine`` label survives the annotation). The
        fleet-wide ``pio_fleet_pressure`` gauge derives from the
        bucket-merged queue-wait/device-dispatch histograms, with a
        per-engine sample per group in multi-engine mode (the signal
        the ScaleController needs to scale engines independently).
        Scrapes bypass the data-path breakers on purpose: a failed
        scrape must not mark a replica down for traffic, it just
        reports ``pio_fleet_scrape_ok 0``. Returned as Metric families
        so the scale controller reads the same contract WITHOUT a
        render→reparse round-trip per tick (``GET /fleet/metrics``
        renders them)."""
        labeled = self.gateway.labeled
        scrape_ok = Metric(
            name="pio_fleet_scrape_ok", kind="gauge",
            help="1 when the replica answered the fan-out scrape")

        def scrape(item) -> tuple[dict, list | None]:
            engine, backend = item
            labels = {"replica": backend.id, "group": backend.group,
                      **({"engine": engine} if labeled else {})}
            try:
                response = backend.transport.request(
                    "GET", "/metrics",
                    timeout=self.config.scrape_timeout_s)
                if response.status != 200:
                    raise ExpositionParseError(
                        f"HTTP {response.status}")
                return labels, parse_exposition(response.body.decode())
            except Exception as exc:  # noqa: BLE001 — degrade per replica
                logger.warning("fleet scrape of %s failed: %s",
                               backend.id, exc)
                return labels, None

        sources: list[tuple[str, list]] = []
        # queue/device histograms accumulate per ENGINE (plus the
        # fleet-wide merge across all of them)
        queue_snaps: dict[str, list] = {}
        device_snaps: dict[str, list] = {}
        # ONE membership snapshot per group for both the fan-out and
        # the zip: `backends` is a per-call copy and the scale
        # controller mutates the underlying list at runtime — a second
        # read could be shorter/shifted and attribute scrape results to
        # the wrong replica
        targets = [
            (group.name, backend)
            for group in self.gateway.groups()
            for backend in group.router.membership.backends
        ]
        # concurrent per replica (fan_out): the scrape pays the slowest
        # replica's timeout, not the sum over black-holed ones
        scraped = fan_out(targets, scrape)
        for (engine, backend), result in zip(targets, scraped):
            if result is None:
                continue
            labels, families = result
            if families is None:
                scrape_ok.samples.append((labels, 0.0))
                continue
            scrape_ok.samples.append((labels, 1.0))
            for fam in families:
                if fam.name == "pio_serving_queue_wait_seconds":
                    queue_snaps.setdefault(engine, []).extend(
                        s for _, s in fam.histograms)
                elif fam.name == "pio_serving_device_dispatch_seconds":
                    device_snaps.setdefault(engine, []).extend(
                        s for _, s in fam.histograms)
            sources.append((backend.id, relabel(families, labels)))
        merged = merge_sources(sources, source_label="replica")
        merged.append(scrape_ok)
        all_queue = [s for snaps in queue_snaps.values() for s in snaps]
        all_device = [s for snaps in device_snaps.values() for s in snaps]
        if all_queue and all_device:
            pressure = pressure_metric(
                merge_snapshots(all_queue), merge_snapshots(all_device))
            if labeled:
                for engine in queue_snaps:
                    if engine not in device_snaps:
                        continue
                    per = pressure_metric(
                        merge_snapshots(queue_snaps[engine]),
                        merge_snapshots(device_snaps[engine]),
                        labels={"engine": engine})
                    pressure.samples.extend(per.samples)
            merged.append(pressure)
        if self.scale_set is not None:
            # the per-tenant elasticity families ride the fleet-facing
            # exposition too: every scale decision is attributed
            # `engine=` right next to the pressure signal it answered
            # (the acceptance contract; also in /metrics via the
            # registry). The scale set's own sweep only reads
            # pio_fleet_pressure from this list — no recursion.
            from predictionio_tpu_torch.fleet.controller import (
                scale_set_collector,
            )

            merged.extend(scale_set_collector(self.scale_set)())
        return merged

    def stitched_trace(self, trace_id: str) -> tuple:
        """``GET /traces.json?trace_id=`` — fan out to every replica's
        (and worker sibling's) trace ring, join the segments that share
        ``trace_id`` into one tree (obs/stitch.py)."""
        segments = self.trace_log.find(trace_id)
        hub = self.worker_hub
        if hub is not None:
            for worker_id, body in hub.fetch_peer_bodies("/traces.json"):
                try:
                    docs = json.loads(body).get("traces", [])
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue
                for doc in docs:
                    if doc.get("traceId") == trace_id:
                        doc.setdefault("source", f"worker:{worker_id}")
                        segments.append(doc)
        def fetch_ring(backend) -> list | None:
            try:
                response = backend.transport.request(
                    "GET", "/traces.json",
                    timeout=self.config.scrape_timeout_s)
                return json.loads(response.body).get("traces", [])
            except Exception:  # noqa: BLE001 — a dead replica's ring is gone anyway
                return None

        scrape_errors = 0
        # concurrent per replica ACROSS every engine group: the merge
        # pays the slowest replica's timeout, not the sum
        # (fleet/transport.fan_out); one snapshot for fan-out AND zip —
        # the backend lists mutate at runtime
        backends = [
            backend
            for group in self.gateway.groups()
            for backend in group.router.membership.backends
        ]
        rings = fan_out(backends, fetch_ring)
        for backend, docs in zip(backends, rings):
            if docs is None:
                scrape_errors += 1
                continue
            for doc in docs:
                if doc.get("traceId") == trace_id:
                    doc.setdefault("source", backend.id)
                    segments.append(doc)
        tree = stitch(segments)
        if tree is None:
            return (404, {"traceId": trace_id, "found": False,
                          "scrapeErrors": scrape_errors,
                          "message": f"no segment of trace {trace_id} "
                                     "found on router or replicas"})
        return (200, {"traceId": trace_id, "found": True,
                      "segments": len(segments),
                      "scrapeErrors": scrape_errors,
                      "trace": tree})

    def readyz(self) -> tuple:
        """Ready iff at least one replica is routable in ANY engine
        group — a router with no serveable engine at all must drain
        from ITS OWN load balancer too (one dark tenant does not; its
        requests answer fast 503s while the siblings keep serving)."""
        by_engine = {
            group.name: len(group.router.membership.routable())
            for group in self.gateway.groups()
        }
        routable = sum(by_engine.values())
        extra = ({"routableByEngine": by_engine}
                 if self.gateway.labeled else {})
        if routable > 0:
            return (200, {"status": "ready",
                          "routableBackends": routable, **extra})
        return (503, {"status": "unavailable", "routableBackends": 0,
                      **extra},
                {"Retry-After": retry_after_header(
                    max(1.0, self.router.membership.probe_interval_s))})

    def fleet_doc(self) -> dict:
        return {
            "status": "alive",
            # flattened across engine groups: identical to the
            # pre-gateway doc for the single implicit engine (each
            # backend snapshot carries its engine name when a gateway
            # stamped one); canary/router keys stay the DEFAULT
            # engine's — per-engine views live on /fleet/engines
            "backends": [
                doc
                for group in self.gateway.groups()
                for doc in group.router.membership.snapshot()
            ],
            "canary": self.router.canary.snapshot(),
            "router": self.router.stats.snapshot(),
            "defaultEngine": self.gateway.default_engine,
            "engines": self.gateway.engine_names(),
            "inflight": self.router.inflight,
            "maxInflight": self.config.max_inflight,
            "hedge": self.config.hedge,
            "probe": {
                "intervalS": self.router.membership.probe_interval_s,
                "timeoutS": self.router.membership.probe_timeout_s,
                "downAfter": self.router.membership.down_after,
                "upAfter": self.router.membership.up_after,
            },
            **({"supervisor": self.supervisor.snapshot()}
               if self.supervisor is not None else {}),
            **({"scaleController": self.controller.snapshot()}
               if self.controller is not None else {}),
            **({"elasticity": self.scale_set.snapshot()}
               if self.scale_set is not None else {}),
            **({"experiment": exp_snap}
               if (exp_snap := self.experiment.snapshot()) is not None
               else {}),
        }

    def engines_doc(self) -> dict:
        """``GET /fleet/engines``: the gateway table, each engine
        annotated with its scale state (bounds, desired/actual, last
        decision+reason) when an elasticity loop — per-tenant scale
        set or the single controller — is attached. Storage-free:
        everything comes from in-process snapshots."""
        doc = self.gateway.snapshot()
        scales: dict[str, dict] = {}
        if self.scale_set is not None:
            scales = self.scale_set.snapshot()["engines"]
        elif self.controller is not None:
            scales = {self.gateway.default_engine:
                      self.controller.snapshot()}
        if scales:
            for entry in doc["engines"]:
                snap = scales.get(entry.get("name"))
                if snap is None:
                    continue
                entry["scale"] = {
                    "minReplicas": snap["minReplicas"],
                    "maxReplicas": snap["maxReplicas"],
                    "desiredReplicas": snap["desiredReplicas"],
                    "actualReplicas": snap["actualReplicas"],
                    "dryRun": snap["dryRun"],
                    "lastDecision": snap.get("lastDecision"),
                    "lastReason": snap.get("lastReason"),
                }
        exp_snap = self.experiment.snapshot()
        if exp_snap is not None:
            # `pio status --router` reads this key for the experiment
            # block (cli/pio.py)
            doc["experiment"] = exp_snap
        return doc

    def engines_admin(self, body: bytes) -> tuple:
        """POST /fleet/engines (key-authed): mutate the engine table at
        runtime — ``{"action": "register", "engine": {...}}``,
        ``{"action": "retire"|"quota"|"weight"|"default",
        "name": <engine>, ...}`` (fleet/gateway.py). Every mutation
        publishes the cumulative table to the worker spool so siblings
        and respawned workers adopt it."""
        try:
            doc = json.loads(body or b"{}")
        except json.JSONDecodeError:
            raise _Reject(400, "the request body is not valid JSON")
        if not isinstance(doc, dict):
            raise _Reject(400, "the request body must be a JSON object")
        # adopt the latest sibling state BEFORE applying the local
        # mutation: the publish below is CUMULATIVE (the whole table),
        # so publishing from a stale view would silently erase a
        # sibling's not-yet-synced mutation fleet-wide (e.g. a tenant
        # registered through another worker inside the sync interval,
        # retired everywhere by this publish). This shrinks the
        # last-writer-wins window from admin_sync_interval_s to the
        # mutation handling itself; truly simultaneous conflicting
        # publishes remain last-writer-wins — the documented contract
        # for human-speed admin (fleet/workers.py)
        self._sync_admin_once()
        try:
            snap = self.gateway.admin_mutate(doc)
        except ValueError as exc:
            raise _Reject(400, str(exc))
        self._wire_abort_hooks()
        self._publish_admin(
            {"action": f"engines_{doc.get('action')}"})
        logger.info("engine table mutated: %s", doc.get("action"))
        return (200, snap)

    def canary_admin(self, body: bytes) -> tuple:
        """POST /fleet/canary: ``{"weight": <0..100>[, "guardrail":
        {...}]}`` starts/resizes a rollout (clearing any abort latch);
        ``{"action": "abort"}`` kills it. An optional ``"engine"`` key
        targets a named engine's canary; absent, the DEFAULT engine —
        the single-engine contract unchanged."""
        try:
            doc = json.loads(body or b"{}")
        except json.JSONDecodeError:
            raise _Reject(400, "the request body is not valid JSON")
        if not isinstance(doc, dict):
            raise _Reject(400, "the request body must be a JSON object")
        # sync-before-mutate, same reason as engines_admin: this
        # mutation's publish carries the WHOLE table
        self._sync_admin_once()
        engine = doc.get("engine")
        if engine is None:
            group = self.gateway.default_group
        else:
            group = self.gateway.get(str(engine))
            if group is None:
                raise _Reject(400, f"unknown engine {engine!r}")
        canary = group.router.canary
        engine_field = ({"engine": group.name}
                        if group.name != self.gateway.default_engine
                        else {})
        if doc.get("action") == "abort":
            canary.abort()
            self._publish_admin({"action": "abort",
                                 "reason": "operator abort",
                                 **engine_field})
            return (200, canary.snapshot())
        if "weight" not in doc:
            raise _Reject(400, 'expected {"weight": <0..100>} or '
                               '{"action": "abort"}')
        try:
            weight = float(doc["weight"])
        except (TypeError, ValueError):
            raise _Reject(400, f"invalid weight: {doc['weight']!r}")
        if not 0.0 <= weight <= 100.0:
            raise _Reject(400, "weight must be within 0..100")
        guardrail = None
        if isinstance(doc.get("guardrail"), dict):
            g = doc["guardrail"]
            current = canary.guardrail
            try:
                guardrail = GuardrailConfig(
                    min_requests=int(g.get("minRequests",
                                           current.min_requests)),
                    max_error_rate=float(g.get("maxErrorRate",
                                               current.max_error_rate)),
                    max_p99_ms=float(g.get("maxP99Ms", current.max_p99_ms)),
                    window=int(g.get("window", current.window)),
                )
            except (TypeError, ValueError) as exc:
                raise _Reject(400, f"invalid guardrail: {exc}")
        canary.set_weight(weight, guardrail=guardrail)
        admin_doc: dict = {"action": "set_weight", "weight": weight,
                          **engine_field}
        if guardrail is not None:
            admin_doc["guardrail"] = {
                "minRequests": guardrail.min_requests,
                "maxErrorRate": guardrail.max_error_rate,
                "maxP99Ms": guardrail.max_p99_ms,
                "window": guardrail.window,
            }
        self._publish_admin(admin_doc)
        logger.info("canary weight set to %.1f%% (engine %s)", weight,
                    group.name)
        return (200, canary.snapshot())

    # -- experimentation (experiment/controller.py) --------------------------
    def _experiment_assign(self, path: str,
                           headers: Mapping[str, str]) -> tuple | None:
        """A bare-path query with no explicit engine selection is
        eligible for the experiment split; path- or header-addressed
        queries keep their explicit routing — an experiment must never
        hijack a client that asked for a specific tenant."""
        if path != QUERIES_PATH or headers.get("x-pio-engine"):
            return None
        return self.experiment.assign()

    def _stamp_attribution(self, out: RouterResponse, experiment_id: str,
                           variant: str) -> None:
        """Attribution on the way out: headers always; the prId-style
        body fields only when the replica didn't already stamp them
        (it does when the forwarded attribution headers reached it).
        Only experiment-ASSIGNED responses pay this parse — the normal
        hot path keeps its bytes-through-untouched contract."""
        out.headers[EXPERIMENT_HEADER] = experiment_id
        out.headers[VARIANT_HEADER] = variant
        if out.status != 200 or not out.body \
                or "json" not in (out.content_type or ""):
            return
        try:
            doc = json.loads(out.body)
        except ValueError:
            return
        if not isinstance(doc, dict) or EXPERIMENT_FIELD in doc:
            return
        doc[EXPERIMENT_FIELD] = experiment_id
        doc[VARIANT_FIELD] = variant
        out.body = json.dumps(doc).encode()

    def experiments_admin(self, body: bytes) -> tuple:
        """POST /fleet/experiments (key-authed):

        - ``{"action": "define", "experiment": {...}, "variants":
          [...]}`` starts THE experiment over already-registered
          gateway engines (``pio experiment start`` registers them
          first via POST /fleet/engines);
        - ``{"action": "conversions", "experiment": <name>,
          "conversions": {<variant>: <total>, ...}}`` folds attributed
          conversion totals into the online score (cumulative totals —
          replays never double-count);
        - ``{"action": "abort"[, "reason": ...]}`` kills it.

        Every mutation publishes the seq'd cumulative experiment doc
        to the worker spool (sync-before-mutate, same as the engine
        table) so siblings and respawns agree."""
        try:
            doc = json.loads(body or b"{}")
        except json.JSONDecodeError:
            raise _Reject(400, "the request body is not valid JSON")
        if not isinstance(doc, dict):
            raise _Reject(400, "the request body must be a JSON object")
        self._sync_admin_once()
        action = doc.get("action", "define")
        if action == "define":
            try:
                config = ExperimentConfig.from_doc(doc["experiment"])
                variants = [VariantSpec.from_doc(v)
                            for v in doc["variants"]]
            except (KeyError, TypeError, ValueError) as exc:
                raise _Reject(400, f"invalid experiment definition: {exc}")
            missing = [v.name for v in variants
                       if self.gateway.get(v.name) is None]
            if missing:
                raise _Reject(400, "variants are not registered engines: "
                                   f"{missing} (POST /fleet/engines first)")
            try:
                self.experiment.define(config, variants)
            except ValueError as exc:
                raise _Reject(400, str(exc))
        elif action == "conversions":
            counts = doc.get("conversions")
            if not isinstance(counts, dict):
                raise _Reject(400, 'expected {"conversions": '
                                   '{<variant>: <total>}}')
            for variant, count in counts.items():
                try:
                    self.experiment.record_conversions(
                        str(variant), int(count))
                except (TypeError, ValueError):
                    raise _Reject(400, f"invalid conversion count for "
                                       f"{variant!r}: {count!r}")
        elif action == "abort":
            self.experiment.abort(str(doc.get("reason")
                                      or "operator abort"))
        else:
            raise _Reject(400, f"unknown experiment action {action!r}")
        self.experiment.tick()
        return (200, {"experiment": self.experiment.snapshot()})


#: canned reason phrases for the statuses the router emits (the full
#: http.HTTPStatus table costs a lookup per response; this is a dict hit)
_REASONS = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
            404: "Not Found", 411: "Length Required",
            429: "Too Many Requests",
            500: "Internal Server Error", 502: "Bad Gateway",
            503: "Service Unavailable"}

_MAX_HEADER_BYTES = 64 * 1024


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        self.status = status
        self.message = message


def _read_request(sock, buf: bytearray):
    """One inbound request off a keep-alive socket: ``(method, target,
    lower-cased header dict, body bytes)``; None on clean EOF at a
    message boundary. Raises ``_BadRequest`` (answer-and-close) on a
    malformed message, ``OSError``/``TimeoutError`` on transport death.

    The stdlib ``BaseHTTPRequestHandler`` costs ~1-2ms CPU per request
    (readline loop + email-parser headers + per-response strftime).
    The router sits on EVERY fleet query, so its inbound hot
    path uses the same minimal single-buffer parse as its upstream
    transport; the engine server keeps the stdlib handler (its predict
    work dwarfs the parse; the router's doesn't)."""
    while True:
        head_end = buf.find(b"\r\n\r\n")
        if head_end >= 0:
            break
        if len(buf) > _MAX_HEADER_BYTES:
            raise _BadRequest(400, "oversized request headers")
        chunk = sock.recv(65536)
        if not chunk:
            if buf:
                raise _BadRequest(400, "truncated request")
            return None
        buf += chunk
    head = bytes(buf[:head_end]).decode("latin-1")
    lines = head.split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise _BadRequest(400, f"malformed request line {lines[0]!r}")
    method, target = parts[0], parts[1]
    headers: dict[str, str] = {}
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if sep:
            headers[name.strip().lower()] = value.strip()
    if headers.get("transfer-encoding"):
        # chunked bodies would desync every later request on the
        # socket — 411 and close (RFC 9112 §6.3)
        raise _BadRequest(
            411, "chunked request bodies are not supported; "
                 "send Content-Length")
    length_raw = headers.get("content-length", "0")
    if not length_raw.isdigit():
        raise _BadRequest(400, "invalid Content-Length")
    need = head_end + 4 + int(length_raw)
    while len(buf) < need:
        chunk = sock.recv(65536)
        if not chunk:
            raise _BadRequest(400, "request body truncated")
        buf += chunk
    body = bytes(buf[head_end + 4:need])
    del buf[:need]
    return method, target, headers, body


class _Handler(socketserver.StreamRequestHandler):
    """Lean connection loop: minimal parse → service → ONE buffered
    write per response (status line, headers, body in a single
    sendall), keep-alive by default, 30s idle reap. Bound to the
    service by RestServer exactly like the stdlib handlers."""

    service: RouterService  # bound per server
    timeout = 30
    disable_nagle_algorithm = True

    _ROUTE_LABELS = {
        "/queries.json": "queries",
        "/fleet": "fleet",
        "/fleet/canary": "fleet",
        "/fleet/engines": "fleet",
        "/fleet/experiments": "fleet",
        "/metrics": "metrics",
        "/fleet/metrics": "metrics",
        "/traces.json": "traces",
        "/": "status",
    }

    def handle(self) -> None:
        sock = self.connection
        buf = bytearray()
        while True:
            try:
                parsed = _read_request(sock, buf)
            except _BadRequest as bad:
                self._send(sock, bad.status,
                           json.dumps({"message": bad.message}).encode(),
                           "application/json; charset=UTF-8",
                           {"Connection": "close"}, None)
                return
            except OSError:     # incl. the 30s idle-timeout reap
                return
            if parsed is None:
                return          # clean close between requests
            if not self._dispatch(sock, *parsed):
                return

    def _dispatch(self, sock, method: str, target: str,
                  headers: Mapping[str, str], body: bytes) -> bool:
        """Route one request; returns False when the connection must
        close (client asked, or the write failed). Observability
        envelope (docs/observability.md): optional ROOT trace segment
        for the query path (inbound context adopted when well-formed —
        a malformed/oversized header falls back to fresh local ids,
        never a 500), SLO outcome recording, and the access log with
        the routing metadata (replica, attempts, hedge/retry flags)."""
        t_start = time.perf_counter()
        path, _, query = target.partition("?")
        request_id = resolve_request_id(headers)
        params = ({k: v[0] for k, v in parse_qs(query).items()}
                  if query else {})
        status = 500
        # O(1) on the raw request path: one dict hit against the
        # precompiled engine route table (bare /queries.json and every
        # /engines/<name>/queries.json — fleet/gateway.py)
        routed = method == "POST" \
            and self.service.gateway.is_query_path(path)
        engine: str | None = None
        trace = None
        if routed and self.service.tracing:
            inbound_id, inbound_parent = parse_trace_context(headers)
            trace = start_trace(
                "queries.json", request_id=request_id,
                trace_id=inbound_id, parent_span_id=inbound_parent,
                service="router")
        log_extra: dict = {}
        try:
            if trace is not None:
                with use_trace(trace):
                    result = self.service.handle(
                        method, path, params, headers, body, request_id)
            else:
                result = self.service.handle(
                    method, path, params, headers, body, request_id)
            if isinstance(result, RouterResponse):
                status = result.status
                engine = result.engine
                if routed:
                    log_extra = {
                        **({"engine": result.engine}
                           if result.engine else {}),
                        **({"replica": result.backend_id}
                           if result.backend_id else {}),
                        **({"group": result.group}
                           if result.group else {}),
                        "attempts": result.attempts,
                        "retried": result.retried,
                        "hedged": result.hedged,
                    }
                if trace is not None:
                    # the router's trace id wins the response header:
                    # it equals the replica's when the replica adopted
                    # the forwarded context, and it is the only id a
                    # client can stitch by when the replica traced
                    # nothing
                    result.headers = {
                        k: v for k, v in result.headers.items()
                        if k.lower() != "x-pio-trace-id"}
                    result.headers[TRACE_ID_HEADER] = trace.trace_id
                ok = self._send(sock, status, result.body,
                                result.content_type, result.headers,
                                request_id)
            else:
                status, payload, *extra = result
                if isinstance(payload, PlainTextPayload):
                    data = str(payload).encode()
                    ctype = payload.content_type
                else:
                    data = json.dumps(payload).encode()
                    ctype = "application/json; charset=UTF-8"
                ok = self._send(sock, status, data, ctype,
                                extra[0] if extra else None, request_id)
        finally:
            dt = time.perf_counter() - t_start
            self.service.request_latency.observe(
                "queries" if routed
                else self._ROUTE_LABELS.get(path, "other"), dt)
            if routed and status != 429:
                # SLO truth at the router = what the CLIENT saw: any
                # 5xx (shed, expired, all-replicas-failed included)
                # spends error budget — globally AND on the resolved
                # engine's own ring (the per-tenant burn gauges).
                # Quota 429s are EXCLUDED from both rings: a throttled
                # request is the per-tenant contract working, not
                # service failure — and recording it as a microsecond
                # "success" would flatter a tenant's latency SLO
                # exactly when it is both throttled and slow (the same
                # reason the gateway bench keeps 429s out of its
                # latency percentiles); the throttle volume has its own
                # signal, pio_router_quota_throttled_total{engine}
                self.service.slo.record(ok=status < 500, latency_s=dt)
                self.service.gateway.record_outcome(
                    engine, ok=status < 500, latency_s=dt)
                if engine:
                    # same outcome feeds the experiment plane: the
                    # controller ignores engines that are not variants
                    # of a live experiment (experiment/controller.py)
                    self.service.experiment.record(
                        engine, ok=status < 500, latency_s=dt)
            if trace is not None:
                trace.finish(status=status, **{
                    k: v for k, v in log_extra.items() if v or k == "attempts"})
                self.service.trace_log.record(trace)
            if self.service.access_log:
                emit_access_log(
                    "router", method, path, status, dt, request_id,
                    client=self.client_address[0], **log_extra)
        return ok and headers.get("connection", "").lower() != "close"

    def _send(self, sock, status: int, body: bytes, ctype: str,
              extra_headers: Mapping[str, str] | None,
              request_id: str | None) -> bool:
        reason = _REASONS.get(status, "Unknown")
        lines = [f"HTTP/1.1 {status} {reason}",
                 f"Content-Type: {ctype}",
                 f"Content-Length: {len(body)}"]
        if request_id:
            lines.append(f"{REQUEST_ID_HEADER}: {request_id}")
        for k, v in (extra_headers or {}).items():
            lines.append(f"{k}: {v}")
        blob = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body
        try:
            sock.sendall(blob)
            return True
        except OSError:
            return False


class RouterServer(RestServer):
    """HTTP lifecycle around :class:`RouterService` — starts every
    engine group's membership probe loop with the listener, stops them
    all on shutdown. ``router`` (when passed explicitly) becomes the
    DEFAULT engine's FleetRouter; ``config.engines`` declares the rest
    of the table (fleet/gateway.py)."""

    log_label = "Fleet Router"
    thread_name = "pio-routerserver"

    def __init__(self, config: RouterConfig,
                 router: FleetRouter | None = None):
        self.config = config
        self.gateway = EngineGateway(config, default_router=router)
        super().__init__(_Handler, RouterService(self.gateway),
                         config.ip, config.port,
                         reuse_port=config.reuse_port)
        self.service.on_stop = self.stop

    @property
    def router(self) -> FleetRouter:
        """The CURRENT default engine's router (see
        RouterService.router)."""
        return self.gateway.default_group.router

    def start(self) -> "RouterServer":
        self.gateway.start()
        return super().start()

    def _on_close(self) -> None:
        self.service.close()
        self.gateway.close()
