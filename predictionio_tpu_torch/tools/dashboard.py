"""Evaluation dashboard on :9000 (a copy of the JAX package's ``tools/dashboard.py``).

Parity: tools/src/main/scala/.../tools/dashboard/Dashboard.scala:40-160 —
lists completed EvaluationInstances newest-first and serves each
instance's evaluator results as text, HTML, or JSON:

- ``GET /``                                        HTML index of completed
                                                   evaluation instances
- ``GET /engine_instances/{id}/evaluator_results.txt``
- ``GET /engine_instances/{id}/evaluator_results.html``
- ``GET /engine_instances/{id}/evaluator_results.json``

(the reference's path segment is "engine_instances" even though the data
is EvaluationInstances — kept for URL parity, Dashboard.scala:101-141).

CORS: every response carries ``Access-Control-Allow-Origin: *`` and an
``OPTIONS`` preflight for a routed resource answers with the allowed
methods, header whitelist, and a 20-day max-age — parity with the
``CORSSupport`` trait the reference mixes into the dashboard
(tools/.../dashboard/CorsSupport.scala:31-77, wired at
Dashboard.scala:89).
"""

from __future__ import annotations

import html
import json
import logging
import re
import time
from http.server import BaseHTTPRequestHandler

from predictionio_tpu_torch.api.http_base import (
    REQUEST_ID_HEADER,
    RestServer,
    access_log_enabled,
    emit_access_log,
    ensure_access_log_handler,
    resolve_request_id,
)
from predictionio_tpu_torch.obs.exporter import CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE
from predictionio_tpu_torch.obs.exporter import render_prometheus
from predictionio_tpu_torch.obs.registry import (
    HistogramFamily,
    MetricRegistry,
    resilience_collector,
    server_info_collector,
)
from predictionio_tpu_torch.storage.registry import Storage

logger = logging.getLogger(__name__)

_RESULTS_RE = re.compile(
    r"^/engine_instances/([^/]+)/evaluator_results\.(txt|html|json)$"
)

# CorsSupport.scala:33-45 — the origin header goes on every response;
# the remaining two only on OPTIONS preflights.
_CORS_ORIGIN = ("Access-Control-Allow-Origin", "*")
_CORS_PREFLIGHT = (
    ("Access-Control-Allow-Headers",
     "Origin, X-Requested-With, Content-Type, Accept, Accept-Encoding, "
     "Accept-Language, Host, Referer, User-Agent"),
    ("Access-Control-Max-Age", "1728000"),
)


class DashboardService:
    def __init__(self, storage: Storage | None = None,
                 access_log: bool | None = None):
        self.storage = storage or Storage.default()
        # observability plane (docs/observability.md): the dashboard
        # exposes its own scrape point — request latency + the
        # process-global resilience counters — and the shared
        # structured-access-log/request-id contract
        self.access_log = access_log_enabled(access_log)
        if self.access_log:
            ensure_access_log_handler()
        self.request_latency = HistogramFamily(
            "pio_http_request_seconds",
            "HTTP request walltime by route (handler-measured)",
            "route", ("index", "results", "metrics"))
        self.registry = MetricRegistry()
        self.registry.register(self.request_latency.collect)
        self.registry.register(resilience_collector())
        self.registry.register(server_info_collector("dashboard"))

    def route_label(self, path: str) -> str:
        if path == "/":
            return "index"
        if path == "/metrics":
            return "metrics"
        if _RESULTS_RE.match(path):
            return "results"
        return "other"

    def handle(self, method: str, path: str) -> tuple[int, str, str]:
        """Returns (status, content_type, body)."""
        if method != "GET":
            return (405, "application/json", json.dumps({"message": "GET only"}))
        if path == "/":
            return (200, "text/html; charset=UTF-8", self.index_html())
        if path == "/metrics":
            return (200, PROMETHEUS_CONTENT_TYPE,
                    render_prometheus(self.registry))
        m = _RESULTS_RE.match(path)
        if m:
            instance_id, fmt = m.groups()
            instance = self.storage.get_meta_data_evaluation_instances().get(instance_id)
            if instance is None or instance.status != "EVALCOMPLETED":
                return (404, "application/json",
                        json.dumps({"message": f"instance {instance_id} not found"}))
            if fmt == "txt":
                return (200, "text/plain; charset=UTF-8", instance.evaluator_results)
            if fmt == "html":
                return (200, "text/html; charset=UTF-8", instance.evaluator_results_html)
            return (200, "application/json", instance.evaluator_results_json or "{}")
        return (404, "application/json", json.dumps({"message": f"no route for {path}"}))

    def index_html(self) -> str:
        """The dashboard index (Dashboard.scala:93-100 + twirl template)."""
        rows = []
        for inst in self.storage.get_meta_data_evaluation_instances().get_completed():
            rows.append(
                "<tr><td>{id}</td><td>{start}</td><td>{cls}</td><td>{oneliner}</td>"
                "<td><a href='/engine_instances/{id}/evaluator_results.txt'>txt</a> "
                "<a href='/engine_instances/{id}/evaluator_results.html'>HTML</a> "
                "<a href='/engine_instances/{id}/evaluator_results.json'>JSON</a>"
                "</td></tr>".format(
                    id=html.escape(inst.id),
                    start=html.escape(inst.start_time.isoformat()),
                    cls=html.escape(inst.evaluation_class),
                    oneliner=html.escape(inst.evaluator_results[:200]),
                )
            )
        return (
            "<html><head><title>predictionio_tpu dashboard</title></head><body>"
            "<h1>Completed Evaluations</h1>"
            "<table border=1><tr><th>ID</th><th>Started</th><th>Evaluation</th>"
            "<th>Result</th><th>Details</th></tr>"
            + "".join(rows)
            + "</table></body></html>"
        )


class _Handler(BaseHTTPRequestHandler):
    service: DashboardService

    def do_GET(self) -> None:  # noqa: N802
        t_start = time.perf_counter()
        path = self.path.split("?")[0]
        request_id = resolve_request_id(self.headers)
        status, ctype, body = self.service.handle("GET", path)
        data = body.encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.send_header(REQUEST_ID_HEADER, request_id)
        self.send_header(*_CORS_ORIGIN)
        self.end_headers()
        self.wfile.write(data)
        dt = time.perf_counter() - t_start
        self.service.request_latency.observe(
            self.service.route_label(path), dt)
        if self.service.access_log:
            emit_access_log("dashboard", "GET", path, status, dt,
                            request_id, client=self.address_string())

    def do_OPTIONS(self) -> None:  # noqa: N802
        """CORS preflight (CorsSupport.scala:48-63): a routed path answers
        with the methods it supports; unknown paths still 404."""
        path = self.path.split("?")[0]
        known = (path == "/" or path == "/metrics"
                 or _RESULTS_RE.match(path) is not None)
        self.send_response(200 if known else 404)
        self.send_header("Access-Control-Allow-Methods", "OPTIONS, GET")
        self.send_header(*_CORS_ORIGIN)
        for header in _CORS_PREFLIGHT:
            self.send_header(*header)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, format: str, *args) -> None:
        logger.debug("%s - %s", self.address_string(), format % args)


class Dashboard(RestServer):
    """Parity: Dashboard.createDashboard (Dashboard.scala:60-91)."""

    log_label = "Dashboard"
    thread_name = "pio-dashboard"

    def __init__(self, storage: Storage | None = None, ip: str = "0.0.0.0",
                 port: int = 9000, access_log: bool | None = None):
        super().__init__(_Handler, DashboardService(storage, access_log),
                         ip, port)
