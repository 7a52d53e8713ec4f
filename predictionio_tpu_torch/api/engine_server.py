"""Engine server: the REST face of a deployed engine (port of the JAX
package's ``api/engine_server.py``: ``EngineService``, the transport-free
request logic, under ``EngineServer``, its HTTP lifecycle).

Routes:

- ``POST /queries.json``: bind the JSON body to the engine's query class
  → the canonical key → a result-cache lookup → the micro-batcher, or
  the deadline pool, or a direct ``DeployedEngine.query`` → output
  blockers (a raising blocker answers 403) and sniffers → camelCase JSON
  → the experiment attribution headers echoed; a blown deadline or
  unavailable storage answers 503 with ``Retry-After``;
- ``GET /``: status: the engine instance, request bookkeeping, the
  batcher's counters and policy, and the flash-attention kernel's launch
  count in this process (``kernelLaunches``);
- ``GET /healthz``; ``GET /readyz`` (a deployed model and reachable
  storage; 503 "reloading" during a ``/reload``);
- ``GET /stats.json``: the batch-size histogram, the queue-wait and
  device-dispatch histograms, the cache counters, resilience counters,
  and the build sentinel's ``compile`` block (``obs/compile.py``);
- ``GET /metrics``: Prometheus text of the server's registry (serving,
  resilience, server info, SLO burn rates and pressure, ANN mode, builds,
  device memory, the last profiled train; the online plane's families
  with ``--online``);
- ``GET /traces.json``: the recent query traces (``obs/trace.py``) when
  tracing is on (``ServerConfig.tracing``, else ``PIO_TRACE``): spans
  ``parse → bind → codec_key → cache_lookup → (batcher.queue_wait,
  batcher.device_dispatch | predict) → encode`` (and ``feedback``);
  traced responses carry ``X-PIO-Trace-Id``, and an inbound
  ``X-PIO-Trace-Id``/``X-PIO-Parent-Span`` pair is adopted;
- ``GET /plugins.json``;
- ``GET|POST /reload``: swap to the latest COMPLETED instance, then
  invalidate the cache and advance the model generation that fences the
  online overlay; a failed reload keeps serving the last-known-good
  instance (503);
- ``POST /retrieval``: ``{"retrieval": "ann"|"brute"[, "annNprobe",
  "annRescore", "annNlist"]}`` switches retrieval at run time (409 when
  a model has no index to switch to) and invalidates the cache;
- ``POST /drain``: latch ``/readyz`` to 503 "draining" (``{"action":
  "undrain"}`` clears it); queries in flight, and new ones, still answer;
- ``POST /stop``. It, ``/reload``, ``/retrieval`` and ``/drain`` need
  ``?accessKey=<server_key>`` when ``ServerConfig.server_key`` is set.

The prefork pool (``pio deploy --workers N``): N processes of this server
share one ``SO_REUSEPORT`` port, each with its own CUDA context, model
replica, batcher, cache and registry. With ``ServerConfig.
worker_spool_dir`` set, a worker joins the pool's spool
(``fleet/workers.WorkerHub``): a ``/metrics``, ``/stats.json`` or
``/traces.json`` landing on any worker folds every live sibling in
(``obs/aggregate.merge_sources``: counters summed, histograms merged,
gauges such as ``pio_device_bytes_in_use`` labelled ``worker="<id>"``;
``pio_serving_workers`` = the workers folded), and ``/reload``,
``/drain`` and ``POST /retrieval`` publish a sequenced admin state that
every sibling applies (``serving/workers.WorkerCoherence``), so a reload
moves every worker's cache to the same generation. With
``ServerConfig.shm_cache`` the pool's result cache is one shared-memory
segment (``serving/shm_cache.py``): a query answered by one worker is a
hit for its siblings. The online plane folds in one worker (the tail
lease) and the siblings apply its published overlay. The access log
carries a ``worker`` field.

With ``ServerConfig.online`` an ``online/service.OnlineFoldIn`` folds new
events into the deployed ALS model between retrains; each folded user's
result-cache entries are invalidated, and ``/stats.json`` carries an
``online`` section. The ALS models report their ANN queries into
``/stats.json`` (``annQueries``, ``annShortlistHistogram``).

Port-specific decisions:

- **Unbatched mode answers one query at a time** (a lock around
  ``DeployedEngine.query``), where the JAX server answers concurrently:
  one device, and a kernel launch count that must add up. Under a
  deadline the query waits for the lock on a pool thread; one whose
  budget ran out while it waited is not run (counted as ``expired``).
- **Batched mode: the batcher's dispatcher thread is the only caller of
  the device.**
- **A failed batch is retried query by query**, as in the JAX package,
  and each retry is counted under ``resilience["serving/query-batcher"]
  ["fallbacks"]`` in ``/stats.json``; ``chip_smoke.py`` fails on any, so
  a kernel failing at B > 1 cannot hide behind B = 1 retries.
- ``GET /`` is JSON only (no HTML page).

With ``ServerConfig.feedback`` every answer carries a ``prId`` (the
query's own, else a new one) and the (query, prediction) pair is posted
to the event server as a ``predict`` event of entity ``pio_pr``, on a
daemon thread, with the query's trace headers; a failed post is logged
and never reaches the query.

The first answered query marks serving warmup on the build sentinel: a
kernel or native library built after it counts in
``pio_serving_recompile_total``.

The server deploys a stored engine instance (``pio deploy``,
``workflow/deploy.load_deployed_engine``) or a model directory: ``python
-m predictionio_tpu_torch.api.engine_server --model-dir D --port P
[--device cpu] [--engine-factory F]`` (default: the sessionrec
template).
"""

from __future__ import annotations

import abc
import argparse
import contextlib
import contextvars
import dataclasses
import json
import logging
import queue
import threading
import time
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler
from typing import Any, Mapping
from urllib.parse import parse_qs, urlparse

from predictionio_tpu_torch.api.http_base import (
    REQUEST_ID_HEADER,
    PlainTextPayload,
    RestServer,
    access_log_enabled,
    bounded_probe,
    emit_access_log,
    ensure_access_log_handler,
    parse_deadline_budget,
    resolve_request_id,
    retry_after_header,
    serve_until_stopped,
    undeploy,
)
from predictionio_tpu_torch.api.stats import ServingStats, resilience_snapshot
from predictionio_tpu_torch.core.json_codec import (
    canonical_json,
    compile_wire_decoder,
    encode_wire,
)
from predictionio_tpu_torch.obs import compile as build_obs
from predictionio_tpu_torch.obs.aggregate import (
    ExpositionParseError,
    merge_sources,
    parse_exposition,
    source_count_metric,
)
from predictionio_tpu_torch.obs.device import device_memory_collector, train_report_collector
from predictionio_tpu_torch.obs.exporter import CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE
from predictionio_tpu_torch.obs.exporter import render_metrics
from predictionio_tpu_torch.obs.registry import (
    HistogramFamily,
    Metric,
    MetricRegistry,
    online_collector,
    resilience_collector,
    server_info_collector,
    serving_collector,
)
from predictionio_tpu_torch.obs.slo import SLOEngine, serving_pressure_collector
from predictionio_tpu_torch.obs.trace import (
    PARENT_SPAN_HEADER,
    TRACE_ID_HEADER,
    TraceLog,
    active_trace,
    parse_trace_context,
    span,
    start_trace,
    tracing_default,
    use_trace,
)
from predictionio_tpu_torch.ops import flash_attention as flash_ops
from predictionio_tpu_torch.serving.batch_policy import make_batch_policy
from predictionio_tpu_torch.serving.batcher import QueryBatcher, QueryDeadlineExceeded
from predictionio_tpu_torch.serving.result_cache import ResultCache
from predictionio_tpu_torch.serving.workers import WorkerCoherence
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.resilience import (
    STORAGE_UNAVAILABLE_ERRORS,
    deadline_scope,
    record_fallback,
    retry_after_hint,
)
from predictionio_tpu_torch.utils.ssl_config import client_transport
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.deploy import (
    DEFAULT_ENGINE_FACTORY,
    DeployedEngine,
    ServerConfig,
    apply_retrieval_config,
    load_deployed_engine,
    retrieval_targets,
)

logger = logging.getLogger(__name__)

OUTPUT_BLOCKER = "outputblocker"
OUTPUT_SNIFFER = "outputsniffer"


@dataclasses.dataclass(frozen=True)
class QueryInfo:
    """What engine-server plugins observe per query."""
    query: Any
    prediction: Any
    engine_instance_id: str


class EngineServerPlugin(abc.ABC):
    """Output blockers run synchronously and may transform (or reject, by
    raising) the prediction; sniffers observe on a worker thread."""

    plugin_name: str = "plugin"
    plugin_description: str = ""
    plugin_type: str = OUTPUT_SNIFFER

    @abc.abstractmethod
    def process(self, info: QueryInfo, context: "EngineServerPluginContext") -> Any:
        """Blockers return the (possibly transformed) prediction."""


class EngineServerPluginContext:
    """The plugins of one server; sniffer notifications drain on one
    daemon thread, off the serving path."""

    def __init__(self, plugins: list[EngineServerPlugin] | None = None):
        plugins = list(plugins or [])
        self.output_blockers = {
            p.plugin_name: p for p in plugins if p.plugin_type == OUTPUT_BLOCKER}
        self.output_sniffers = {
            p.plugin_name: p for p in plugins if p.plugin_type == OUTPUT_SNIFFER}
        self._queue: queue.Queue[QueryInfo | None] = queue.Queue()
        self._worker: threading.Thread | None = None
        if self.output_sniffers:
            self._worker = threading.Thread(target=self._drain, name="pio-output-sniffers",
                                            daemon=True)
            self._worker.start()

    def run_blockers(self, info: QueryInfo) -> Any:
        """Fold the prediction through every blocker. An exception
        propagates and rejects the query."""
        prediction = info.prediction
        for blocker in self.output_blockers.values():
            prediction = blocker.process(dataclasses.replace(info, prediction=prediction), self)
        return prediction

    def notify_sniffers(self, info: QueryInfo) -> None:
        if self._worker is not None:
            self._queue.put(info)

    def _drain(self) -> None:
        while True:
            info = self._queue.get()
            if info is None:
                return
            for sniffer in self.output_sniffers.values():
                try:
                    sniffer.process(info, self)
                except Exception:
                    logger.exception("output sniffer %s failed", sniffer.plugin_name)

    def close(self) -> None:
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout=5)
            self._worker = None

    def describe(self) -> dict:
        def block(plugins: dict[str, EngineServerPlugin]) -> dict:
            return {name: {"name": p.plugin_name, "description": p.plugin_description,
                           "class": type(p).__qualname__}
                    for name, p in plugins.items()}

        return {"plugins": {"outputblockers": block(self.output_blockers),
                            "outputsniffers": block(self.output_sniffers)}}


_NO_INDEX = ("no persisted ANN index on the deployed model: build it at train/persist "
             "time (PIO_SERVING_ANN_BUILD) or deploy with --retrieval ann; the runtime "
             "switch only flips between ready modes")


class _Reject(Exception):
    def __init__(self, status: int, message: str, headers: dict[str, str] | None = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers


class EngineService:
    """Transport-free request logic: ``handle`` returns ``(status,
    payload)`` or ``(status, payload, headers)``."""

    def __init__(
        self,
        deployed: DeployedEngine,
        config: ServerConfig | None = None,
        storage: Storage | None = None,
        ctx: EngineContext | None = None,
        plugin_context: EngineServerPluginContext | None = None,
    ):
        config = config if config is not None else ServerConfig()
        self.deployed = deployed
        self.config = config
        self.storage = storage
        self.ctx = ctx
        self.plugins = plugin_context or EngineServerPluginContext()
        #: set by the HTTP wrapper: called on an authorized POST /stop,
        #: and the count of clients gone mid-request
        self.on_stop = lambda: None
        self.client_disconnects = lambda: 0
        #: one counter set shared by the batcher and the cache
        self.serving_stats = ServingStats()
        #: the result cache: with ``shm_cache`` one segment the pool
        #: shares (where shared memory fails: a warning and a private one)
        self.cache = None
        if config.cache_enabled:
            if config.shm_cache:
                from predictionio_tpu_torch.serving.shm_cache import open_shm_cache

                self.cache = open_shm_cache(config, stats=self.serving_stats)
                if self.cache is not None:
                    # the pool-reload put fence: between a sibling's
                    # /reload bump and this worker's own model swap, a
                    # local result is an old-model one and must not land
                    # in the new generation
                    self.cache.model_generation_fn = lambda: self.model_generation
            if self.cache is None:
                self.cache = ResultCache(max_entries=config.cache_max_entries,
                                         ttl_s=config.cache_ttl_s, stats=self.serving_stats)
        self.batcher = (QueryBatcher(lambda: self.deployed,
                                     policy=make_batch_policy(config.batch_policy,
                                                              config.batch_max,
                                                              config.batch_wait_ms),
                                     stats=self.serving_stats)
                        if config.batching else None)
        self._query_decoder = self._decoder_for(deployed)
        self.access_log = access_log_enabled()
        if self.access_log:
            ensure_access_log_handler()
        #: per-request tracing (config wins, else PIO_TRACE) and the
        #: per-server registry GET /metrics renders
        self.tracing = config.tracing if config.tracing is not None else tracing_default()
        self.trace_log = TraceLog()
        self.request_latency = HistogramFamily(
            "pio_http_request_seconds",
            "HTTP request walltime by route (handler-measured)",
            "route", ("queries", "stats", "metrics", "status"))
        self.registry = MetricRegistry()
        self.registry.register(self.request_latency.collect)
        self.registry.register(serving_collector(self.serving_stats))
        self.registry.register(resilience_collector())
        self.registry.register(server_info_collector("engine"))
        #: SLO burn rates (outcomes recorded per query by the handler)
        #: and the queue-pressure signal, evaluated at scrape time only
        self.slo = SLOEngine()
        self.registry.register(self.slo.collector())
        self.registry.register(serving_pressure_collector(self.serving_stats))
        self.registry.register(self._ann_mode_collector)
        #: builds (obs/compile.py), device memory (read only once this
        #: process has initialized CUDA) and the last profiled train
        self.registry.register(build_obs.compile_metrics_collector())
        self.registry.register(device_memory_collector())
        self.registry.register(train_report_collector())
        self._compile_warmup_marked = False
        #: unbatched mode: one query on the device at a time
        self._predict_lock = threading.Lock()
        #: unbatched mode under a deadline: the query waits for the lock
        #: on a pool thread, so a blown budget answers 503 at once
        self._query_pool = ThreadPoolExecutor(max_workers=64,
                                              thread_name_prefix="pio-query-deadline")
        #: /reload in flight: /readyz answers 503 "reloading" meanwhile
        self._reload_lock = threading.Lock()
        self._reloads_in_flight = 0
        #: the drain latch (POST /drain): /readyz answers 503 "draining"
        #: while it holds; guarded by _reload_lock
        self._draining = False
        #: ANN-capable models count their queries into serving_stats;
        #: re-wired on every /reload, which brings new model objects
        self._wire_ann_observers()
        #: the base model's generation, advanced by every successful
        #: /reload (to the pool's shared reload sequence in a pool): a
        #: fold computed against generation G is discarded once G+1
        #: serves (online/overlay.py)
        self.model_generation = 0
        #: the pool's peering and shared admin state (module docstring)
        self.worker_hub = None
        self.coherence: WorkerCoherence | None = None
        if config.worker_spool_dir:
            from predictionio_tpu_torch.fleet.workers import WorkerHub

            self.worker_hub = WorkerHub(
                config.worker_spool_dir,
                metrics_text=lambda: render_metrics(self.registry.collect()),
                traces_snapshot=self.trace_log.snapshot,
                timeout_s=config.worker_peer_timeout_s,
                # this worker's LOCAL documents for the siblings' fan-out
                # (a callback that fanned out itself would recurse), and
                # its status, whose kernel launch count a card check
                # reads worker by worker
                extra_paths={"/stats.json": lambda: self.stats_doc(include_workers=False),
                             "/": self.status_doc})
            self.coherence = WorkerCoherence(self.worker_hub, on_state=self._on_admin_state,
                                             interval_s=config.admin_sync_interval_s)
            adopted = self.coherence.adopt()
            # a (re)spawned worker loaded the latest completed instance
            # already, so reloadSeq is history (the empty cache aligns
            # its generation with the pool's); the drain latch and the
            # retrieval config apply for real
            if self.cache is not None and adopted["reloadSeq"] > 0:
                self.cache.invalidate(generation=adopted["reloadSeq"])
            self.model_generation = adopted["reloadSeq"]
            if adopted["draining"]:
                with self._reload_lock:
                    self._draining = True
            if adopted["retrieval"]:
                # an unappliable adopted document must not abort the
                # start: under --supervise that would respawn into the
                # same document until the crash-loop latch shrank the pool
                try:
                    self._apply_retrieval_doc(adopted["retrieval"])
                except Exception:
                    logger.exception("adopted retrieval config %s failed to apply; "
                                     "serving %s retrieval", adopted["retrieval"],
                                     self.config.retrieval)
            self.coherence.start()
        self.online = None
        if config.online:
            from predictionio_tpu_torch.online.service import OnlineFoldIn

            self.online = OnlineFoldIn(
                storage=storage,
                deployed_fn=lambda: self.deployed,
                generation_fn=lambda: self.model_generation,
                interval_s=config.online_interval_s,
                overlay_max=config.online_overlay_max,
                state_dir=config.online_state_dir or None,
                invalidate_user=self._invalidate_user_results,
                trace_log=self.trace_log,
                tracing=self.tracing,
                worker_hub=self.worker_hub)
            self.registry.register(online_collector(self.online))
            self.online.start()

    def _invalidate_user_results(self, user_id: str) -> None:
        """Drop one user's result-cache entries after their vector was
        folded; every other user's entries stay warm."""
        if self.cache is not None:
            from predictionio_tpu_torch.online.service import user_key_fragment

            self.cache.invalidate_matching(user_key_fragment(user_id))

    # -- the worker pool -----------------------------------------------------
    @property
    def worker_id(self) -> str | None:
        """This worker's spool identity (None outside a pool), stamped
        into access-log lines."""
        return self.worker_hub.worker_id if self.worker_hub else None

    def _publish_admin(self, applied_note: str, **changes) -> None:
        """Publish admin ``changes`` to the pool and check that they
        committed: ``WorkerCoherence.publish`` swallows spool I/O errors,
        and a 200 while the siblings stay on the old state would break
        the coherence contract. The local change stands either way; the
        500 says the pool is split, and a retry (every admin change is
        idempotent) heals it."""
        if self.coherence is None:
            return
        published = self.coherence.publish(**changes)
        for key, value in changes.items():
            if published.get(key) != value:
                raise _Reject(500, f"{applied_note}, but publishing to the worker pool "
                                   "failed; sibling workers are unchanged — check the "
                                   "spool directory and retry")

    def _on_admin_state(self, new: dict, prev: dict) -> None:
        """The coherence callback: perform what changed between two
        cumulative admin states. A sibling's /reload becomes a local
        reload that adopts the shared sequence as the cache generation; a
        failed local reload keeps the last-known-good model, as a direct
        /reload would."""
        if new["draining"] != prev["draining"]:
            with self._reload_lock:
                self._draining = new["draining"]
            logger.info("adopted sibling drain latch: %s",
                        "set" if new["draining"] else "cleared")
        # reload BEFORE retrieval: one document can carry both, and the
        # retrieval mode may need the new model's index
        if new["reloadSeq"] > prev["reloadSeq"]:
            try:
                self.reload(generation=new["reloadSeq"])
                logger.info("adopted sibling reload (seq %d): now serving %s",
                            new["reloadSeq"], self.deployed.instance_id)
            except Exception:
                record_fallback("serving/reload")
                logger.exception("sibling-triggered reload failed; still serving "
                                 "instance %s", self.deployed.instance_id)
        if new["retrieval"] != prev["retrieval"] and new["retrieval"]:
            # a failed apply must not abort the rest of this document:
            # its sequence has already advanced
            try:
                self._apply_retrieval_doc(new["retrieval"])
                logger.info("adopted sibling retrieval config: %s", new["retrieval"])
            except Exception:
                logger.exception("sibling retrieval config %s failed to apply; still "
                                 "serving %s retrieval", new["retrieval"],
                                 self.config.retrieval)

    # -- retrieval (ops/ann) -------------------------------------------------
    def _wire_ann_observers(self) -> None:
        for target in retrieval_targets(getattr(self.deployed, "models", ())):
            if hasattr(target, "set_ann_observer"):
                target.set_ann_observer(self.serving_stats.record_ann)

    def _missing_index_targets(self) -> list:
        """ANN-capable models without a ready index: a run-time switch
        would run a full k-means on the request thread, so it is refused."""
        return [t for t in retrieval_targets(getattr(self.deployed, "models", ()))
                if getattr(t, "ann_index", None) is None]

    def _apply_retrieval_doc(self, doc: Mapping[str, Any]) -> None:
        """Push a retrieval reconfiguration onto every ANN-capable model,
        re-wire the observers, invalidate the cache (the two modes may
        rank one query differently) and only then commit the new config."""
        mode = str(doc.get("retrieval", self.config.retrieval))
        if mode not in ("brute", "ann"):
            raise ValueError(f"invalid retrieval mode {mode!r}")

        def _int(key: str, current: int) -> int:
            value = doc.get(key, current)
            if not isinstance(value, int) or value < 0:
                raise ValueError(f"invalid {key}: {value!r}")
            return value

        if mode == "ann" and self._missing_index_targets():
            raise ValueError(_NO_INDEX)
        candidate = dataclasses.replace(
            self.config, retrieval=mode,
            ann_nprobe=_int("annNprobe", self.config.ann_nprobe),
            ann_rescore=_int("annRescore", self.config.ann_rescore),
            ann_nlist=_int("annNlist", self.config.ann_nlist))
        apply_retrieval_config(getattr(self.deployed, "models", ()), candidate)
        self._wire_ann_observers()
        if self.cache is not None:
            self.cache.invalidate()
        self.config = candidate

    def retrieval_admin(self, body: Any) -> tuple:
        """POST /retrieval."""
        if not isinstance(body, dict) or "retrieval" not in body:
            raise _Reject(400, 'expected {"retrieval": "ann"|"brute", ...}')
        if body.get("retrieval") == "ann" and self._missing_index_targets():
            raise _Reject(409, _NO_INDEX)
        try:
            self._apply_retrieval_doc(body)
        except ValueError as exc:
            raise _Reject(400, str(exc))
        self._publish_admin("retrieval applied on this worker", retrieval={
            "retrieval": self.config.retrieval,
            "annNprobe": self.config.ann_nprobe,
            "annRescore": self.config.ann_rescore,
            "annNlist": self.config.ann_nlist,
        })
        logger.info("retrieval reconfigured: %s (nprobe=%d rescore=%d)",
                    self.config.retrieval, self.config.ann_nprobe, self.config.ann_rescore)
        return (200, {"retrieval": self.config.retrieval, "annEnabled": self.ann_enabled()})

    def ann_enabled(self) -> bool:
        """True when a deployed model answers through its ANN index."""
        return any(getattr(t, "ann_enabled", False)
                   for t in retrieval_targets(getattr(self.deployed, "models", ())))

    def _ann_mode_collector(self) -> list:
        return [Metric(
            name="pio_serving_ann_enabled", kind="gauge",
            help="1 when queries are served through the ANN MIPS index, "
                 "0 for brute-force retrieval",
            samples=[({}, 1.0 if self.ann_enabled() else 0.0)],
        )]

    @staticmethod
    def _decoder_for(deployed: DeployedEngine):
        qc = deployed.query_class
        return compile_wire_decoder(qc) if qc is not None else None

    def close(self) -> None:
        # the fold thread and the admin sync first: both call into the
        # cache, whose shared segment must not be released under them
        if self.online is not None:
            self.online.close()
        if self.coherence is not None:
            self.coherence.close()
        if self.worker_hub is not None:
            self.worker_hub.close()
        # a shm cache detaches (and unlinks only a segment it created: a
        # pool's segment belongs to the deploy command)
        cache_close = getattr(self.cache, "close", None)
        if cache_close is not None:
            cache_close()
        if self.batcher is not None:
            self.batcher.close()
        self._query_pool.shutdown(wait=False)
        self.plugins.close()

    def _check_server_key(self, params: Mapping[str, str]) -> None:
        if self.config.server_key is None:
            return
        if params.get("accessKey") != self.config.server_key:
            raise _Reject(401, "invalid accessKey")

    def handle(self, method: str, path: str, params: Mapping[str, str],
               headers: Mapping[str, str], body: Any) -> tuple:
        try:
            if method == "GET" and path == "/":
                return (200, self.status_doc())
            if method == "POST" and path == "/queries.json":
                return self.handle_query(body, headers)
            if method == "GET" and path == "/plugins.json":
                return (200, self.plugins.describe())
            if method == "GET" and path == "/stats.json":
                return (200, self.stats_doc())
            if method == "GET" and path == "/metrics":
                return (200, PlainTextPayload(self.metrics_text(), PROMETHEUS_CONTENT_TYPE))
            if method == "GET" and path == "/traces.json":
                return (200, {"tracing": self.tracing, "traces": self.traces_merged()})
            if method == "GET" and path == "/healthz":
                return (200, {"status": "ok"})
            if method == "GET" and path == "/readyz":
                return self.readyz()
            if path == "/reload" and method in ("GET", "POST"):
                self._check_server_key(params)
                # in a pool the shared reload sequence is the new cache
                # generation of every worker; reload FIRST and publish
                # only on success
                reload_seq = (self.coherence.next_reload_seq()
                              if self.coherence is not None else None)
                try:
                    self.reload(generation=reload_seq)
                except LookupError as e:
                    raise _Reject(404, str(e))
                except Exception as e:
                    # the last-known-good instance stays deployed
                    keep = self.deployed.instance_id
                    logger.exception("reload failed; still serving instance %s", keep)
                    record_fallback("serving/reload")
                    raise _Reject(503, f"reload failed ({e}); still serving instance {keep}",
                                  {"Retry-After": retry_after_header(retry_after_hint(e))})
                self._publish_admin("reloaded on this worker",
                                    **({"reloadSeq": reload_seq}
                                       if reload_seq is not None else {}))
                return (200, {"message": "Reloading"})
            if method == "POST" and path == "/retrieval":
                self._check_server_key(params)
                return self.retrieval_admin(body)
            if method == "POST" and path == "/drain":
                self._check_server_key(params)
                return self.drain(body)
            if method == "POST" and path == "/stop":
                self._check_server_key(params)
                threading.Thread(target=self.on_stop, daemon=True).start()
                return (200, {"message": "Shutting down"})
            return (404, {"message": f"no route for {method} {path}"})
        except _Reject as r:
            if r.headers:
                return (r.status, {"message": r.message}, r.headers)
            return (r.status, {"message": r.message})
        except STORAGE_UNAVAILABLE_ERRORS as e:
            logger.warning("storage unavailable in %s %s: %s", method, path, e)
            return (503, {"message": f"storage unavailable: {e}"},
                    {"Retry-After": retry_after_header(retry_after_hint(e))})
        except Exception as e:
            logger.exception("unhandled error in %s %s", method, path)
            return (500, {"message": f"internal error: {e}"})

    def metrics_text(self) -> str:
        """This worker's exposition, folded with every live sibling's in
        a pool (counters summed, histograms merged bucket-wise, gauges
        labelled ``worker=<id>``), plus ``pio_serving_workers``: the
        workers folded into this scrape."""
        own = self.registry.collect()
        hub = self.worker_hub
        if hub is None:
            return render_metrics(own + [_workers_gauge(1)])
        sources: list[tuple[str, list]] = [(hub.worker_id, own)]
        for worker_id, body in hub.fetch_peer_bodies("/metrics"):
            try:
                sources.append((worker_id, parse_exposition(body.decode())))
            except (ExpositionParseError, UnicodeDecodeError) as exc:
                logger.warning("worker %s exposition unparseable: %s", worker_id, exc)
        merged = merge_sources(sources, source_label="worker")
        merged.append(_workers_gauge(len(sources)))
        return render_metrics(merged)

    def traces_merged(self) -> list:
        """The local trace ring, with every live sibling's folded in
        (tagged ``source: worker:<id>``) in a pool."""
        traces = self.trace_log.snapshot()
        hub = self.worker_hub
        if hub is None:
            return traces
        for worker_id, body in hub.fetch_peer_bodies("/traces.json"):
            try:
                docs = json.loads(body).get("traces", [])
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            for doc in docs:
                doc.setdefault("source", f"worker:{worker_id}")
                traces.append(doc)
        return traces

    def _admin_doc(self) -> dict:
        """This worker's applied admin state: its model generation (the
        pool's reload sequence), the drain latch and the instance it
        serves."""
        with self._reload_lock:
            draining = self._draining
        return {"modelGeneration": self.model_generation, "draining": draining,
                "engineInstanceId": self.deployed.instance_id}

    def _workers_doc(self) -> dict:
        """The /stats.json ``workers`` section: per-worker request counts
        (this worker's live, the siblings' fetched) and the pool's total,
        as in the JAX package, plus (the port's addition) each worker's
        applied admin state under ``admin``, which shows a /reload or
        /drain reaching every worker."""
        hub = self.worker_hub
        per_worker = {hub.worker_id: self.deployed.request_count}
        admin = {hub.worker_id: self._admin_doc()}
        for worker_id, body in hub.fetch_peer_bodies("/stats.json"):
            try:
                doc = json.loads(body)
                per_worker[worker_id] = int(doc.get("requestCount", 0))
            except (json.JSONDecodeError, UnicodeDecodeError, TypeError, ValueError):
                continue
            if isinstance(doc.get("admin"), dict):
                admin[worker_id] = doc["admin"]
        return {
            "worker": hub.worker_id,
            "count": len(per_worker),
            "requestCount": sum(per_worker.values()),
            "perWorker": per_worker,
            "admin": admin,
        }

    _ROUTE_LABELS = {
        "/queries.json": "queries",
        "/stats.json": "stats",
        "/metrics": "metrics",
        "/": "status",
    }

    def observe_request(self, path: str, dt: float, status: int | None = None) -> None:
        """Handler-measured request walltime into the per-route latency
        family (unknown paths fold into ``other``); query outcomes also
        feed the SLO ring (a 5xx, a shed 503 included, spends budget)."""
        self.request_latency.observe(self._ROUTE_LABELS.get(path, "other"), dt)
        if status is not None and path == "/queries.json":
            self.slo.record(ok=status < 500, latency_s=dt)

    def drain(self, body: Any = None) -> tuple:
        """POST /drain: latch /readyz to 503 "draining" so that load
        balancers stop sending this server new work before a planned
        stop; ``{"action": "undrain"}`` clears the latch. In a pool the
        latch reaches every sibling (the workers share one port, so an
        operator cannot address one of them)."""
        undrain = isinstance(body, dict) and body.get("action") == "undrain"
        with self._reload_lock:
            self._draining = not undrain
        self._publish_admin(f"drain latch {'cleared' if undrain else 'set'} on this worker",
                            draining=not undrain)
        logger.info("drain latch %s", "cleared" if undrain else "set")
        return (200, {"status": "ready" if undrain else "draining"})

    def readyz(self) -> tuple:
        """A deployed model and reachable storage; 503 with
        ``Retry-After`` otherwise, while a /reload swaps models, and
        while drained."""
        with self._reload_lock:
            reloading = self._reloads_in_flight > 0
            draining = self._draining
        if draining:
            return (503, {"status": "draining", "model": self.deployed.instance_id},
                    {"Retry-After": retry_after_header(1.0)})
        if reloading:
            return (503, {"status": "reloading", "model": self.deployed.instance_id},
                    {"Retry-After": retry_after_header(1.0)})
        checks = {"model": self.deployed.instance_id}
        ready = True
        if self.storage is not None:
            def probe() -> None:
                with deadline_scope(1.0):
                    self.storage.get_meta_data_engine_instances().get(checks["model"])

            err = bounded_probe(probe, timeout=1.0)
            if err is None:
                checks["storage"] = "ok"
            else:
                checks["storage"] = f"unavailable: {err}"
                ready = False
        else:
            checks["storage"] = "skipped"
        if ready:
            return (200, {"status": "ready", **checks})
        return (503, {"status": "unavailable", **checks},
                {"Retry-After": retry_after_header(1.0)})

    def status_doc(self) -> dict:
        """GET /: the JAX server's status fields, plus the device and the
        flash kernel's launches in this process."""
        d = self.deployed
        inst = d.instance
        return {
            "status": "alive",
            "engineInstanceId": d.instance_id,
            "engineFactory": (inst.engine_factory if inst is not None
                              else self.config.engine_factory),
            "engineVariant": inst.engine_variant if inst is not None else None,
            "startTime": d.start_time,
            "algorithms": [type(a).__name__ for a in d.algorithms],
            "serving": type(d.serving).__name__,
            "device": str(d.device),
            "requestCount": d.request_count,
            "avgServingSec": d.avg_serving_sec,
            "lastServingSec": d.last_serving_sec,
            "clientDisconnects": self.client_disconnects(),
            "kernelLaunches": {"flash_attention": flash_ops.LAUNCHES},
            **({"batching": {
                "batches": self.batcher.batches,
                "batchedQueries": self.batcher.batched_queries,
                "batchWaitMs": self.config.batch_wait_ms,
                **self.batcher.policy.snapshot(),
            }} if self.batcher is not None else {}),
            **({"resilience": snap} if (snap := resilience_snapshot()) else {}),
        }

    def stats_doc(self, include_workers: bool = True) -> dict:
        """GET /stats.json: the serving hot path's counters, each read
        under its own lock. In a pool a ``workers`` section reports the
        pool; ``include_workers=False`` is the local view the siblings
        fetch, which carries this worker's ``admin`` state instead."""
        d = self.deployed
        pool = self.worker_hub is not None
        return {
            **({"workers": self._workers_doc()} if pool and include_workers else {}),
            **({"admin": self._admin_doc()} if pool and not include_workers else {}),
            "engineInstanceId": d.instance_id,
            "requestCount": d.request_count,
            "avgServingSec": d.avg_serving_sec,
            "lastServingSec": d.last_serving_sec,
            "clientDisconnects": self.client_disconnects(),
            "annEnabled": self.ann_enabled(),
            "retrieval": self.config.retrieval,
            # the build sentinel's view: builds, their seconds and the
            # post-warmup ones, per process like the libraries it counts
            "compile": build_obs.stats_doc(),
            "serving": self.serving_stats.snapshot(),
            "batching": ({"enabled": True, **self.batcher.policy.snapshot()}
                         if self.batcher is not None else {"enabled": False}),
            "cache": ({"enabled": True, **self.cache.snapshot()}
                      if self.cache is not None else {"enabled": False}),
            **({"online": self.online.stats_doc()} if self.online is not None else {}),
            **({"resilience": snap} if (snap := resilience_snapshot()) else {}),
        }

    def _deadline_budget(self, headers: Mapping[str, str]) -> float | None:
        """Seconds of budget: ``request_deadline_ms``, which an
        X-PIO-Deadline-Ms header may only tighten; a malformed header is
        a 400."""
        try:
            return parse_deadline_budget(self.config.request_deadline_ms, headers)
        except ValueError as exc:
            raise _Reject(400, str(exc))

    def handle_query(self, body: Any, headers: Mapping[str, str] = {}) -> tuple[int, Any]:
        """POST /queries.json."""
        if body is None or not isinstance(body, dict):
            raise _Reject(400, "the request body must be a JSON object")
        # prId is feedback-loop metadata, not a query field
        body = dict(body)
        pr_id_in = body.pop("prId", None)
        decoder = self._query_decoder
        try:
            # span() is a shared no-op when the handler started no trace
            with span("bind"):
                query = decoder(body) if decoder is not None else body
        except (ValueError, TypeError) as e:
            raise _Reject(400, f"invalid query: {e}")

        budget = self._deadline_budget(headers)
        # one key serves the cache and the batcher's dedup pass: the
        # bound query's wire form, so camelCase and snake_case spellings
        # of one query share it
        with span("codec_key"):
            key = (canonical_json(encode_wire(query))
                   if (self.cache is not None or self.batcher is not None) else None)
        hit, generation = False, None
        if self.cache is not None:
            t0 = time.perf_counter()
            with span("cache_lookup"):
                hit, cached, generation = self.cache.lookup(key)
        if hit:
            prediction = cached
            # a hit is an answered query
            self.deployed.record_served(time.perf_counter() - t0)
        else:
            try:
                with (deadline_scope(budget) if budget is not None
                      else contextlib.nullcontext()):
                    if self.batcher is not None:
                        # the trace rides the queue entry: the dispatcher
                        # records the queue-wait and device spans onto it
                        prediction = self.batcher.submit(
                            query, timeout=budget if budget is not None else 300.0, key=key,
                            trace=active_trace())
                    elif budget is not None:
                        with span("predict"):
                            prediction = self._query_with_deadline(query, budget)
                    else:
                        with span("predict"), self._predict_lock:
                            prediction = self.deployed.query(query)
            except QueryDeadlineExceeded as e:
                raise _Reject(503, str(e), {"Retry-After": retry_after_header(1.0)})
            except STORAGE_UNAVAILABLE_ERRORS as e:
                logger.warning("query failed on unavailable storage: %s", e)
                raise _Reject(503, f"storage unavailable: {e}",
                              {"Retry-After": retry_after_header(retry_after_hint(e))})
            except Exception as e:
                logger.exception("query failed")
                raise _Reject(500, f"query failed: {e}")
            if self.cache is not None:
                # a result computed against a model that /reload swapped
                # out meanwhile is dropped, not cached
                self.cache.put(key, prediction, generation=generation)

        info = QueryInfo(query=query, prediction=prediction,
                         engine_instance_id=self.deployed.instance_id)
        try:
            prediction = self.plugins.run_blockers(info)
        except Exception as e:
            logger.warning("output blocker rejected query: %s", e)
            raise _Reject(403, f"prediction rejected: {e}")
        self.plugins.notify_sniffers(info)

        with span("encode"):
            response = encode_wire(prediction)
        if not isinstance(response, dict):
            response = {"result": response}
        # experiment attribution: the router stamps the assigned variant
        # on the request; echo it for the client's conversion events
        attribution = None
        experiment_id = headers.get("x-pio-experiment")
        if experiment_id:
            attribution = {"experimentId": experiment_id,
                           "variantId": headers.get("x-pio-variant", "")}
            response.update(attribution)
        if self.config.feedback:
            # the feedback loop: tag the response with a prId (the one
            # sent, else a new one) and post (query, prediction) back
            pr_id = pr_id_in or uuid.uuid4().hex
            response["prId"] = pr_id
            self._post_feedback(pr_id, body, response, attribution)
        if not self._compile_warmup_marked:
            # the first answered query ends serving warmup: a library
            # built after it is a live request paying a build (a benign
            # double mark is fine: the mark is idempotent)
            self._compile_warmup_marked = True
            build_obs.mark_warmup_complete()
        return (200, response)

    def _post_feedback(self, pr_id: str, query_json: dict, response: dict,
                       attribution: dict | None = None) -> None:
        """Fire-and-forget ``POST /events.json`` of a ``predict`` event
        to the event server, on a daemon thread bounded by
        ``feedback_timeout_s``; a failure is logged and never reaches
        the query. The trace context is captured here, on the handler
        thread (the posting thread has no contextvars): the post carries
        the trace id and a reserved ``feedback`` span id, so the event
        server's segment nests under it."""
        cfg = self.config
        trace = active_trace()
        feedback_span_id = trace.reserve_span_id() if trace is not None else None
        event = {
            "event": "predict",
            "entityType": "pio_pr",
            "entityId": pr_id,
            "properties": {"query": query_json, "prediction": response,
                           **(attribution or {})},
        }
        data = json.dumps(event).encode()

        def post() -> None:
            scheme, ssl_ctx = client_transport()
            url = (f"{scheme}://{cfg.event_server_ip}:{cfg.event_server_port}"
                   f"/events.json?accessKey={cfg.access_key}")
            headers = {"Content-Type": "application/json"}
            if trace is not None:
                headers[TRACE_ID_HEADER] = trace.trace_id
                headers[PARENT_SPAN_HEADER] = feedback_span_id
            t0 = time.perf_counter()
            try:
                req = urllib.request.Request(url, data=data, headers=headers, method="POST")
                with urllib.request.urlopen(req, timeout=cfg.feedback_timeout_s,
                                            context=ssl_ctx):
                    pass
            except Exception as e:
                logger.warning("feedback event POST failed: %s", e)
            finally:
                if trace is not None:
                    # the handler has usually finished the trace by now;
                    # the ring serializes at read time, so the span still
                    # shows in later reads of /traces.json
                    trace.add_span("feedback", t0, time.perf_counter(),
                                   span_id=feedback_span_id)

        threading.Thread(target=post, name="pio-feedback", daemon=True).start()

    def _query_with_deadline(self, query: Any, budget: float) -> Any:
        """The unbatched predict under a budget: the query waits for the
        lock on a pool thread (this request's contextvars copied, so the
        deadline reaches storage), and is not run if its budget ran out
        meanwhile; a wait past the budget answers 503."""
        deadline = time.monotonic() + budget

        def run() -> Any:
            with self._predict_lock:
                if time.monotonic() >= deadline:
                    self.serving_stats.bump("expired")
                    raise QueryDeadlineExceeded(budget)
                return self.deployed.query(query)

        fut = self._query_pool.submit(contextvars.copy_context().run, run)
        try:
            return fut.result(timeout=budget)
        except FuturesTimeoutError:
            if not fut.done():
                fut.cancel()
                raise QueryDeadlineExceeded(budget) from None
            raise  # the work itself raised a TimeoutError

    def reload(self, generation: int | None = None) -> None:
        """Swap to the latest COMPLETED instance, then invalidate the
        cache and advance the model generation (before the online plane
        hears of the swap, so a fold racing it is discarded). /readyz
        answers 503 "reloading" meanwhile; on failure the old instance
        keeps serving and the caller answers 503. ``generation`` pins the
        new generation: the pool's shared reload sequence, so the
        workers' caches stay comparable."""
        with self._reload_lock:
            self._reloads_in_flight += 1
        try:
            new = load_deployed_engine(
                storage=self.storage,
                config=dataclasses.replace(self.config, engine_instance_id=None),
                ctx=self.ctx, engine=self.deployed.engine)
            old_id = self.deployed.instance_id
            self.deployed = new
            self._wire_ann_observers()
            self._query_decoder = self._decoder_for(new)
            if self.cache is not None:
                # after the swap: entries of the old model die with its
                # generation; a failed reload never gets here
                self.cache.invalidate(generation=generation)
            self.model_generation = (generation if generation is not None
                                     else self.model_generation + 1)
            if self.online is not None:
                self.online.on_model_swapped(self.model_generation)
            logger.info("reloaded: instance %s -> %s", old_id, new.instance_id)
        finally:
            with self._reload_lock:
                self._reloads_in_flight -= 1


def _workers_gauge(count: int) -> Metric:
    return source_count_metric(
        "pio_serving_workers",
        "Live engine-server worker processes folded into this scrape "
        "(1 outside a worker pool)", count)


class _Handler(BaseHTTPRequestHandler):
    service: EngineService  # bound per server

    # HTTP/1.1 keep-alive: one long-lived handler thread per connection
    # instead of a TCP connect and a thread per request; every response
    # carries Content-Length
    protocol_version = "HTTP/1.1"
    # an idle keep-alive connection is hung up on after this, instead of
    # pinning its thread for the life of the process
    timeout = 30
    # one buffered write per response, and no Nagle delay
    wbufsize = 64 * 1024
    disable_nagle_algorithm = True

    def _params(self) -> dict[str, str]:
        return {k: v[0] for k, v in parse_qs(urlparse(self.path).query).items()}

    def _dispatch(self, method: str) -> None:
        """Request id, the query's trace when tracing is on, route
        latency and the SLO ring, and the access log around the real
        dispatch."""
        t_start = time.perf_counter()
        path = urlparse(self.path).path
        self._request_id = resolve_request_id(self.headers)
        self._last_status = 0
        self._trace = None
        if method == "POST" and path == "/queries.json" and self.service.tracing:
            # a well-formed inbound trace context is adopted; a malformed
            # one starts a fresh trace, never a rejected request
            inbound_id, inbound_parent = parse_trace_context(self.headers)
            self._trace = start_trace("queries.json", request_id=self._request_id,
                                      trace_id=inbound_id, parent_span_id=inbound_parent,
                                      service="engine")
        try:
            self._dispatch_inner(method, path)
        finally:
            dt = time.perf_counter() - t_start
            self.service.observe_request(path, dt, self._last_status)
            if self._trace is not None:
                self._trace.finish(status=self._last_status)
                self.service.trace_log.record(self._trace)
            if self.service.access_log:
                # with N workers behind one port, a line must say which
                wid = self.service.worker_id
                emit_access_log("engine", method, path, self._last_status, dt,
                                self._request_id, client=self.address_string(),
                                **({"worker": wid} if wid else {}))

    def _dispatch_inner(self, method: str, path: str) -> None:
        if self.headers.get("Transfer-Encoding"):
            # chunked bodies are not decoded; unread chunks would desync
            # every later request on a keep-alive connection: 411 and close
            self.close_connection = True
            self._respond(411, {"message": "chunked request bodies are not supported; "
                                           "send Content-Length"},
                          {"Connection": "close"})
            return
        # drain a Content-Length body for every method (unread bytes would
        # be parsed as the next request); a malformed or negative length
        # cannot be drained: 400 and close
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        if length < 0:
            self.close_connection = True
            self._respond(400, {"message": "invalid Content-Length"}, {"Connection": "close"})
            return
        raw = self.rfile.read(length) if length else b""
        body: Any = None
        if method == "POST" and raw:
            try:
                if self._trace is not None:
                    with self._trace.span("parse"):
                        body = json.loads(raw)
                else:
                    body = json.loads(raw)
            except json.JSONDecodeError:
                self._respond(400, {"message": "the request body is not valid JSON"})
                return
        headers = {k.lower(): v for k, v in self.headers.items()}
        # the trace bound as ambient: spans opened under handle() land on it
        with use_trace(self._trace):
            result = self.service.handle(method, path, self._params(), headers, body)
        self._respond(*result)

    def _respond(self, status: int, payload: Any,
                 extra_headers: Mapping[str, str] | None = None) -> None:
        self._last_status = status
        if isinstance(payload, PlainTextPayload):
            data, ctype = str(payload).encode(), payload.content_type
        else:
            data, ctype = json.dumps(payload).encode(), "application/json; charset=UTF-8"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.send_header(REQUEST_ID_HEADER, self._request_id)
        if self._trace is not None:
            self.send_header(TRACE_ID_HEADER, self._trace.trace_id)
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802
        self._dispatch("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch("POST")

    def log_message(self, format: str, *args) -> None:
        logger.debug("%s - %s", self.address_string(), format % args)


class EngineServer(RestServer):
    """HTTP lifecycle around EngineService: undeploys a previous server
    on the port, binds with retry ×3, owns shutdown."""

    log_label = "Engine Server"
    thread_name = "pio-engineserver"
    bind_retries = 3

    def __init__(
        self,
        deployed: DeployedEngine,
        config: ServerConfig | None = None,
        storage: Storage | None = None,
        ctx: EngineContext | None = None,
        plugin_context: EngineServerPluginContext | None = None,
    ):
        config = config if config is not None else ServerConfig()
        self.config = config
        # reuse_port is set by the deploy command for a pool, never
        # derived from ``workers`` (which the environment can set)
        super().__init__(_Handler, EngineService(deployed, config, storage, ctx, plugin_context),
                         config.ip, config.port, reuse_port=config.reuse_port)
        self.service.on_stop = self.stop
        self.service.client_disconnects = lambda: self.client_disconnects

    @property
    def deployed(self) -> DeployedEngine:
        return self.service.deployed

    def _on_bind_failure(self, attempt: int, ip: str, port: int) -> None:
        if attempt == 0 and port:
            # a previous server may hold the port: undeploy it
            undeploy(ip, port, self.config.server_key)

    def _on_close(self) -> None:
        self.service.close()


def create_engine_server(
    storage: Storage | None = None,
    config: ServerConfig | None = None,
    ctx: EngineContext | None = None,
    engine: Any = None,
    plugin_context: EngineServerPluginContext | None = None,
) -> EngineServer:
    """Load the engine instance (or model directory) ``config`` names
    onto its device (``workflow/deploy.load_deployed_engine``) and wrap
    it in a server; call ``start()`` to listen."""
    config = config if config is not None else ServerConfig()
    if config.model_dir is None:
        storage = storage or (ctx.storage if ctx is not None else Storage())
    deployed = load_deployed_engine(storage, config, ctx=ctx, engine=engine)
    return EngineServer(deployed, config, storage, ctx, plugin_context)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-dir", required=True)
    parser.add_argument("--ip", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--engine-factory", default=DEFAULT_ENGINE_FACTORY)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    serve_until_stopped(create_engine_server(config=ServerConfig(
        ip=args.ip, port=args.port, device=args.device, model_dir=args.model_dir,
        engine_factory=args.engine_factory)).start())


if __name__ == "__main__":
    main()
