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
  device-dispatch histograms, the cache counters, resilience counters;
- ``GET /plugins.json``;
- ``GET|POST /reload``: swap to the latest COMPLETED instance, then
  invalidate the cache and advance the model generation that fences the
  online overlay; a failed reload keeps serving the last-known-good
  instance (503);
- ``POST /retrieval``: ``{"retrieval": "ann"|"brute"[, "annNprobe",
  "annRescore", "annNlist"]}`` switches retrieval at run time (409 when
  a model has no index to switch to) and invalidates the cache;
- ``POST /stop``. It, ``/reload`` and ``/retrieval`` need
  ``?accessKey=<server_key>`` when ``ServerConfig.server_key`` is set.

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
daemon thread; a failed post is logged and never reaches the query.

Left to later slices (ROADMAP.md queue 1): ``--workers``, the
shared-memory cache, ``/drain`` and the online plane across workers
(item 23); ``/metrics`` (the ANN and online collectors among them),
``/traces.json``, the feedback post's trace headers and compile
accounting (item 12).

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
from predictionio_tpu_torch.ops import flash_attention as flash_ops
from predictionio_tpu_torch.serving.batch_policy import make_batch_policy
from predictionio_tpu_torch.serving.batcher import QueryBatcher, QueryDeadlineExceeded
from predictionio_tpu_torch.serving.result_cache import ResultCache
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
        self.cache = (ResultCache(max_entries=config.cache_max_entries,
                                  ttl_s=config.cache_ttl_s, stats=self.serving_stats)
                      if config.cache_enabled else None)
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
        #: unbatched mode: one query on the device at a time
        self._predict_lock = threading.Lock()
        #: unbatched mode under a deadline: the query waits for the lock
        #: on a pool thread, so a blown budget answers 503 at once
        self._query_pool = ThreadPoolExecutor(max_workers=64,
                                              thread_name_prefix="pio-query-deadline")
        #: /reload in flight: /readyz answers 503 "reloading" meanwhile
        self._reload_lock = threading.Lock()
        self._reloads_in_flight = 0
        #: ANN-capable models count their queries into serving_stats;
        #: re-wired on every /reload, which brings new model objects
        self._wire_ann_observers()
        #: the base model's generation, advanced by every successful
        #: /reload: a fold computed against generation G is discarded
        #: once G+1 serves (online/overlay.py)
        self.model_generation = 0
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
                invalidate_user=self._invalidate_user_results)
            self.online.start()

    def _invalidate_user_results(self, user_id: str) -> None:
        """Drop one user's result-cache entries after their vector was
        folded; every other user's entries stay warm."""
        if self.cache is not None:
            from predictionio_tpu_torch.online.service import user_key_fragment

            self.cache.invalidate_matching(user_key_fragment(user_id))

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
        logger.info("retrieval reconfigured: %s (nprobe=%d rescore=%d)",
                    self.config.retrieval, self.config.ann_nprobe, self.config.ann_rescore)
        return (200, {"retrieval": self.config.retrieval, "annEnabled": self.ann_enabled()})

    def ann_enabled(self) -> bool:
        """True when a deployed model answers through its ANN index."""
        return any(getattr(t, "ann_enabled", False)
                   for t in retrieval_targets(getattr(self.deployed, "models", ())))

    @staticmethod
    def _decoder_for(deployed: DeployedEngine):
        qc = deployed.query_class
        return compile_wire_decoder(qc) if qc is not None else None

    def close(self) -> None:
        # the fold thread first: it calls into the cache
        if self.online is not None:
            self.online.close()
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
            if method == "GET" and path == "/healthz":
                return (200, {"status": "ok"})
            if method == "GET" and path == "/readyz":
                return self.readyz()
            if path == "/reload" and method in ("GET", "POST"):
                self._check_server_key(params)
                try:
                    self.reload()
                except LookupError as e:
                    raise _Reject(404, str(e))
                except Exception as e:
                    # the last-known-good instance stays deployed
                    keep = self.deployed.instance_id
                    logger.exception("reload failed; still serving instance %s", keep)
                    record_fallback("serving/reload")
                    raise _Reject(503, f"reload failed ({e}); still serving instance {keep}",
                                  {"Retry-After": retry_after_header(retry_after_hint(e))})
                return (200, {"message": "Reloading"})
            if method == "POST" and path == "/retrieval":
                self._check_server_key(params)
                return self.retrieval_admin(body)
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

    def readyz(self) -> tuple:
        """A deployed model and reachable storage; 503 with
        ``Retry-After`` otherwise, and while a /reload swaps models."""
        with self._reload_lock:
            reloading = self._reloads_in_flight > 0
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

    def stats_doc(self) -> dict:
        """GET /stats.json: the serving hot path's counters, each read
        under its own lock."""
        d = self.deployed
        return {
            "engineInstanceId": d.instance_id,
            "requestCount": d.request_count,
            "avgServingSec": d.avg_serving_sec,
            "lastServingSec": d.last_serving_sec,
            "clientDisconnects": self.client_disconnects(),
            "annEnabled": self.ann_enabled(),
            "retrieval": self.config.retrieval,
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
            query = decoder(body) if decoder is not None else body
        except (ValueError, TypeError) as e:
            raise _Reject(400, f"invalid query: {e}")

        budget = self._deadline_budget(headers)
        # one key serves the cache and the batcher's dedup pass: the
        # bound query's wire form, so camelCase and snake_case spellings
        # of one query share it
        key = (canonical_json(encode_wire(query))
               if (self.cache is not None or self.batcher is not None) else None)
        hit, generation = False, None
        if self.cache is not None:
            t0 = time.perf_counter()
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
                        prediction = self.batcher.submit(
                            query, timeout=budget if budget is not None else 300.0, key=key)
                    elif budget is not None:
                        prediction = self._query_with_deadline(query, budget)
                    else:
                        with self._predict_lock:
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
        return (200, response)

    def _post_feedback(self, pr_id: str, query_json: dict, response: dict,
                       attribution: dict | None = None) -> None:
        """Fire-and-forget ``POST /events.json`` of a ``predict`` event
        to the event server, on a daemon thread bounded by
        ``feedback_timeout_s``; a failure is logged and never reaches
        the query."""
        cfg = self.config
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
            try:
                req = urllib.request.Request(
                    url, data=data, headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=cfg.feedback_timeout_s,
                                            context=ssl_ctx):
                    pass
            except Exception as e:
                logger.warning("feedback event POST failed: %s", e)

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

    def reload(self) -> None:
        """Swap to the latest COMPLETED instance, then invalidate the
        cache and advance the model generation (before the online plane
        hears of the swap, so a fold racing it is discarded). /readyz
        answers 503 "reloading" meanwhile; on failure the old instance
        keeps serving and the caller answers 503."""
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
                self.cache.invalidate()
            self.model_generation += 1
            if self.online is not None:
                self.online.on_model_swapped(self.model_generation)
            logger.info("reloaded: instance %s -> %s", old_id, new.instance_id)
        finally:
            with self._reload_lock:
                self._reloads_in_flight -= 1


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
        t_start = time.perf_counter()
        path = urlparse(self.path).path
        self._request_id = resolve_request_id(self.headers)
        self._last_status = 0
        try:
            self._dispatch_inner(method, path)
        finally:
            if self.service.access_log:
                emit_access_log("engine", method, path, self._last_status,
                                time.perf_counter() - t_start, self._request_id,
                                client=self.address_string())

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
                body = json.loads(raw)
            except json.JSONDecodeError:
                self._respond(400, {"message": "the request body is not valid JSON"})
                return
        headers = {k.lower(): v for k, v in self.headers.items()}
        self._respond(*self.service.handle(method, path, self._params(), headers, body))

    def _respond(self, status: int, payload: Any,
                 extra_headers: Mapping[str, str] | None = None) -> None:
        self._last_status = status
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=UTF-8")
        self.send_header("Content-Length", str(len(data)))
        self.send_header(REQUEST_ID_HEADER, self._request_id)
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
        super().__init__(_Handler, EngineService(deployed, config, storage, ctx, plugin_context),
                         config.ip, config.port)
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
