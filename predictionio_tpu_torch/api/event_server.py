"""The Event Server: REST event collection on :7070 (port of the JAX
package's ``api/event_server.py``: ``EventService``, the transport-free
request logic, under ``EventServer``, its HTTP lifecycle).

Routes, with the reference's statuses:

- ``GET /``                      alive check
- ``GET /healthz``               liveness
- ``GET /readyz``                readiness: storage reachable (or the WAL
  journaling through an outage)
- ``GET /plugins.json``          plugin listing
- ``GET|DELETE /events/{id}.json``  single event
- ``POST /events.json``          insert, 201 + eventId (202 when journaled)
- ``GET /events.json``           filtered query, default limit 20
- ``POST /batch/events.json``    at most ``max_batch_events`` events, per-event
  statuses in position, one ``insert_batch`` for the batch
- ``GET /stats.json``            hourly stats and ingest counters (``--stats``)
- ``POST|GET /webhooks/{site}.json|.form``  connectors
- ``GET /metrics``               Prometheus text: ingest, WAL, resilience,
  server-info and SLO families (no key: aggregate counters only)
- ``GET /traces.json``           recent ingest traces (behind the key: they
  carry per-request data), when tracing is on (``tracing``, else
  ``PIO_TRACE``): ``parse → validate → insert | insert_batch`` (or
  ``journal``), and one ``wal.replay`` trace per WAL replay pass

Auth: ``accessKey`` query parameter, else the HTTP Basic user part;
``channel`` selects a named channel; event-name whitelists on access
keys answer 403. Storage outages answer ``503`` + ``Retry-After``; with
the write-ahead journal on (``wal_dir``, ``data/wal.py``) they answer
``202`` and the event is journaled (``ride-through``), and under
``write-through`` every accepted event is journaled and answered 202.

Port-specific decisions:

- **No torch in the ingest process.** The server carries no device
  work, and a process that imports torch takes seconds to start, so
  neither this module nor ``pio eventserver`` imports it.
- **Conversion attribution.** Accepted events that carry an
  experiment's served stamp (``experimentId``/``variantId``
  properties) are counted per variant
  (``pio_experiment_conversions_ingested_total``,
  :meth:`EventService.conversion_counts`). Over the ``chaos`` storage
  backend an injected fault reaches a client only as a retried success
  or a 503 with ``Retry-After``.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import os
import re
import threading
import time
import uuid
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
    resolve_request_id,
    retry_after_header,
)
from predictionio_tpu_torch.api.plugins import EventInfo, EventServerPluginContext
from predictionio_tpu_torch.api.stats import IngestStats, StatsKeeper, resilience_snapshot
from predictionio_tpu_torch.api.webhooks import (
    FORM_CONNECTORS,
    JSON_CONNECTORS,
    ConnectorError,
    connector_to_event,
)
from predictionio_tpu_torch.core.event import EventValidationError
from predictionio_tpu_torch.core.json_codec import event_from_json, event_to_json, parse_datetime
from predictionio_tpu_torch.data.wal import (
    WalDrainer,
    WalFullError,
    WriteAheadLog,
    encode_record,
    make_storage_unavailable,
)
from predictionio_tpu_torch.obs.exporter import CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE
from predictionio_tpu_torch.obs.exporter import render_prometheus
from predictionio_tpu_torch.obs.registry import (
    HistogramFamily,
    Metric,
    MetricRegistry,
    ingest_collector,
    resilience_collector,
    server_info_collector,
    wal_collector,
)
from predictionio_tpu_torch.obs.slo import SLOEngine
from predictionio_tpu_torch.obs.trace import (
    TRACE_ID_HEADER,
    TraceLog,
    parse_trace_context,
    span,
    start_trace,
    tracing_default,
    use_trace,
)
from predictionio_tpu_torch.storage.base import EventFilter
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.resilience import (
    STORAGE_UNAVAILABLE_ERRORS,
    StorageUnavailableError,
    deadline_scope,
    retry_after_hint,
)

logger = logging.getLogger(__name__)

#: the reference's batch cap (MaxNumberOfEventsPerBatchRequest); the
#: effective limit is ``EventServerConfig.max_batch_events``
MAX_EVENTS_PER_BATCH = 50

#: journal disk budget past which ingest reverts to 503 backpressure
DEFAULT_WAL_MAX_BYTES = 256 << 20


def _env_str(name: str, default: str | None, allowed: tuple[str, ...] | None = None):
    """Env-defaulted string field, read at construction (never at
    import); a value outside ``allowed`` degrades to the default with a
    warning."""
    def build() -> str | None:
        raw = os.environ.get(name)
        if raw is None or raw == "":
            return default
        if allowed is not None and raw not in allowed:
            logger.warning("ignoring malformed %s=%r (using %r)", name, raw, default)
            return default
        return raw
    return build


def _env_int(name: str, default: int):
    """Env-defaulted positive-int field: a malformed or non-positive
    value degrades to the default with a warning (never kills startup)."""
    def build() -> int:
        raw = os.environ.get(name)
        if raw is None:
            return default
        try:
            value = int(raw)
        except ValueError:
            value = 0
        if value <= 0:
            logger.warning("ignoring malformed %s=%r (using %d)", name, raw, default)
            return default
        return value
    return build


@dataclasses.dataclass(frozen=True)
class EventServerConfig:
    """The reference's EventServerConfig plus the ingest knobs; every
    ``PIO_EVENTSERVER_*`` default is read when the config is built."""
    ip: str = "0.0.0.0"
    port: int = 7070                # 0 binds a free port (``EventServer.port``)
    stats: bool = False
    #: ``POST /batch/events.json`` cap (``PIO_EVENTSERVER_MAX_BATCH``)
    max_batch_events: int = dataclasses.field(
        default_factory=_env_int("PIO_EVENTSERVER_MAX_BATCH", MAX_EVENTS_PER_BATCH))
    #: journal directory; None disables the WAL (outages answer 503)
    wal_dir: str | None = dataclasses.field(
        default_factory=_env_str("PIO_EVENTSERVER_WAL_DIR", None))
    #: ``always`` | ``interval`` | ``off`` (data/wal.py)
    wal_fsync: str = dataclasses.field(
        default_factory=_env_str("PIO_EVENTSERVER_WAL_FSYNC", "interval",
                                 allowed=("always", "interval", "off")))
    #: past this many pending journal bytes, ingest sheds 503s again
    wal_max_bytes: int = dataclasses.field(
        default_factory=_env_int("PIO_EVENTSERVER_WAL_MAX_BYTES", DEFAULT_WAL_MAX_BYTES))
    #: ``ride-through`` journals only while storage is down (202 then,
    #: 201 otherwise); ``write-through`` journals every accepted event
    #: and answers 202 — storage is written only by the drainer
    wal_policy: str = dataclasses.field(
        default_factory=_env_str("PIO_EVENTSERVER_WAL_POLICY", "ride-through",
                                 allowed=("ride-through", "write-through")))
    #: application-level replay failures before a record is quarantined
    wal_replay_attempts: int = dataclasses.field(
        default_factory=_env_int("PIO_EVENTSERVER_WAL_REPLAY_ATTEMPTS", 5))
    #: per-request spans for the ingest paths (GET /traces.json) and
    #: structured JSON access logs; None defers to the PIO_TRACE /
    #: PIO_ACCESS_LOG env vars at server construction
    tracing: bool | None = None
    access_log: bool | None = None


@dataclasses.dataclass(frozen=True)
class AuthData:
    """The reference's AuthData: the key's app, the channel, the key's
    event whitelist (empty: all events)."""
    app_id: int
    channel_id: int | None
    events: tuple[str, ...]


class _Reject(Exception):
    def __init__(self, status: int, message: str):
        self.status = status
        self.message = message


#: (HTTP status, JSON body) or (status, body, extra response headers)
Response = tuple


class EventService:
    """Transport-free event-server request logic."""

    def __init__(self, storage: Storage | None = None,
                 config: EventServerConfig | None = None,
                 plugin_context: EventServerPluginContext | None = None):
        self.storage = storage or Storage()
        self.config = config = config or EventServerConfig()
        self.events = self.storage.get_events()
        self.access_keys = self.storage.get_meta_data_access_keys()
        self.channels = self.storage.get_meta_data_channels()
        self.plugin_context = plugin_context or EventServerPluginContext()
        self.stats = StatsKeeper() if config.stats else None
        #: ingest counters, always kept; shown by GET /stats.json
        self.ingest_stats = IngestStats()
        #: structured JSON access logs, as the engine server's: the
        #: config, else PIO_ACCESS_LOG
        self.access_log = access_log_enabled(config.access_log)
        if self.access_log:
            ensure_access_log_handler()
        self.tracing = config.tracing if config.tracing is not None else tracing_default()
        self.trace_log = TraceLog()
        self.request_latency = HistogramFamily(
            "pio_http_request_seconds",
            "HTTP request walltime by route (handler-measured)",
            "route", ("events_post", "events_get", "batch", "webhooks",
                      "stats", "metrics"))
        self.registry = MetricRegistry()
        self.registry.register(self.request_latency.collect)
        self.registry.register(ingest_collector(self.ingest_stats))
        self.registry.register(resilience_collector())
        self.registry.register(server_info_collector("event"))
        #: SLO burn rates over the ingest write paths
        self.slo = SLOEngine()
        self.registry.register(self.slo.collector())
        #: conversion attribution (``experiment/controller.py``): accepted
        #: client events carrying the served experimentId/variantId
        #: stamp, counted per variant, which ``pio experiment
        #: conversions`` sweeps into the router's online score. The
        #: server's own "predict" feedback events are excluded: serving
        #: a rec is not the user acting on it.
        self._conversion_lock = threading.Lock()
        self._conversions: dict[tuple[str, str], int] = {}
        self.registry.register(self._conversions_collector)
        #: auth answers given while the metadata store was reachable,
        #: served stale during an outage so the WAL ride-through can
        #: authenticate; storage stays authoritative while healthy
        self._auth_cache: dict[Any, Any] = {}
        self._auth_cache_lock = threading.Lock()
        self.wal = None
        self.wal_drainer = None
        if config.wal_dir:
            self.wal = WriteAheadLog(config.wal_dir, fsync=config.wal_fsync,
                                     max_bytes=config.wal_max_bytes)
            self.wal_drainer = WalDrainer(
                self.wal, self._drain_insert_batch,
                max_replay_attempts=config.wal_replay_attempts,
                trace_factory=self._wal_trace if self.tracing else None,
                trace_sink=self.trace_log.record if self.tracing else None)
            self.registry.register(wal_collector(self.wal, self.wal_drainer))
            self.wal_drainer.start()
            logger.info("durable ingest: WAL at %s (fsync=%s, budget=%d bytes, "
                        "policy=%s, %d pending record(s) recovered)",
                        config.wal_dir, config.wal_fsync, config.wal_max_bytes,
                        config.wal_policy, self.wal.pending_records())

    def _drain_insert_batch(self, events, app_id, channel_id):
        """The drainer's storage write: the idempotent pre-assigned-id
        ``insert_batch``, counted into IngestStats (events that landed)."""
        t0 = time.perf_counter()
        ids = self.events.insert_batch(list(events), app_id, channel_id)
        self.ingest_stats.insert_latency.observe(time.perf_counter() - t0)
        self.ingest_stats.record_batch(len(events))
        return ids

    def _wal_trace(self):
        """One trace per replay pass: its decode → insert_batch → commit
        spans land in the same /traces.json ring as the request paths."""
        return start_trace("wal.replay", service="event")

    # -- auth ----------------------------------------------------------------
    def authenticate(self, params: Mapping[str, str],
                     headers: Mapping[str, str]) -> AuthData:
        key = params.get("accessKey")
        if not key:
            auth = headers.get("Authorization", "")
            if auth.startswith("Basic "):
                try:
                    decoded = base64.b64decode(auth[len("Basic "):]).decode()
                    key = decoded.strip().split(":")[0]
                except Exception:
                    raise _Reject(401, "Invalid accessKey.")
        if not key:
            raise _Reject(401, "Missing accessKey.")
        access_key = self._cached_lookup(("key", key), lambda: self.access_keys.get(key))
        if access_key is None:
            raise _Reject(401, "Invalid accessKey.")
        channel_id: int | None = None
        channel_name = params.get("channel")
        if channel_name:
            channel_map = self._cached_lookup(
                ("channels", access_key.appid),
                lambda: {c.name: c.id for c in self.channels.get_by_app_id(access_key.appid)})
            if channel_name not in channel_map:
                raise _Reject(401, f"Invalid channel '{channel_name}'.")
            channel_id = channel_map[channel_name]
        return AuthData(access_key.appid, channel_id, tuple(access_key.events))

    def _cached_lookup(self, cache_key, fetch):
        """Metadata lookup with a stale fallback during an outage. A key
        never seen while storage was healthy still answers 503, and
        negative answers are not cached: bogus keys never grow the cache,
        and a key deleted while healthy drops out of it."""
        try:
            value = fetch()
        except STORAGE_UNAVAILABLE_ERRORS:
            with self._auth_cache_lock:
                if cache_key in self._auth_cache:
                    return self._auth_cache[cache_key]
            raise
        with self._auth_cache_lock:
            if value is None:
                self._auth_cache.pop(cache_key, None)
            else:
                self._auth_cache[cache_key] = value
        return value

    # -- route handlers ------------------------------------------------------
    def alive(self) -> Response:
        return 200, {"status": "alive"}

    def healthz(self) -> Response:
        return 200, {"status": "ok"}

    def readyz(self) -> Response:
        """The metadata store answers a cheap keyed read within a second;
        else 503 + Retry-After, unless the WAL is journaling through the
        outage with room left (then ingest is ready)."""
        def probe() -> None:
            with deadline_scope(1.0):
                self.access_keys.get("__readyz_probe__")

        err = bounded_probe(probe, timeout=1.0)
        if err is not None:
            if self.wal is not None and not self.wal.is_full():
                return 200, {"status": "ready", "storage": "unavailable",
                             "durability": "journaling"}
            return (503, {"status": "unavailable", "storage": f"{err}"},
                    {"Retry-After": retry_after_header(retry_after_hint(err))})
        return 200, {"status": "ready", "storage": "ok"}

    def plugins_json(self) -> Response:
        return 200, self.plugin_context.describe()

    def post_event(self, params: Mapping[str, str], headers: Mapping[str, str],
                   body: Any) -> Response:
        auth = self.authenticate(params, headers)
        if not isinstance(body, Mapping):
            return 400, {"message": "request body must be a JSON object"}
        try:
            # span() is a shared no-op when tracing is off
            with span("validate"):
                event = event_from_json(body)
        except EventValidationError as exc:
            return 400, {"message": str(exc)}
        if auth.events and event.event not in auth.events:
            return 403, {"message": f"{event.event} events are not allowed"}
        try:
            self.plugin_context.run_blockers(EventInfo(auth.app_id, auth.channel_id, event))
        except Exception as exc:
            return 403, {"message": str(exc)}
        return self._insert_or_journal(event, auth)

    def _accepted(self, event, auth: AuthData, status: int) -> None:
        """Sniffers and the hourly stats fire on acceptance (201 or 202:
        the server owns the event either way)."""
        self.plugin_context.notify_sniffers(EventInfo(auth.app_id, auth.channel_id, event))
        if self.stats:
            self.stats.update(auth.app_id, status, event)
        self._count_conversion(event)

    def _count_conversion(self, event) -> None:
        """Fold one accepted event into the per-variant conversion
        counters when it carries the served attribution stamp
        (experimentId/variantId properties)."""
        if event.event == "predict":
            return
        try:
            experiment = event.properties.get("experimentId")
            variant = event.properties.get("variantId")
        except Exception:  # noqa: BLE001 — properties are client data
            return
        if not experiment or not variant:
            return
        key = (str(experiment), str(variant))
        with self._conversion_lock:
            self._conversions[key] = self._conversions.get(key, 0) + 1

    def _conversions_collector(self) -> list[Metric]:
        with self._conversion_lock:
            samples = [({"experiment": e, "variant": v}, float(n))
                       for (e, v), n in sorted(self._conversions.items())]
        return [Metric(
            "pio_experiment_conversions_ingested_total", "counter",
            "Accepted events carrying experiment attribution "
            "(conversion candidates), per variant.", samples=samples)]

    def conversion_counts(self, experiment: str) -> dict[str, int]:
        """Per-variant conversion totals for one experiment: what
        ``pio experiment conversions`` sweeps into the router's online
        score."""
        with self._conversion_lock:
            return {v: n for (e, v), n in self._conversions.items()
                    if e == experiment}

    # -- durable ingest ------------------------------------------------------
    def _insert_or_journal(self, event, auth: AuthData) -> Response:
        """One event: a direct insert (201) that rides a storage outage
        through the journal (202), or journal-first under
        ``write-through``."""
        if self.wal is not None and self.config.wal_policy == "write-through":
            status, body = self._journal(event, auth)
        else:
            try:
                t0 = time.perf_counter()
                with span("insert"):
                    event_id = self.events.insert(event, auth.app_id, auth.channel_id)
                self.ingest_stats.insert_latency.observe(time.perf_counter() - t0)
                self.ingest_stats.record_batch(1)
                status, body = 201, {"eventId": event_id}
            except STORAGE_UNAVAILABLE_ERRORS as exc:
                if self.wal is None:
                    raise
                status, body = self._journal(event, auth, cause=exc)
        self._accepted(event, auth, status)
        return status, body

    def _journal(self, event, auth: AuthData,
                 cause: BaseException | None = None) -> tuple[int, dict]:
        """Append one accepted event to the WAL → 202. At the disk budget
        this degrades to 503 with a Retry-After that tracks the drain."""
        if not event.event_id:
            # the id the client gets acknowledged is the id the drainer
            # upserts under
            event = event.with_event_id(uuid.uuid4().hex)
        try:
            with span("journal"):
                self.wal.append(encode_record(event, auth.app_id, auth.channel_id))
        except WalFullError as exc:
            hint = self.wal_drainer.backpressure_hint()
            if hint is None and cause is not None:
                hint = retry_after_hint(cause)
            raise make_storage_unavailable(exc, hint) from exc
        except OSError as exc:
            # a sick journal disk is an availability problem: 503
            logger.warning("WAL append failed (%s); shedding 503", exc)
            raise StorageUnavailableError("wal", str(exc)) from exc
        self.wal_drainer.notify()
        return 202, {"eventId": event.event_id, "durability": "journaled"}

    def _journal_result(self, event, auth: AuthData,
                        cause: BaseException | None) -> dict[str, Any]:
        """Per-event batch status: 202 journaled, or 503 when no WAL is
        configured or it is at its budget."""
        if self.wal is None:
            return {"status": 503, "message": str(cause)}
        try:
            status, body = self._journal(event, auth, cause=cause)
        except STORAGE_UNAVAILABLE_ERRORS as exc:
            return {"status": 503, "message": str(exc)}
        self._accepted(event, auth, status)
        return {"status": status, **body}

    def get_event(self, event_id: str, params: Mapping[str, str],
                  headers: Mapping[str, str]) -> Response:
        auth = self.authenticate(params, headers)
        event = self.events.get(event_id, auth.app_id, auth.channel_id)
        if event is None:
            return 404, {"message": "Not Found"}
        return 200, event_to_json(event)

    def delete_event(self, event_id: str, params: Mapping[str, str],
                     headers: Mapping[str, str]) -> Response:
        auth = self.authenticate(params, headers)
        if self.events.delete(event_id, auth.app_id, auth.channel_id):
            return 200, {"message": "Found"}
        return 404, {"message": "Not Found"}

    def get_events(self, params: Mapping[str, str], headers: Mapping[str, str]) -> Response:
        """The reference's query contract: filters, default limit 20,
        ``reversed`` only with both entityType and entityId."""
        auth = self.authenticate(params, headers)
        try:
            reversed_ = params.get("reversed", "false").lower() == "true"
            entity_type = params.get("entityType")
            entity_id = params.get("entityId")
            if reversed_ and not (entity_type and entity_id):
                return 400, {"message": "the parameter reversed can only be used with "
                                        "both entityType and entityId specified."}
            event_name = params.get("event")
            flt = EventFilter(
                start_time=(parse_datetime(params["startTime"])
                            if "startTime" in params else None),
                until_time=(parse_datetime(params["untilTime"])
                            if "untilTime" in params else None),
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=[event_name] if event_name else None,
                target_entity_type=params.get("targetEntityType", ...),
                target_entity_id=params.get("targetEntityId", ...),
                limit=int(params.get("limit", 20)),
                reversed=reversed_,
            )
        except (ValueError, KeyError) as exc:
            return 400, {"message": str(exc)}
        found = [event_to_json(e) for e in self.events.find(auth.app_id, auth.channel_id, flt)]
        if not found:
            return 404, {"message": "Not Found"}
        return 200, found

    def post_batch(self, params: Mapping[str, str], headers: Mapping[str, str],
                   body: Any) -> Response:
        """Per-event statuses in the request's order; the whole request
        is refused only over the cap. The events that pass validation,
        the whitelist and the blockers land through ONE ``insert_batch``
        (one storage transaction); a storage outage fails them together
        (503, or 202 journaled), and any other failure falls back to
        per-event inserts under pre-assigned ids, so a prefix the batch
        already committed is overwritten, never duplicated."""
        auth = self.authenticate(params, headers)
        if not isinstance(body, list):
            return 400, {"message": "request body must be a JSON array"}
        max_batch = self.config.max_batch_events
        if len(body) > max_batch:
            return 400, {"message": "Batch request must have less than or equal to "
                                    f"{max_batch} events"}
        results: list[dict[str, Any] | None] = [None] * len(body)
        pending: list[tuple[int, Any]] = []   # (position, Event)
        with span("validate"):
            for pos, item in enumerate(body):
                try:
                    if not isinstance(item, Mapping):
                        raise EventValidationError("event must be a JSON object")
                    event = event_from_json(item)
                except EventValidationError as exc:
                    results[pos] = {"status": 400, "message": str(exc)}
                    continue
                if auth.events and event.event not in auth.events:
                    results[pos] = {"status": 403,
                                    "message": f"{event.event} events are not allowed"}
                    continue
                try:
                    self.plugin_context.run_blockers(
                        EventInfo(auth.app_id, auth.channel_id, event))
                except Exception as exc:
                    results[pos] = {"status": 403, "message": str(exc)}
                    continue
                pending.append((pos, event))
        if not pending:
            return 200, results
        pending = [(pos, e if e.event_id else e.with_event_id(uuid.uuid4().hex))
                   for pos, e in pending]
        if self.wal is not None and self.config.wal_policy == "write-through":
            for pos, event in pending:
                results[pos] = self._journal_result(event, auth, cause=None)
            return 200, results
        ids: list[str] | None
        try:
            t0 = time.perf_counter()
            with span("insert_batch"):
                ids = self.events.insert_batch([e for _, e in pending], auth.app_id,
                                               auth.channel_id)
            self.ingest_stats.insert_latency.observe(time.perf_counter() - t0)
            if len(ids) != len(pending):
                ids = None     # a short id list is a partial failure
        except STORAGE_UNAVAILABLE_ERRORS as exc:
            # the backend is down: journal (or 503) the batch together
            # rather than re-walk it per event against a dead store
            for pos, event in pending:
                results[pos] = self._journal_result(event, auth, cause=exc)
            return 200, results
        except Exception:
            ids = None
        if ids is not None:
            for (pos, event), event_id in zip(pending, ids):
                self._accepted(event, auth, 201)
                results[pos] = {"status": 201, "eventId": event_id}
            self.ingest_stats.record_batch(len(pending))
            return 200, results
        down: Exception | None = None
        for pos, event in pending:
            if down is not None:
                # storage went down mid-fallback: the rest cannot have
                # landed; journal them without hammering the dead store
                results[pos] = self._journal_result(event, auth, cause=down)
                continue
            try:
                event_id = self.events.insert(event, auth.app_id, auth.channel_id)
            except STORAGE_UNAVAILABLE_ERRORS as exc:
                down = exc
                results[pos] = self._journal_result(event, auth, cause=exc)
                continue
            except Exception as exc:
                results[pos] = {"status": 500, "message": str(exc)}
                continue
            results[pos] = {"status": 201, "eventId": event_id}
            self._accepted(event, auth, 201)
            # counted as the size-1 inserts storage did on this path
            self.ingest_stats.record_batch(1)
        return 200, results

    def stats_json(self, params: Mapping[str, str], headers: Mapping[str, str]) -> Response:
        auth = self.authenticate(params, headers)
        if not self.stats:
            return 404, {"message": "To see stats, launch Event Server with --stats argument."}
        doc = self.stats.get(auth.app_id)
        doc["ingest"] = self.ingest_stats.snapshot()
        if self.wal_drainer is not None:
            doc["wal"] = self.wal_drainer.snapshot()
        snap = resilience_snapshot()
        if snap:
            doc["resilience"] = snap
        return 200, doc

    def post_webhook(self, site: str, form: bool, params: Mapping[str, str],
                     headers: Mapping[str, str], body: Any) -> Response:
        auth = self.authenticate(params, headers)
        connector = (FORM_CONNECTORS if form else JSON_CONNECTORS).get(site)
        if connector is None:
            return 404, {"message": f"webhooks connection for {site} is not supported."}
        try:
            event = connector_to_event(connector, body)
        except (ConnectorError, EventValidationError) as exc:
            return 400, {"message": str(exc)}
        return self._insert_or_journal(event, auth)

    def get_webhook(self, site: str, form: bool, params, headers) -> Response:
        self.authenticate(params, headers)
        if site not in (FORM_CONNECTORS if form else JSON_CONNECTORS):
            return 404, {"message": f"webhooks connection for {site} is not supported."}
        return 200, {"message": f"Webhooks connection for {site} is supported."}

    # -- dispatch ------------------------------------------------------------
    @staticmethod
    def route_label(method: str, path: str) -> str:
        """Low-cardinality route label for the request-latency family."""
        if path == "/events.json":
            return "events_post" if method == "POST" else "events_get"
        if path == "/batch/events.json":
            return "batch"
        if path.startswith("/webhooks/"):
            return "webhooks"
        if path == "/stats.json":
            return "stats"
        if path == "/metrics":
            return "metrics"
        return "other"

    def observe_request(self, method: str, path: str, dt: float,
                        status: int | None = None) -> None:
        route = self.route_label(method, path)
        self.request_latency.observe(route, dt)
        if status is not None and route in ("events_post", "batch"):
            # ingest availability SLO: 5xx spends error budget; client
            # errors (bad JSON, bad key) do not
            self.slo.record(ok=status < 500, latency_s=dt)

    _EVENT_PATH = re.compile(r"^/events/(?P<id>[^/]+)\.json$")
    _WEBHOOK = re.compile(r"^/webhooks/(?P<site>[^/.]+)\.(?P<kind>json|form)$")

    def handle(self, method: str, path: str, params: Mapping[str, str],
               headers: Mapping[str, str], body: Any = None) -> Response:
        """Single dispatch point for all transports."""
        try:
            if method == "GET" and path in ("/", "/healthz", "/readyz", "/plugins.json"):
                return {"/": self.alive, "/healthz": self.healthz,
                        "/readyz": self.readyz, "/plugins.json": self.plugins_json}[path]()
            if method == "GET" and path == "/metrics":
                # aggregate counters only, no per-app data: no accessKey
                return 200, PlainTextPayload(render_prometheus(self.registry),
                                             PROMETHEUS_CONTENT_TYPE)
            if method == "GET" and path == "/traces.json":
                # unlike /metrics this carries per-request data: behind
                # the accessKey, as every event route
                self.authenticate(params, headers)
                return 200, {"tracing": self.tracing, "traces": self.trace_log.snapshot()}
            if path == "/events.json":
                if method == "POST":
                    return self.post_event(params, headers, body)
                if method == "GET":
                    return self.get_events(params, headers)
            if path == "/batch/events.json" and method == "POST":
                return self.post_batch(params, headers, body)
            if path == "/stats.json" and method == "GET":
                return self.stats_json(params, headers)
            m = self._EVENT_PATH.match(path)
            if m:
                if method == "GET":
                    return self.get_event(m.group("id"), params, headers)
                if method == "DELETE":
                    return self.delete_event(m.group("id"), params, headers)
            m = self._WEBHOOK.match(path)
            if m:
                form = m.group("kind") == "form"
                if method == "POST":
                    return self.post_webhook(m.group("site"), form, params, headers, body)
                if method == "GET":
                    return self.get_webhook(m.group("site"), form, params, headers)
            return 404, {"message": "Not Found"}
        except _Reject as r:
            return r.status, {"message": r.message}
        except STORAGE_UNAVAILABLE_ERRORS as exc:
            logger.warning("storage unavailable handling %s %s: %s", method, path, exc)
            return (503, {"message": f"storage unavailable: {exc}"},
                    {"Retry-After": retry_after_header(retry_after_hint(exc))})
        except Exception as exc:
            logger.exception("internal error handling %s %s", method, path)
            return 500, {"message": str(exc)}

    def close(self) -> None:
        if self.wal_drainer is not None:
            self.wal_drainer.stop()
        if self.wal is not None:
            self.wal.close()
        self.plugin_context.close()


_MALFORMED = object()


class _Handler(BaseHTTPRequestHandler):
    service: EventService  # set on the bound subclass

    protocol_version = "HTTP/1.1"

    def _params(self) -> dict[str, str]:
        return {k: v[0] for k, v in parse_qs(urlparse(self.path).query).items()}

    def _body(self) -> Any:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        if not raw:
            return None
        content_type = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if content_type == "application/x-www-form-urlencoded":
            return {k: v[0] for k, v in parse_qs(raw.decode()).items()}
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            return _MALFORMED

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

    #: ingest hot paths that get a trace when tracing is on
    _TRACED_PATHS = ("/events.json", "/batch/events.json")

    def _dispatch(self, method: str) -> None:
        """Request id, an ingest trace when tracing is on, route latency
        and the SLO ring, and the access log around the real dispatch."""
        t_start = time.perf_counter()
        path = urlparse(self.path).path
        self._request_id = resolve_request_id(self.headers)
        self._last_status = 0
        self._trace = None
        if method == "POST" and path in self._TRACED_PATHS and self.service.tracing:
            # a well-formed inbound context (the feedback loop's engine →
            # event POSTs) is adopted; a malformed one starts a fresh trace
            inbound_id, inbound_parent = parse_trace_context(self.headers)
            self._trace = start_trace(path.lstrip("/"), request_id=self._request_id,
                                      trace_id=inbound_id, parent_span_id=inbound_parent,
                                      service="event")
        try:
            if method in ("POST", "PUT"):
                if self._trace is not None:
                    with self._trace.span("parse"):
                        body = self._body()
                else:
                    body = self._body()
            else:
                body = None
            if body is _MALFORMED:
                self._respond(400, {"message": "the request body is not valid JSON"})
                return
            # the trace bound as ambient: the service's spans land on it
            with use_trace(self._trace):
                result = self.service.handle(method, path, self._params(),
                                             dict(self.headers.items()), body)
            self._respond(*result)
        finally:
            dt = time.perf_counter() - t_start
            self.service.observe_request(method, path, dt, self._last_status)
            if self._trace is not None:
                self._trace.finish(status=self._last_status)
                self.service.trace_log.record(self._trace)
            if self.service.access_log:
                emit_access_log("event", method, path, self._last_status, dt,
                                self._request_id, client=self.address_string())

    def do_GET(self) -> None:  # noqa: N802
        self._dispatch("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self) -> None:  # noqa: N802
        self._dispatch("DELETE")

    def log_message(self, format: str, *args) -> None:
        logger.debug("%s - %s", self.address_string(), format % args)


class EventServer(RestServer):
    """The HTTP server over an :class:`EventService` (the reference's
    createEventServer): wires the DAOs and binds the port."""

    log_label = "Event Server"
    thread_name = "pio-eventserver"

    def __init__(self, storage: Storage | None = None,
                 config: EventServerConfig | None = None,
                 plugin_context: EventServerPluginContext | None = None):
        self.config = config or EventServerConfig()
        super().__init__(_Handler, EventService(storage, self.config, plugin_context),
                         self.config.ip, self.config.port)

    def _on_close(self) -> None:
        self.service.close()


def create_event_server(storage: Storage | None = None,
                        config: EventServerConfig | None = None) -> EventServer:
    return EventServer(storage, config)
