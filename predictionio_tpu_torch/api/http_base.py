"""Shared REST-server lifecycle for the serving plane (a copy of the
JAX package's ``api/http_base.py``): a handler class bound to a
transport-free service object, optional TLS (``utils/ssl_config``),
ephemeral ports (port 0), a bind retry with jittered backoff, a
background-thread serve and a clean, idempotent shutdown.

Plumbing shared by every handler:

- **request ids** — :func:`resolve_request_id` accepts an inbound
  ``X-PIO-Request-Id`` (sanitized: a hostile header must not inject
  into logs) or mints one; every response echoes it, so a client, a
  proxy log, and this server's access log correlate one request;
- **structured access logs** — :func:`emit_access_log` writes one JSON
  object per request (method, path, status, latency_ms, request_id) on
  the ``pio.access`` logger, gated by :func:`access_log_enabled`
  (the ``PIO_ACCESS_LOG`` env var);
- **deadlines** — :func:`parse_deadline_budget` and
  :func:`retry_after_header` (a jittered ``Retry-After`` on every 503);
- **plain-text payloads** — :class:`PlainTextPayload` marks a response
  body (the Prometheus ``/metrics`` text) that must not be
  JSON-encoded;
- **a shared port** — ``reuse_port`` binds with ``SO_REUSEPORT``, so the
  N workers of ``pio deploy --workers N`` listen on one port and the
  kernel spreads connections across them.
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import os
import random
import re
import signal
import socket
import sys
import threading
import time
import uuid
from http.server import ThreadingHTTPServer
from typing import Mapping

from predictionio_tpu_torch.utils.resilience import RetryPolicy
from predictionio_tpu_torch.utils.ssl_config import client_transport, maybe_enable_ssl

logger = logging.getLogger(__name__)

#: dedicated access-log stream: operators route it separately from the
#: framework's diagnostic logging (a JSON-lines file, a sidecar, ...)
access_logger = logging.getLogger("pio.access")

REQUEST_ID_HEADER = "X-PIO-Request-Id"

#: inbound request ids are propagated only when they look like ids —
#: anything else (spaces, quotes, control bytes, unbounded length) is
#: replaced, never logged verbatim
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._:-]{1,128}$")

#: minted request ids are a per-process random prefix + a sequence (no
#: os.urandom read per request); itertools.count is one C call, safe
#: under the GIL
_REQUEST_ID_PREFIX = uuid.uuid4().hex[:8]
_REQUEST_ID_SEQ = itertools.count(1)


class PlainTextPayload(str):
    """Marker: respond with this body as ``text/plain`` (optionally a
    specific content type), not JSON — the ``GET /metrics`` path."""

    content_type = "text/plain; charset=utf-8"

    def __new__(cls, body: str, content_type: str | None = None):
        self = super().__new__(cls, body)
        if content_type is not None:
            self.content_type = content_type
        return self


def resolve_request_id(headers: Mapping[str, str]) -> str:
    """The request's correlation id: a well-formed inbound
    ``X-PIO-Request-Id`` wins (callers correlate across services),
    otherwise a fresh one is minted. ``headers`` may be an
    ``email.Message`` (case-insensitive get) or a plain lowercased
    dict — both header spellings are tried."""
    raw = headers.get(REQUEST_ID_HEADER) or headers.get("x-pio-request-id")
    if raw and _REQUEST_ID_RE.match(raw):
        return raw
    return f"{_REQUEST_ID_PREFIX}{next(_REQUEST_ID_SEQ):08x}"


#: seeded jitter source for Retry-After hints — seeded so the draw
#: sequence is reproducible per process (tests may also pass their own
#: rng); the POINT is that two clients shed in the same instant get
#: DIFFERENT hints
_RETRY_AFTER_RNG = random.Random(0x9E3779B9)
_RETRY_AFTER_JITTER = 0.25


def retry_after_header(seconds: float,
                       rng: random.Random | None = None) -> str:
    """A ``Retry-After`` header value with ±25% jitter.

    Clients that all shed in the same instant and obey a constant
    integer hint come back in lockstep, when the server is weakest.
    Jittering the hint decorrelates them. The value has two decimals, a
    deliberate deviation from RFC 9110's integer delta-seconds: rounding
    ±25% of the usual 1 s hint to an integer would erase the jitter."""
    base = max(0.1, float(seconds))
    draw = (rng or _RETRY_AFTER_RNG).uniform(1.0 - _RETRY_AFTER_JITTER,
                                             1.0 + _RETRY_AFTER_JITTER)
    return f"{base * draw:.2f}"


def parse_deadline_budget(config_deadline_ms: float,
                          headers: Mapping[str, str]) -> float | None:
    """The per-request deadline contract: seconds of budget from the
    configured ``request_deadline_ms`` (0 = none), which an ``X-PIO-Deadline-Ms``
    header may only TIGHTEN. Malformed headers (non-numeric, nan/inf,
    <= 0) raise ``ValueError`` — a silent 1ms budget would 503 forever,
    so the caller maps it to a 400."""
    budget = (config_deadline_ms / 1e3 if config_deadline_ms > 0 else None)
    raw = headers.get("x-pio-deadline-ms")
    if raw:
        try:
            value = float(raw)
        except ValueError:
            value = float("nan")
        if not math.isfinite(value) or value <= 0:
            raise ValueError(f"invalid X-PIO-Deadline-Ms: {raw!r}")
        client = max(0.001, value / 1e3)
        budget = client if budget is None else min(budget, client)
    return budget


def access_log_enabled(override: bool | None = None) -> bool:
    """Per-server config wins when set; otherwise the ``PIO_ACCESS_LOG``
    env var decides (read at call time — server construction — never
    frozen at import)."""
    if override is not None:
        return override
    return os.environ.get("PIO_ACCESS_LOG", "").strip().lower() in (
        "1", "true", "yes", "on")


def ensure_access_log_handler() -> None:
    """Make an enabled access log actually emit: the flag was set, so
    INFO must flow regardless of the root logger's level (a root at
    WARNING would otherwise silently drop every line), and when
    nothing has configured ``pio.access`` (no handlers anywhere up its
    tree) it gets a stderr JSON-lines handler. Deployments that
    configured logging themselves keep their handlers."""
    access_logger.setLevel(logging.INFO)
    lg = access_logger
    while lg is not None:
        if lg.handlers:
            return
        if not lg.propagate:
            break
        lg = lg.parent
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(message)s"))
    access_logger.addHandler(handler)
    access_logger.propagate = False


def emit_access_log(server: str, method: str, path: str, status: int,
                    latency_s: float, request_id: str,
                    client: str | None = None, **extra) -> None:
    """One structured JSON access-log line. Key order is stable
    (method, path, status first) so the lines grep cleanly."""
    record = {
        "ts": round(time.time(), 3),
        "server": server,
        "method": method,
        "path": path,
        "status": status,
        "latency_ms": round(latency_s * 1e3, 3),
        "request_id": request_id,
    }
    if client:
        record["client"] = client
    record.update(extra)
    access_logger.info("%s", json.dumps(record))


class _PioHTTPServer(ThreadingHTTPServer):
    # the default listen backlog (5) resets bursts of concurrent
    # connections; match a production accept queue
    request_queue_size = 128

    def __init__(self, addr, handler, reuse_port: bool = False):
        # before super().__init__, which binds (server_bind reads it)
        self.reuse_port = reuse_port
        super().__init__(addr, handler)
        self.client_disconnects = 0
        self._disconnect_lock = threading.Lock()

    def server_bind(self):
        if self.reuse_port:
            # N worker processes share one listen port
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()

    def handle_error(self, request, client_address):
        # a client that goes away mid-request is a non-event: count it
        # and log at debug, never a traceback on the handler thread
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            with self._disconnect_lock:
                self.client_disconnects += 1
            logger.debug("client %s disconnected mid-request: %r",
                         client_address, exc)
            return
        super().handle_error(request, client_address)


def bounded_probe(fn, timeout: float = 1.0) -> BaseException | None:
    """Run a readiness probe with a HARD wall-clock bound.

    ``deadline_scope`` only suppresses retry sleeps; a blackholed
    backend still blocks one attempt for its own socket timeout. The
    probe runs on a daemon thread instead; this returns within
    ``timeout`` regardless. Returns None on success, the probe's
    exception on failure, or a TimeoutError if it outlived the bound
    (the abandoned thread unblocks on its socket timeout and exits)."""
    result: list[BaseException | None] = []

    def run() -> None:
        try:
            fn()
            result.append(None)
        except Exception as exc:  # noqa: BLE001 — reported, not raised
            result.append(exc)

    t = threading.Thread(target=run, name="pio-readyz-probe", daemon=True)
    t.start()
    t.join(timeout)
    if not result:
        return TimeoutError(f"probe exceeded {timeout:.1f}s")
    return result[0]


def undeploy(ip: str, port: int, server_key: str | None = None) -> bool:
    """POST /stop to the engine server on (ip, port): ``pio undeploy``.
    True when the server answered. Here, beside the transport, so that
    the command imports neither torch nor the serving stack."""
    import urllib.error
    import urllib.request

    scheme, ssl_ctx = client_transport()
    host = "127.0.0.1" if ip == "0.0.0.0" else ip
    url = f"{scheme}://{host}:{port}/stop"
    if server_key:
        url += f"?accessKey={server_key}"
    try:
        req = urllib.request.Request(url, data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=5, context=ssl_ctx):
            return True
    except (urllib.error.URLError, OSError):
        return False


class RestServer:
    """Subclasses set ``log_label``/``thread_name`` and may override the
    bind-failure and close hooks. ``start()`` returns the server;
    ``stopped`` is set once ``stop()`` has run."""

    log_label = "Server"
    thread_name = "pio-server"
    bind_retries = 1
    #: the delays between bind attempts: equal jitter, uniform(cap/2,
    #: cap), so that servers racing for one port do not retry in
    #: lockstep while a stopping predecessor still gets >= 1.5 s over
    #: two retries to release it. ``bind_retries`` is the attempt count.
    bind_backoff = RetryPolicy(base_delay=1.0, max_delay=2.0,
                               jitter_floor=0.5)

    def __init__(self, handler_cls: type, service, ip: str, port: int,
                 reuse_port: bool = False):
        self.ip = ip
        self.service = service
        handler = type("BoundHandler", (handler_cls,), {"service": service})
        rng = random.Random()
        for attempt in range(self.bind_retries):
            try:
                self._httpd = _PioHTTPServer((ip, port), handler, reuse_port=reuse_port)
                break
            except OSError:
                if attempt == self.bind_retries - 1:
                    raise
                self._on_bind_failure(attempt, ip, port)
                delay = self.bind_backoff.backoff(attempt, rng)
                logger.info("%s bind attempt %d failed; retrying in %.2fs",
                            self.log_label, attempt + 1, delay)
                time.sleep(delay)
        maybe_enable_ssl(self._httpd)
        self._thread: threading.Thread | None = None
        self._stop_lock = threading.RLock()   # a SIGTERM may land inside stop()
        self.stopped = threading.Event()

    # -- hooks ---------------------------------------------------------------
    def _on_bind_failure(self, attempt: int, ip: str, port: int) -> None:
        """Called between bind retries (when bind_retries > 1)."""

    def _on_close(self) -> None:
        """Called after the socket closes during stop()."""

    # -- lifecycle -----------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def client_disconnects(self) -> int:
        """How many clients vanished mid-request (never an error)."""
        return self._httpd.client_disconnects

    def start(self) -> "RestServer":
        """Serve on a background thread (returns at once)."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=self.thread_name, daemon=True
        )
        self._thread.start()
        logger.info("%s listening on %s:%s", self.log_label, self.ip, self.port)
        return self

    def stop(self) -> None:
        """Stop serving and close; a second call does nothing."""
        with self._stop_lock:
            if self.stopped.is_set():
                return
            if self._thread is not None:
                self._httpd.shutdown()
            self._httpd.server_close()
            self._on_close()
            if self._thread:
                self._thread.join(timeout=5)
                self._thread = None
            self.stopped.set()


def serve_until_stopped(server: RestServer) -> None:
    """Block a started server's process until it stops (POST /stop),
    SIGTERM or Ctrl-C, then stop the server."""
    signal.signal(signal.SIGTERM, lambda *_: server.stop())
    try:
        server.stopped.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
