"""The lean loopback HTTP client of the worker pool (a copy of the JAX
package's ``fleet/transport.py``, where the router's forward path uses
it too).

``http.client`` costs milliseconds of CPU a request (header assembly and
the email-parser response machinery); this client sends one pre-built
request in one write over pooled keep-alive sockets and parses the
answer with a minimal ``Content-Length`` parser, which is enough because
the engine server always sends ``Content-Length``. The worker hub
(``fleet/workers.py``) fetches its siblings' ``/metrics``,
``/traces.json`` and ``/stats.json`` with it, and the supervisor
(``fleet/supervisor.py``) its drain and health probes.

A stale pooled socket (the peer idled it out) gets ONE refresh with a
fresh connection, and only when zero response bytes arrived: once any
byte has been read the peer executed the request, so the failure is
raised rather than the request replayed.

Every socket operation is bounded: ``timeout`` is mandatory on
:meth:`BackendTransport.request` and is a TOTAL budget for the exchange;
the remaining budget is re-armed before every read, so a peer trickling
bytes cannot hold a thread past the deadline.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import socket
import threading
import time
from typing import Callable, Iterable, Mapping, TypeVar

from predictionio_tpu_torch.utils.resilience import TransientError

logger = logging.getLogger(__name__)

_T = TypeVar("_T")
_R = TypeVar("_R")


def fan_out(items: Iterable[_T],
            fn: Callable[[_T], _R]) -> list[_R | None]:
    """Run ``fn`` over ``items`` CONCURRENTLY (one thread per item) and return results in
    item order. Scrape-time fan-outs must pay the SLOWEST target's
    timeout, not the sum: sequentially, three black-holed peers turn a
    "bounded" 2 s-per-target scrape into 6 s of wall clock. ``fn`` is expected to handle
    its own per-target failures (degrade, don't raise); an escaped
    exception is logged and yields ``None`` in that slot."""
    items = list(items)

    def run(item: _T) -> _R | None:
        try:
            return fn(item)
        except Exception:  # noqa: BLE001 — one target must not kill the fan-out
            logger.exception("fan-out target failed")
            return None

    if len(items) <= 1:
        return [run(item) for item in items]
    results: list[_R | None] = [None] * len(items)

    def runner(idx: int, item: _T) -> None:
        results[idx] = run(item)

    threads = [
        threading.Thread(target=runner, args=(i, item), daemon=True,
                         name=f"pio-fan-out-{i}")
        for i, item in enumerate(items)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results

#: the largest response head accepted before the parse gives up
_MAX_HEADER_BYTES = 64 * 1024


class UpstreamProtocolError(TransientError):
    """The peer's response could not be parsed (closed mid-message, no
    Content-Length, oversized headers): transient, the peer is
    misbehaving."""


@dataclasses.dataclass
class UpstreamResponse:
    """One parsed upstream response: status, body bytes, and the
    (lower-cased) header map."""

    status: int
    body: bytes
    headers: dict[str, str]

    def header(self, name: str, default: str | None = None) -> str | None:
        return self.headers.get(name.lower(), default)


def build_request(method: str, path: str, host: str,
                  headers: Mapping[str, str] | None = None,
                  body: bytes | None = None) -> bytes:
    """One request as a single bytes blob (one ``sendall`` syscall)."""
    lines = [f"{method} {path} HTTP/1.1", f"Host: {host}"]
    for k, v in (headers or {}).items():
        lines.append(f"{k}: {v}")
    body = body or b""
    if body or method == "POST":
        lines.append(f"Content-Length: {len(body)}")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    return head + body


def _recv_within(sock: socket.socket, deadline: float) -> bytes:
    """One ``recv`` bounded by the exchange's remaining TOTAL budget.

    ``settimeout`` is per-operation: without re-arming it from the
    deadline each read, a replica trickling one byte per almost-timeout
    holds the handler thread (and its admission slot) indefinitely."""
    remaining = deadline - time.monotonic()
    if remaining <= 0:
        raise socket.timeout("upstream exchange exceeded its deadline")
    sock.settimeout(remaining)
    return sock.recv(65536)


def _parse_response(sock: socket.socket, buf: bytearray,
                    deadline: float) -> UpstreamResponse:
    """Read one response off ``sock`` into/out of ``buf`` (which may
    hold bytes from a previous read and keeps any trailing pipelined
    bytes — there are none in practice: one request in flight per
    pooled socket). On failure ``buf`` keeps everything read so far, so
    the caller can tell whether ANY response bytes arrived."""
    while True:
        head_end = buf.find(b"\r\n\r\n")
        if head_end >= 0:
            break
        if len(buf) > _MAX_HEADER_BYTES:
            raise UpstreamProtocolError("oversized response headers")
        chunk = _recv_within(sock, deadline)
        if not chunk:
            raise UpstreamProtocolError("upstream closed mid-headers")
        buf += chunk
    head = bytes(buf[:head_end]).decode("latin-1")
    lines = head.split("\r\n")
    parts = lines[0].split(" ", 2)
    if len(parts) < 2 or not parts[1].isdigit():
        raise UpstreamProtocolError(f"bad status line {lines[0]!r}")
    status = int(parts[1])
    headers: dict[str, str] = {}
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if sep:
            headers[name.strip().lower()] = value.strip()
    length_raw = headers.get("content-length")
    if length_raw is None or not length_raw.isdigit():
        # the engine server always sends Content-Length; anything else
        # cannot be framed on a keep-alive socket
        raise UpstreamProtocolError("upstream response has no Content-Length")
    need = head_end + 4 + int(length_raw)
    while len(buf) < need:
        chunk = _recv_within(sock, deadline)
        if not chunk:
            raise UpstreamProtocolError("upstream closed mid-body")
        buf += chunk
    body = bytes(buf[head_end + 4:need])
    del buf[:need]
    return UpstreamResponse(status=status, body=body, headers=headers)


class BackendTransport:
    """Pooled keep-alive HTTP/1.1 client for ONE backend address."""

    def __init__(self, host: str, port: int, pool_size: int = 32):
        self.host = host
        self.port = port
        self._addr = f"{host}:{port}"
        #: idle keep-alive sockets; SimpleQueue-style FIFO bounded by
        #: ``pool_size`` — beyond it sockets are closed, not pooled
        self._pool: "queue.Queue[socket.socket]" = queue.Queue(
            maxsize=max(1, pool_size))

    # -- pool ---------------------------------------------------------------
    def _connect(self, timeout: float) -> socket.socket:
        # the one raw network call, reachable only from request()
        sock = socket.create_connection((self.host, self.port), timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _checkout(self) -> socket.socket | None:
        try:
            return self._pool.get_nowait()
        except queue.Empty:
            return None

    def _checkin(self, sock: socket.socket) -> None:
        try:
            self._pool.put_nowait(sock)
        except queue.Full:
            sock.close()

    def close(self) -> None:
        while True:
            sock = self._checkout()
            if sock is None:
                return
            sock.close()

    # -- requests -----------------------------------------------------------
    def request(self, method: str, path: str,
                headers: Mapping[str, str] | None = None,
                body: bytes | None = None, *,
                timeout: float) -> UpstreamResponse:
        """One request/response exchange, bounded by ``timeout`` across
        connect + send + reads. Raises ``OSError`` subclasses /
        :class:`UpstreamProtocolError` on transport failure — both
        transient to the resilience layer. HTTP status codes (any of
        them) are returned, not raised: classification is the caller's
        job."""
        raw = build_request(method, path, self._addr, headers, body)
        deadline = time.monotonic() + timeout
        sock = self._checkout()
        reused = sock is not None
        if sock is None:
            sock = self._connect(timeout)
        try:
            sock.settimeout(max(0.001, deadline - time.monotonic()))
            first_buf = bytearray()
            try:
                sock.sendall(raw)
                response = _parse_response(sock, first_buf, deadline)
            except (UpstreamProtocolError, OSError):
                sock.close()
                if not reused or first_buf:
                    # fresh socket, or response bytes already arrived:
                    # the backend executed the request, so replaying
                    # would run the query twice — surface the failure
                    # and let the caller decide
                    raise
                # a reused socket the peer already closed (keep-alive
                # idle timeout): zero response bytes means the request
                # was never processed — one fresh-connection refresh,
                # still inside the deadline
                sock = self._connect(max(0.001, deadline - time.monotonic()))
                sock.settimeout(max(0.001, deadline - time.monotonic()))
                sock.sendall(raw)
                response = _parse_response(sock, bytearray(), deadline)
        except BaseException:
            sock.close()
            raise
        if response.headers.get("connection", "").lower() == "close":
            sock.close()
        else:
            self._checkin(sock)
        return response
