"""Worker peering for ``pio deploy --workers N`` (a copy of the JAX
package's ``fleet/workers.py``): a scrape that lands on ONE worker of
the ``SO_REUSEPORT`` pool reports ALL of them.

The kernel spreads connections across N identical processes, so a
``GET /metrics`` samples a random worker's private registry. The hub
gives every worker:

- a **loopback peer endpoint** (127.0.0.1, an ephemeral port) serving
  the worker's OWN exposition at ``/metrics``, its trace ring at
  ``/traces.json`` and the local documents the server registers
  (``extra_paths``: the engine server's own ``/stats.json`` and ``/``),
  never bound beyond loopback;
- a **spool directory** (one ``<worker id>.json`` per live worker,
  written atomically) through which the workers find each other without
  a coordinator: the deploy command creates it and hands its path to
  every worker;
- **fan-out fetch** with a timeout per peer (a wedged worker costs the
  scrape its timeout, never a hang), over ``fleet/transport.py``. A peer
  whose process is gone (``os.kill(pid, 0)`` raises
  ``ProcessLookupError``) has its spool entry reaped.

The scraped worker merges its siblings' parsed families with its own
through ``obs/aggregate.merge_sources``.

**Shared admin state** rides the same spool: a monotonically sequenced
``admin.state`` document (atomic ``os.replace``, like the worker
entries) that every sibling's sync loop applies
(``serving/workers.WorkerCoherence``), so a ``/reload`` or ``/drain``
landing on ONE worker reaches all of them, and a respawned worker adopts
the latest document at start. Concurrent publishers race last-writer-
wins on the ``os.replace``; admin mutations are rare, and the sequence
number makes the winner unambiguous. (Named ``admin.state``, not
``*.json``, so the peer listing never takes it for a worker entry.)
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from predictionio_tpu_torch.fleet.transport import BackendTransport, fan_out

logger = logging.getLogger(__name__)

#: worker ids are pid + a per-process sequence: a deployed worker is one
#: hub per process (the pid alone would do), but tests run several
#: servers of one pool in ONE process, and each must register its own
#: spool entry instead of overwriting its sibling's
_HUB_SEQ = itertools.count(1)

#: per-peer fetch bound — scrapes degrade, they never hang
DEFAULT_PEER_TIMEOUT_S = 2.0

#: the shared admin-state document inside the spool (module docstring)
ADMIN_STATE_FILE = "admin.state"


class _PeerHandler(BaseHTTPRequestHandler):
    """Loopback-only peer surface: this worker's raw exposition and
    trace ring, for sibling workers' scrape-time fan-out."""

    hub: "WorkerHub"  # bound per server
    protocol_version = "HTTP/1.1"
    timeout = 10

    def do_GET(self) -> None:  # noqa: N802
        if self.path == "/metrics":
            body = self.hub._metrics_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif self.path == "/traces.json":
            body = json.dumps(
                {"traces": self.hub._traces_snapshot()}).encode()
            ctype = "application/json; charset=UTF-8"
        elif self.path in self.hub._extra_paths:
            # extra LOCAL documents a server registers for sibling
            # fan-out (the engine server's own /stats.json and status);
            # the callback must return this worker's OWN view: a
            # callback that itself fans out to peers would recurse
            # A -> B -> A across the pool
            body = json.dumps(self.hub._extra_paths[self.path]()).encode()
            ctype = "application/json; charset=UTF-8"
        else:
            body, ctype = b'{"message": "not found"}', "application/json"
            self.send_response(404)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format: str, *args) -> None:
        logger.debug("worker-peer %s - %s", self.address_string(),
                     format % args)


class WorkerHub:
    """One worker's membership in the spool + its peer endpoint."""

    def __init__(self, spool_dir: str,
                 metrics_text: Callable[[], str],
                 traces_snapshot: Callable[[], list],
                 timeout_s: float = DEFAULT_PEER_TIMEOUT_S,
                 extra_paths: dict[str, Callable[[], object]] | None = None):
        self.spool_dir = spool_dir
        self.worker_id = f"{os.getpid()}-{next(_HUB_SEQ)}"
        self.timeout_s = timeout_s
        self._metrics_text = metrics_text
        self._traces_snapshot = traces_snapshot
        #: additional loopback-only JSON documents (path -> callable
        #: returning this worker's LOCAL view; see _PeerHandler)
        self._extra_paths = dict(extra_paths or {})
        os.makedirs(spool_dir, exist_ok=True)
        handler = type("BoundPeerHandler", (_PeerHandler,), {"hub": self})
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.peer_port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="pio-worker-peer", daemon=True)
        self._thread.start()
        self._spool_path = os.path.join(spool_dir, f"{self.worker_id}.json")
        tmp = self._spool_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"worker": self.worker_id, "pid": os.getpid(),
                       "port": self.peer_port}, f)
        os.replace(tmp, self._spool_path)   # atomic: peers never see a torn file

    # -- discovery -----------------------------------------------------------
    def peers(self) -> list[dict]:
        """Live sibling workers ``{"pid", "port"}`` (self excluded);
        reaps spool entries whose process is gone."""
        out: list[dict] = []
        try:
            entries = os.listdir(self.spool_dir)
        except OSError:
            return out
        for entry in entries:
            if not entry.endswith(".json") \
                    or entry == f"{self.worker_id}.json":
                continue
            path = os.path.join(self.spool_dir, entry)
            try:
                with open(path) as f:
                    doc = json.load(f)
                worker = str(doc["worker"])
                pid = int(doc["pid"])
                port = int(doc["port"])
            except (OSError, ValueError, KeyError, json.JSONDecodeError):
                continue    # torn write in progress or junk: skip, not reap
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                self._reap(path, pid)
                continue
            except PermissionError:
                pass        # alive, different uid — keep it
            out.append({"worker": worker, "pid": pid, "port": port})
        return out

    def _reap(self, path: str, pid: int) -> None:
        try:
            os.unlink(path)
            logger.info("reaped dead worker %d from the spool", pid)
        except OSError:
            pass

    # -- fan-out -------------------------------------------------------------
    def fetch_peer_bodies(self, path: str) -> list[tuple[str, bytes]]:
        """``(worker_id, body)`` per live peer that answered ``path``
        within the timeout; failures are skipped (and logged), never
        raised — a wedged sibling degrades the merge, not the scrape.
        Peers are fetched concurrently (fleet/transport.fan_out): the
        scrape pays the slowest peer's timeout, not the sum."""

        def fetch(peer: dict) -> tuple[str, bytes] | None:
            transport = BackendTransport("127.0.0.1", peer["port"],
                                         pool_size=1)
            try:
                response = transport.request(
                    "GET", path, timeout=self.timeout_s)
                if response.status == 200:
                    return (peer["worker"], response.body)
                logger.warning(
                    "worker peer %d answered HTTP %d for %s",
                    peer["pid"], response.status, path)
            except Exception as exc:  # noqa: BLE001 — degrade, don't fail the scrape
                logger.warning("worker peer %d unreachable: %s",
                               peer["pid"], exc)
            finally:
                transport.close()
            return None

        return [body for body in fan_out(self.peers(), fetch)
                if body is not None]

    # -- shared admin state (module docstring) --------------------------------
    def read_admin(self) -> dict | None:
        """The latest admin document, or None (never published / torn
        write in progress — the next sync pass reads the committed
        one)."""
        path = os.path.join(self.spool_dir, ADMIN_STATE_FILE)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return None
        if not isinstance(doc, dict) or not isinstance(
                doc.get("seq"), int):
            return None
        return doc

    def publish_admin(self, doc: dict) -> int:
        """Publish one admin mutation for every sibling to apply:
        assigns ``seq`` = latest + 1, stamps the publishing worker, and
        commits with an atomic ``os.replace`` (peers never see a torn
        document). Returns the assigned sequence number."""
        current = self.read_admin()
        seq = (current["seq"] if current else 0) + 1
        payload = {**doc, "seq": seq, "publishedBy": self.worker_id}
        path = os.path.join(self.spool_dir, ADMIN_STATE_FILE)
        tmp = f"{path}.{self.worker_id}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        logger.info("published admin state seq=%d: %s", seq,
                    doc.get("action"))
        return seq

    def close(self) -> None:
        try:
            os.unlink(self._spool_path)
        except OSError:
            pass
        try:
            # the admin document only matters while siblings remain;
            # removing it here would race a survivor's sync loop, so it
            # rides along until the spool dir itself goes (rmdir below
            # succeeds only for the LAST worker out, which first clears
            # the admin file)
            if not any(e.endswith(".json")
                       for e in os.listdir(self.spool_dir)):
                os.unlink(os.path.join(self.spool_dir, ADMIN_STATE_FILE))
        except OSError:
            pass
        try:
            # last worker out removes the spool the CLI mkdtemp'd;
            # rmdir (not rmtree) so a still-registered sibling keeps it
            os.rmdir(self.spool_dir)
        except OSError:
            pass
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
