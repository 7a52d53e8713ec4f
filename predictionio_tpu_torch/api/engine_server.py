"""Engine server: the REST face of a deployed engine (port of the query
path of the JAX package's ``api/engine_server.py``, without its cache,
batcher or plugins).

Routes:

- ``POST /queries.json``: bind the JSON body to the engine's query
  class → ``DeployedEngine.query`` → the prediction as camelCase JSON
  (``{"itemScores": [{"item": ..., "score": ...}]}`` for sessionrec and
  recommendation);
- ``GET /``: status: the engine instance id and the flash-attention
  kernel's launch count in this process;
- ``GET /healthz``.

Queries are answered one at a time (one device, and a launch count that
must add up): the HTTP threads overlap parsing and encoding only.

The server deploys a stored engine instance (``pio deploy``,
``workflow/deploy.load_deployed_engine``) or a model directory: ``python
-m predictionio_tpu_torch.api.engine_server --model-dir D --port P
[--device cpu] [--engine-factory F]`` (default: the sessionrec
template).
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from predictionio_tpu_torch.core.wire import from_wire, to_wire
from predictionio_tpu_torch.ops import flash_attention as flash_ops
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.workflow.deploy import (
    DEFAULT_ENGINE_FACTORY,
    DeployedEngine,
    ServerConfig,
    load_deployed_engine,
)

logger = logging.getLogger(__name__)


class _Reject(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class EngineServer:
    def __init__(self, deployed: DeployedEngine, config: ServerConfig):
        self.deployed = deployed
        self.config = config
        self._predict_lock = threading.Lock()
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    def status_doc(self) -> dict[str, Any]:
        d = self.deployed
        return {
            "status": "alive",
            "engineInstanceId": d.instance_id,
            "engineFactory": (d.instance.engine_factory if d.instance is not None
                              else self.config.engine_factory),
            "device": str(d.device),
            "startTime": d.start_time,
            "requestCount": d.request_count,
            "avgServingSec": d.avg_serving_sec,
            "lastServingSec": d.last_serving_sec,
            "kernelLaunches": {"flash_attention": flash_ops.LAUNCHES},
        }

    def handle_query(self, body: Any) -> dict[str, Any]:
        if not isinstance(body, dict):
            raise _Reject(400, "the request body must be a JSON object")
        qc = self.deployed.query_class
        try:
            query = from_wire(qc, body) if qc is not None else body
        except (ValueError, TypeError) as e:
            raise _Reject(400, f"invalid query: {e}")
        try:
            with self._predict_lock:
                prediction = self.deployed.query(query)
        except Exception as e:
            logger.exception("query failed")
            raise _Reject(500, f"query failed: {e}")
        response = to_wire(prediction)
        return response if isinstance(response, dict) else {"result": response}

    def _handler(self) -> type[BaseHTTPRequestHandler]:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, status: int, doc: Any) -> None:
                data = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/":
                    self._send(200, server.status_doc())
                elif path == "/healthz":
                    self._send(200, {"status": "ok"})
                else:
                    self._send(404, {"message": f"no route {path}"})

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                if path != "/queries.json":
                    self._send(404, {"message": f"no route {path}"})
                    return
                try:
                    try:
                        body = json.loads(raw or b"null")
                    except ValueError as e:
                        raise _Reject(400, f"invalid JSON: {e}")
                    self._send(200, server.handle_query(body))
                except _Reject as r:
                    self._send(r.status, {"message": str(r)})

            def log_message(self, fmt, *args):
                logger.debug("%s - %s", self.address_string(), fmt % args)

        return Handler

    def start(self) -> "EngineServer":
        if self._httpd is not None:
            raise RuntimeError("server already started")
        self._httpd = ThreadingHTTPServer((self.config.ip, self.config.port), self._handler())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="engine-server", daemon=True)
        self._thread.start()
        logger.info("engine server on %s:%d", self.config.ip, self.port)
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)
        self._httpd = None
        self._thread = None


def create_engine_server(storage: Storage | None = None,
                         config: ServerConfig | None = None) -> EngineServer:
    """Load the engine instance (or model directory) ``config`` names
    onto its device (``workflow/deploy.load_deployed_engine``) and wrap
    it in a server; call ``start()`` to listen."""
    config = config if config is not None else ServerConfig()
    return EngineServer(load_deployed_engine(storage, config), config)


def serve_until_stopped(server: EngineServer) -> None:
    """Block a started server's process until SIGTERM or Ctrl-C, then
    stop the server."""
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


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
