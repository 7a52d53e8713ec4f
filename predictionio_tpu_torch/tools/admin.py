"""Admin REST API on :7071 (a copy of the JAX package's ``tools/admin.py``).

Parity: tools/src/main/scala/.../tools/admin/{AdminAPI.scala:39-161,
CommandClient.scala} — experimental app administration over REST:

- ``GET  /``                     health check ``{"status": "alive"}``
- ``GET  /cmd/app``              list apps
- ``POST /cmd/app``              create app (body: {"name", "id"?, "description"?})
- ``DELETE /cmd/app/{name}``     delete app (keys, channels, events, row)
- ``DELETE /cmd/app/{name}/data`` wipe the app's event data
"""

from __future__ import annotations

import json
import logging
import re
from http.server import BaseHTTPRequestHandler
from typing import Any

from predictionio_tpu_torch.api.http_base import RestServer
from predictionio_tpu_torch.storage.base import AccessKey, App
from predictionio_tpu_torch.storage.registry import Storage

logger = logging.getLogger(__name__)

_APP_RE = re.compile(r"^/cmd/app/([^/]+)$")
_APP_DATA_RE = re.compile(r"^/cmd/app/([^/]+)/data$")


class CommandClient:
    """DAO-backed admin commands. Parity: CommandClient.scala
    (futureAppNew/futureAppList/futureAppDelete/futureAppDataDelete)."""

    def __init__(self, storage: Storage):
        self.storage = storage
        self.apps = storage.get_meta_data_apps()
        self.keys = storage.get_meta_data_access_keys()
        self.channels = storage.get_meta_data_channels()
        self.events = storage.get_events()

    def app_list(self) -> list[dict[str, Any]]:
        out = []
        for app in self.apps.get_all():
            app_keys = self.keys.get_by_app_id(app.id)
            out.append({
                "name": app.name,
                "id": app.id,
                "accessKeys": [k.key for k in app_keys],
            })
        return out

    def app_new(self, name: str, app_id: int = 0, description: str | None = None) -> dict:
        if self.apps.get_by_name(name) is not None:
            raise ValueError(f"App {name} already exists.")
        new_id = self.apps.insert(App(app_id, name, description))
        if new_id is None:
            raise ValueError(f"App {name} could not be created.")
        self.events.init(new_id)
        key = self.keys.insert(AccessKey("", new_id, ()))
        return {"name": name, "id": new_id, "accessKey": key}

    def app_delete(self, name: str) -> None:
        app = self.apps.get_by_name(name)
        if app is None:
            raise KeyError(f"App {name} does not exist.")
        for c in self.channels.get_by_app_id(app.id):
            self.events.remove(app.id, c.id)
            self.channels.delete(c.id)
        self.events.remove(app.id)
        for k in self.keys.get_by_app_id(app.id):
            self.keys.delete(k.key)
        self.apps.delete(app.id)

    def app_data_delete(self, name: str) -> None:
        app = self.apps.get_by_name(name)
        if app is None:
            raise KeyError(f"App {name} does not exist.")
        self.events.remove(app.id)
        self.events.init(app.id)


class AdminService:
    def __init__(self, storage: Storage | None = None):
        self.client = CommandClient(storage or Storage.default())

    def handle(self, method: str, path: str, body: Any) -> tuple[int, Any]:
        try:
            if method == "GET" and path == "/":
                return (200, {"status": "alive"})
            if method == "GET" and path == "/cmd/app":
                return (200, {"apps": self.client.app_list()})
            if method == "POST" and path == "/cmd/app":
                if not isinstance(body, dict) or not body.get("name"):
                    return (400, {"message": "body must be JSON with a 'name'"})
                created = self.client.app_new(
                    body["name"], int(body.get("id") or 0), body.get("description")
                )
                return (201, created)
            m = _APP_DATA_RE.match(path)
            if m and method == "DELETE":
                self.client.app_data_delete(m.group(1))
                return (200, {"message": f"Data of app {m.group(1)} deleted."})
            m = _APP_RE.match(path)
            if m and method == "DELETE":
                self.client.app_delete(m.group(1))
                return (200, {"message": f"App {m.group(1)} deleted."})
            return (404, {"message": f"no route for {method} {path}"})
        except ValueError as e:
            return (409, {"message": str(e)})
        except KeyError as e:
            return (404, {"message": str(e).strip("'\"")})


class _Handler(BaseHTTPRequestHandler):
    service: AdminService

    def _dispatch(self, method: str) -> None:
        body = None
        if method == "POST":
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b""
            if raw:
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError:
                    self._respond(400, {"message": "invalid JSON body"})
                    return
        status, payload = self.service.handle(method, self.path.split("?")[0], body)
        self._respond(status, payload)

    def _respond(self, status: int, payload: Any) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=UTF-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802
        self._dispatch("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self) -> None:  # noqa: N802
        self._dispatch("DELETE")

    def log_message(self, format: str, *args) -> None:
        logger.debug("%s - %s", self.address_string(), format % args)


class AdminServer(RestServer):
    """Parity: AdminServer.createAdminServer (AdminAPI.scala:137-154)."""

    log_label = "Admin API"
    thread_name = "pio-adminserver"

    def __init__(self, storage: Storage | None = None, ip: str = "0.0.0.0",
                 port: int = 7071):
        super().__init__(_Handler, AdminService(storage), ip, port)
