"""Elasticsearch-role storage backend: metadata + events over a REST
JSON document-store protocol (a copy of the JAX package's
``storage/elasticsearch.py``).

Parity: storage/elasticsearch/src/main/scala/.../elasticsearch/
{StorageClient.scala:27-43, ESApps, ESAccessKeys, ESChannels,
ESEngineInstances, ESEvaluationInstances, ESSequences, ESLEvents,
ESUtils} — the reference's ES 5.x REST backend. The client speaks the
same document-CRUD subset of the ES REST API over stdlib HTTP:

- ``PUT /{index}/{type}/{id}`` index a doc (response carries ``_version``),
- ``GET /{index}/{type}/{id}`` → ``{found, _source, _version}``,
- ``DELETE /{index}/{type}/{id}`` → ``{found}``,
- ``POST /{index}/{type}/_search`` with ``match_all`` (+ ``from``/``size``
  paging) → ``{hits: {hits: [{_id, _source}]}}``,
- ``DELETE /{index}`` drop an index.

Like the reference, sequences (auto-increment ids for apps/channels) are
implemented by re-indexing a trivial doc and reading back ``_version``
(ESSequences.genNext), and one index serves each purpose:
``<INDEX>_meta`` for the five metadata types and
``<INDEX>_events_<app>[_<ch>]`` per app/channel (ESUtils table naming).
Query-side filtering richer than match_all is applied client-side on the
scrolled pages — the conformance semantics match every other backend.

Config properties: ``HOSTS`` (comma list, default ``localhost``),
``PORTS`` (default ``9200``), ``SCHEMES`` (default ``http``), ``INDEX``
(prefix, default ``pio``), ``USERNAME``/``PASSWORD`` (basic auth), plus
the ``RETRY_*``/``BREAKER_*`` resilience knobs
(docs/operations-resilience.md). Every HTTP round trip routes through
``resilient()``: connection errors and 5xx responses retry with jittered
backoff and feed the per-source circuit breaker; non-transient HTTP
errors (4xx) surface unchanged as :class:`ESError`.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import threading
import urllib.error
import urllib.request
import uuid
from datetime import datetime
from typing import Any, Iterator, Sequence

from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.core.json_codec import event_from_json, event_to_json
from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    EventFilter,
    StorageClientConfig,
)
from predictionio_tpu_torch.utils.resilience import (
    Resilience,
    TransientError,
    is_transient_http_status,
    resilient,
)


class ESError(RuntimeError):
    pass


class ESClient:
    """Minimal ES REST client over stdlib HTTP (one base URL, basic auth)."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 9200,
        scheme: str = "http",
        username: str = "",
        password: str = "",
        timeout: float = 10.0,
        resilience: Resilience | None = None,
    ):
        self._base = f"{scheme}://{host}:{port}"
        self._timeout = timeout
        self._headers = {"Content-Type": "application/json"}
        if username:
            token = base64.b64encode(f"{username}:{password}".encode()).decode()
            self._headers["Authorization"] = f"Basic {token}"
        self._resilience = resilience or Resilience("elasticsearch")

    def request(self, method: str, path: str, body: Any = None) -> dict | None:
        return resilient(self._resilience, self._raw_request, method, path, body)

    def _raw_request(self, method: str, path: str, body: Any = None) -> dict | None:
        """One HTTP round trip. Only reachable through ``resilient()``:
        transport failures and 5xx raise TransientError (retried under
        the policy), 4xx raise ESError (application errors, no retry)."""
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self._base + path, data=data, method=method, headers=self._headers
        )
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return None
            if is_transient_http_status(exc.code):
                raise TransientError(
                    f"{method} {path}: HTTP {exc.code}") from exc
            raise ESError(f"{method} {path}: HTTP {exc.code}") from exc
        except urllib.error.URLError as exc:
            # connection refused / DNS / timeout: the retryable class
            raise TransientError(f"{method} {path}: {exc.reason}") from exc
        return json.loads(payload) if payload else {}

    # -- document ops -------------------------------------------------------
    def index_doc(self, index: str, type_: str, doc_id: str, doc: dict) -> dict:
        out = self.request("PUT", f"/{index}/{type_}/{doc_id}", doc)
        if out is None:
            raise ESError(f"index {index}/{type_}/{doc_id} failed")
        return out

    def get_doc(self, index: str, type_: str, doc_id: str) -> dict | None:
        out = self.request("GET", f"/{index}/{type_}/{doc_id}")
        if out is None or not out.get("found"):
            return None
        return out.get("_source")

    def delete_doc(self, index: str, type_: str, doc_id: str) -> bool:
        out = self.request("DELETE", f"/{index}/{type_}/{doc_id}")
        return bool(out and out.get("found"))

    def search_all(self, index: str, type_: str, page: int = 1000) -> Iterator[tuple[str, dict]]:
        """match_all scan with from/size paging (ESUtils.getAll scroll)."""
        start = 0
        while True:
            out = self.request(
                "POST",
                f"/{index}/{type_}/_search",
                {"query": {"match_all": {}}, "from": start, "size": page},
            )
            hits = (out or {}).get("hits", {}).get("hits", [])
            for h in hits:
                yield h["_id"], h["_source"]
            if len(hits) < page:
                return
            start += page

    def delete_index(self, index: str) -> bool:
        out = self.request("DELETE", f"/{index}")
        return out is not None


class ESSequences:
    """Auto-increment ids via doc re-index ``_version`` (ESSequences.genNext)."""

    def __init__(self, client: ESClient, index: str):
        self._client = client
        self._index = index
        self._lock = threading.Lock()

    def gen_next(self, name: str) -> int:
        with self._lock:
            out = self._client.index_doc(self._index, "sequences", name, {"n": 1})
            version = out.get("_version")
            if version is None:
                raise ESError(f"sequence {name}: no _version in response")
            return int(version)


# ---------------------------------------------------------------------------
# doc codecs (datetimes ↔ ISO strings)
# ---------------------------------------------------------------------------

def _to_doc(obj: Any) -> dict:
    def conv(v: Any) -> Any:
        if isinstance(v, datetime):
            return v.isoformat()
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v

    return {f.name: conv(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _from_doc(cls: type, doc: dict) -> Any:
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in doc:
            continue
        v = doc[f.name]
        if f.name in ("start_time", "completion_time") and isinstance(v, str):
            v = datetime.fromisoformat(v)
        if f.name == "events" and isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# metadata DAOs
# ---------------------------------------------------------------------------

class ESApps(base.Apps):
    def __init__(self, client: ESClient, index: str, seq: ESSequences):
        self._c, self._index, self._seq = client, index, seq

    def insert(self, app: App) -> int | None:
        if self.get_by_name(app.name) is not None:
            return None
        app_id = app.id or self._seq.gen_next("apps")
        if app.id and self.get(app.id) is not None:
            return None
        self._c.index_doc(self._index, "apps", str(app_id),
                          _to_doc(dataclasses.replace(app, id=app_id)))
        return app_id

    def get(self, app_id: int) -> App | None:
        doc = self._c.get_doc(self._index, "apps", str(app_id))
        return _from_doc(App, doc) if doc else None

    def get_by_name(self, name: str) -> App | None:
        return next((a for a in self.get_all() if a.name == name), None)

    def get_all(self) -> list[App]:
        return [_from_doc(App, d) for _, d in self._c.search_all(self._index, "apps")]

    def update(self, app: App) -> None:
        self._c.index_doc(self._index, "apps", str(app.id), _to_doc(app))

    def delete(self, app_id: int) -> None:
        self._c.delete_doc(self._index, "apps", str(app_id))


class ESAccessKeys(base.AccessKeys):
    def __init__(self, client: ESClient, index: str):
        self._c, self._index = client, index

    def insert(self, access_key: AccessKey) -> str | None:
        key = access_key.key or self.generate_key()
        if self.get(key) is not None:
            return None
        self._c.index_doc(self._index, "accesskeys", key,
                          _to_doc(dataclasses.replace(access_key, key=key)))
        return key

    def get(self, key: str) -> AccessKey | None:
        doc = self._c.get_doc(self._index, "accesskeys", key)
        return _from_doc(AccessKey, doc) if doc else None

    def get_all(self) -> list[AccessKey]:
        return [_from_doc(AccessKey, d)
                for _, d in self._c.search_all(self._index, "accesskeys")]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [k for k in self.get_all() if k.appid == app_id]

    def update(self, access_key: AccessKey) -> None:
        self._c.index_doc(self._index, "accesskeys", access_key.key,
                          _to_doc(access_key))

    def delete(self, key: str) -> None:
        self._c.delete_doc(self._index, "accesskeys", key)


class ESChannels(base.Channels):
    def __init__(self, client: ESClient, index: str, seq: ESSequences):
        self._c, self._index, self._seq = client, index, seq

    def insert(self, channel: Channel) -> int | None:
        if not Channel.is_valid_name(channel.name):
            return None
        channel_id = channel.id or self._seq.gen_next("channels")
        self._c.index_doc(self._index, "channels", str(channel_id),
                          _to_doc(dataclasses.replace(channel, id=channel_id)))
        return channel_id

    def get(self, channel_id: int) -> Channel | None:
        doc = self._c.get_doc(self._index, "channels", str(channel_id))
        return _from_doc(Channel, doc) if doc else None

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [c for c in
                (_from_doc(Channel, d)
                 for _, d in self._c.search_all(self._index, "channels"))
                if c.appid == app_id]

    def delete(self, channel_id: int) -> None:
        self._c.delete_doc(self._index, "channels", str(channel_id))


class ESEngineInstances(base.EngineInstances):
    def __init__(self, client: ESClient, index: str):
        self._c, self._index = client, index

    def insert(self, instance: EngineInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        self._c.index_doc(self._index, "engine_instances", instance_id,
                          _to_doc(dataclasses.replace(instance, id=instance_id)))
        return instance_id

    def get(self, instance_id: str) -> EngineInstance | None:
        doc = self._c.get_doc(self._index, "engine_instances", instance_id)
        return _from_doc(EngineInstance, doc) if doc else None

    def get_all(self) -> list[EngineInstance]:
        return [_from_doc(EngineInstance, d)
                for _, d in self._c.search_all(self._index, "engine_instances")]

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        hits = [
            i for i in self.get_all()
            if i.status == "COMPLETED"
            and i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        hits.sort(key=lambda i: i.start_time, reverse=True)
        return hits

    def update(self, instance: EngineInstance) -> None:
        self._c.index_doc(self._index, "engine_instances", instance.id,
                          _to_doc(instance))

    def delete(self, instance_id: str) -> None:
        self._c.delete_doc(self._index, "engine_instances", instance_id)


class ESEvaluationInstances(base.EvaluationInstances):
    def __init__(self, client: ESClient, index: str):
        self._c, self._index = client, index

    def insert(self, instance: EvaluationInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        self._c.index_doc(self._index, "evaluation_instances", instance_id,
                          _to_doc(dataclasses.replace(instance, id=instance_id)))
        return instance_id

    def get(self, instance_id: str) -> EvaluationInstance | None:
        doc = self._c.get_doc(self._index, "evaluation_instances", instance_id)
        return _from_doc(EvaluationInstance, doc) if doc else None

    def get_all(self) -> list[EvaluationInstance]:
        return [_from_doc(EvaluationInstance, d)
                for _, d in self._c.search_all(self._index, "evaluation_instances")]

    def get_completed(self) -> list[EvaluationInstance]:
        hits = [i for i in self.get_all() if i.status == "EVALCOMPLETED"]
        hits.sort(key=lambda i: i.start_time, reverse=True)
        return hits

    def update(self, instance: EvaluationInstance) -> None:
        self._c.index_doc(self._index, "evaluation_instances", instance.id,
                          _to_doc(instance))

    def delete(self, instance_id: str) -> None:
        self._c.delete_doc(self._index, "evaluation_instances", instance_id)


# ---------------------------------------------------------------------------
# events DAO
# ---------------------------------------------------------------------------

class ESEvents(base.Events):
    """Per-app/channel event index (ESLEvents; index naming per ESUtils)."""

    def __init__(self, client: ESClient, index_prefix: str):
        self._c = client
        self._prefix = index_prefix

    def _index(self, app_id: int, channel_id: int | None) -> str:
        suffix = f"_{channel_id}" if channel_id is not None else ""
        return f"{self._prefix}_events_{app_id}{suffix}"

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        # indices are created implicitly on first doc; touch with a probe
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        return self._c.delete_index(self._index(app_id, channel_id))

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        event_id = event.event_id or uuid.uuid4().hex
        event = event.with_event_id(event_id)
        self._c.index_doc(self._index(app_id, channel_id), "events", event_id,
                          event_to_json(event))
        return event_id

    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        doc = self._c.get_doc(self._index(app_id, channel_id), "events", event_id)
        return event_from_json(doc, validate=False) if doc else None

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        return self._c.delete_doc(self._index(app_id, channel_id), "events", event_id)

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter = EventFilter(),
    ) -> Iterator[Event]:
        events = [
            e
            for _, d in self._c.search_all(self._index(app_id, channel_id), "events")
            if filter.matches(e := event_from_json(d, validate=False))
        ]
        events.sort(key=lambda e: (e.event_time, e.event_id or ""),
                    reverse=filter.reversed)
        if filter.limit is not None and filter.limit >= 0:
            events = events[: filter.limit]
        return iter(events)


class ESStorageClient(base.BaseStorageClient):
    prefix = "ES"

    def __init__(self, config: StorageClientConfig = StorageClientConfig()):
        super().__init__(config)
        props = config.properties
        host = props.get("HOSTS", "localhost").split(",")[0]
        port = int(props.get("PORTS", "9200").split(",")[0])
        scheme = props.get("SCHEMES", "http").split(",")[0]
        source = props.get("SOURCE_NAME", f"{host}:{port}")
        self._client = ESClient(
            host=host,
            port=port,
            scheme=scheme,
            username=props.get("USERNAME", ""),
            password=props.get("PASSWORD", ""),
            resilience=Resilience.from_properties(
                f"elasticsearch/{source}", props),
        )
        prefix = props.get("INDEX", "pio")
        meta = f"{prefix}_meta"
        self._seq = ESSequences(self._client, meta)
        self._apps = ESApps(self._client, meta, self._seq)
        self._access_keys = ESAccessKeys(self._client, meta)
        self._channels = ESChannels(self._client, meta, self._seq)
        self._engine_instances = ESEngineInstances(self._client, meta)
        self._evaluation_instances = ESEvaluationInstances(self._client, meta)
        self._events = ESEvents(self._client, prefix)

    def events(self) -> ESEvents:
        return self._events

    def apps(self) -> ESApps:
        return self._apps

    def access_keys(self) -> ESAccessKeys:
        return self._access_keys

    def channels(self) -> ESChannels:
        return self._channels

    def engine_instances(self) -> ESEngineInstances:
        return self._engine_instances

    def evaluation_instances(self) -> ESEvaluationInstances:
        return self._evaluation_instances

    def models(self) -> base.Models:
        raise NotImplementedError(
            "elasticsearch source serves metadata/event data; bind MODELDATA "
            "to localfs/hdfs/s3 (the reference's ES backend likewise has no "
            "Models DAO)"
        )
