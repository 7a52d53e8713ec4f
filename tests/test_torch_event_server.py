"""The port's event server beside the JAX package's, on the CPU (lanes:
tests/test_event_server.py, the ride-through cases of
tests/test_wal_durability.py, and the feedback loop of
tests/test_engine_server.py).

Side by side, through the transport-free ``EventService.handle`` on
memory stores seeded alike: every route and refusal gives JAX's status
and body (ids the server draws and timestamps aside), including the
per-event batch statuses, the fallback after a partial batch failure and
the WAL ride-through under a failing DAO spy. Over HTTP, on the port:
one ``insert_batch`` per batch, no loss under 8 concurrent clients into
sqlite, ``PIO_EVENTSERVER_MAX_BATCH`` read at construction, stats on and
off, an input blocker, both webhooks, the ride-through and write-through
statuses, ``pio eventserver`` importing no torch, and the engine
server's ``--feedback`` post, whose body equals JAX's at a stub event
server.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import subprocess
import sys
import threading
import time
import urllib.parse
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from predictionio_tpu.api import engine_server as jengine
from predictionio_tpu.api import event_server as jes
from predictionio_tpu.api import plugins as jplugins
from predictionio_tpu.controller import FirstServing as JaxFirstServing
from predictionio_tpu.models import als as jmodels
from predictionio_tpu.storage.base import AccessKey as JaxAccessKey
from predictionio_tpu.storage.base import App as JaxApp
from predictionio_tpu.storage.base import Channel as JaxChannel
from predictionio_tpu.storage.base import EngineInstance as JaxEngineInstance
from predictionio_tpu.templates import recommendation as jrec
from predictionio_tpu.utils import resilience as jresilience
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu.utils.bimap import EntityIdIxMap as JaxEntityIdIxMap
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow.deploy import DeployedEngine as JaxDeployedEngine
from predictionio_tpu.workflow.deploy import ServerConfig as JaxServerConfig
from predictionio_tpu_torch.api import engine_server as pengine
from predictionio_tpu_torch.api import event_server as pes
from predictionio_tpu_torch.api import plugins as pplugins
from predictionio_tpu_torch.controller import PersistentModelManifest
from predictionio_tpu_torch.models import als as pmodels
from predictionio_tpu_torch.storage.base import AccessKey, App, Channel, EngineInstance
from predictionio_tpu_torch.storage.registry import Storage, memory_storage
from predictionio_tpu_torch.utils import resilience
from predictionio_tpu_torch.workflow.deploy import ServerConfig
from predictionio_tpu_torch.workflow.persistence import save_models

REPO = Path(__file__).resolve().parent.parent
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
KEY, WL_KEY = "testkey", "whitelist-key"


@pytest.fixture(autouse=True)
def _fresh_registries():
    resilience.reset_registry()
    jresilience.reset_registry()
    yield
    resilience.reset_registry()
    jresilience.reset_registry()


# -- the two services --------------------------------------------------------

def _seed(storage, app_cls, key_cls, channel_cls) -> int:
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "testapp"))
    storage.get_meta_data_access_keys().insert(key_cls(KEY, app_id, ()))
    storage.get_meta_data_access_keys().insert(key_cls(WL_KEY, app_id, ("rate",)))
    channel_id = storage.get_meta_data_channels().insert(channel_cls(0, "mychan", app_id))
    storage.get_events().init(app_id)
    storage.get_events().init(app_id, channel_id)
    return app_id


def _blocker(base, plugin_type):
    class BlockSpam(base):
        plugin_name = "block-spam"
        plugin_description = "rejects spam events"

        def process(self, info, context):
            if info.event.event == "spam":
                raise ValueError("spam is blocked")

    p = BlockSpam()
    p.plugin_type = plugin_type
    return p


def _jax_service(tmp_path=None, blocker=False, **config):
    storage = jax_memory_storage()
    _seed(storage, JaxApp, JaxAccessKey, JaxChannel)
    if config.get("wal_dir"):
        config["wal_dir"] = str(tmp_path / "jax-wal")
    plugins = jplugins.EventServerPluginContext(
        [_blocker(jplugins.EventServerPlugin, jplugins.INPUT_BLOCKER)] if blocker else [])
    return jes.EventService(storage, jes.EventServerConfig(**config), plugins)


def _port_service(tmp_path=None, blocker=False, storage=None, **config):
    if storage is None:
        storage = memory_storage()
        _seed(storage, App, AccessKey, Channel)
    if config.get("wal_dir"):
        config["wal_dir"] = str(tmp_path / "port-wal")
    plugins = pplugins.EventServerPluginContext(
        [_blocker(pplugins.EventServerPlugin, pplugins.INPUT_BLOCKER)] if blocker else [])
    return pes.EventService(storage, pes.EventServerConfig(**config), plugins)


@pytest.fixture
def services(request, tmp_path):
    config = getattr(request, "param", {"stats": True})
    jax_svc, port_svc = _jax_service(tmp_path, **config), _port_service(tmp_path, **config)
    yield jax_svc, port_svc
    jax_svc.close()
    port_svc.close()


_TIMES = ("eventTime", "creationTime", "time", "startTime", "endTime")


def _norm(body):
    """A body with the values the server draws (ids it assigned, times
    of now, rates and latencies) replaced or dropped, so two servers'
    bodies compare. Client-chosen ids start with "fixed" and stay."""
    if isinstance(body, list):
        return [_norm(b) for b in body]
    if not isinstance(body, dict):
        return body
    out = {}
    for k, v in body.items():
        if k == "eventId" and isinstance(v, str) and not v.startswith("fixed"):
            out[k] = "<id>"
        elif k in _TIMES and v is not None:
            out[k] = "<time>"
        elif k == "ingest":
            out[k] = {kk: vv for kk, vv in v.items()
                      if kk not in ("insertLatency", "eventsPerSecEwma",
                                    "eventsPerSecWindowed", "windowSeconds")}
        else:
            out[k] = _norm(v)
    return out


def both(services, method, path, params=None, headers=None, body=None):
    """(status, body) from each service; asserts they agree and returns
    the port's."""
    (js, jb, *jh), (ps, pb, *ph) = (
        svc.handle(method, path, dict(params or {}), dict(headers or {}), body)
        for svc in services)
    assert ps == js, (method, path, params, body, pb, jb)
    assert _norm(pb) == _norm(jb), (method, path, params, body)
    assert bool(jh) == bool(ph), (jh, ph)
    if jh:
        assert set(jh[0]) == set(ph[0])
    return ps, pb


def _ev(name="rate", entity="u1", minutes=0, target="i1", **extra):
    doc = {"event": name, "entityType": "user", "entityId": entity,
           "eventTime": f"2026-01-01T00:{minutes:02d}:00.000Z", **extra}
    if target is not None:
        doc.update(targetEntityType="item", targetEntityId=target)
    return doc


K = {"accessKey": KEY}
BASIC = {"Authorization": "Basic " + base64.b64encode(f"{KEY}:".encode()).decode()}


# -- every route and refusal, side by side ----------------------------------

class TestRoutesSideBySide:
    @pytest.mark.parametrize("path", ["/", "/healthz", "/readyz", "/plugins.json", "/nope"])
    def test_public_routes(self, services, path):
        both(services, "GET", path)

    @pytest.mark.parametrize("params, headers, body", [
        ({}, {}, _ev()),                                          # missing key
        ({"accessKey": "wrong"}, {}, _ev()),                      # bad key
        ({}, {"Authorization": "Basic !!!"}, _ev()),              # undecodable Basic
        ({}, BASIC, _ev(eventId="fixed-basic")),                  # Basic user part
        (K, {}, _ev(eventId="fixed-1", properties={"rating": 5})),
        (K, {}, _ev()),                                           # id drawn by the server
        (K, {}, {"event": "rate", "entityType": "user"}),         # no entityId
        (K, {}, ["not", "an", "object"]),
        (K, {}, _ev(name="$unset", target=None)),                 # $unset without properties
        (K, {}, _ev(eventTime="yesterday")),
        ({"accessKey": WL_KEY}, {}, _ev(name="buy")),             # whitelist: 403
        ({"accessKey": WL_KEY}, {}, _ev(eventId="fixed-wl")),
        ({**K, "channel": "mychan"}, {}, _ev(eventId="fixed-ch")),
        ({**K, "channel": "nochan"}, {}, _ev()),                  # unknown channel: 401
    ])
    def test_post_event(self, services, params, headers, body):
        both(services, "POST", "/events.json", params, headers, body)

    def test_get_and_delete_by_id(self, services):
        both(services, "POST", "/events.json", K, {}, _ev(eventId="fixed-g"))
        both(services, "POST", "/events.json", {**K, "channel": "mychan"}, {},
             _ev(eventId="fixed-c"))
        assert both(services, "GET", "/events/fixed-g.json", K)[0] == 200
        assert both(services, "GET", "/events/fixed-c.json", K)[0] == 404
        assert both(services, "GET", "/events/fixed-c.json", {**K, "channel": "mychan"})[0] == 200
        assert both(services, "GET", "/events/fixed-g.json", {"accessKey": "bad"})[0] == 401
        assert both(services, "DELETE", "/events/fixed-g.json", K) == (200, {"message": "Found"})
        assert both(services, "DELETE", "/events/fixed-g.json", K)[0] == 404
        assert both(services, "GET", "/events/fixed-g.json", K)[0] == 404
        assert both(services, "PUT", "/events/fixed-g.json", K)[0] == 404

    @pytest.mark.parametrize("query", [
        {}, {"limit": "3"}, {"limit": "-1"}, {"limit": "abc"}, {"event": "buy"},
        {"entityType": "user", "entityId": "u2"},
        {"entityType": "user", "entityId": "u2", "reversed": "true", "limit": "2"},
        {"reversed": "true"}, {"startTime": "2026-01-01T00:03:00.000Z",
                               "untilTime": "2026-01-01T00:07:00.000Z"},
        {"startTime": "not-a-time"}, {"targetEntityType": "item"},
        {"targetEntityId": "i3"}, {"entityId": "nobody"},
    ])
    def test_get_events_filters(self, services, query):
        for n in range(25):
            both(services, "POST", "/events.json", K, {},
                 _ev(name=("rate", "buy")[n % 2], entity=f"u{n % 3}", minutes=n,
                     target=f"i{n % 4}", eventId=f"fixed-{n:02d}"))
        both(services, "GET", "/events.json", {**K, **query})

    @pytest.mark.parametrize("params, body", [
        (K, [_ev(eventId="fixed-b0"), {"event": "rate"}, _ev(name="buy", eventId="fixed-b2"),
             "not an object", _ev(minutes=3)]),
        ({"accessKey": WL_KEY}, [_ev(eventId="fixed-w0"), _ev(name="buy"),
                                 _ev(eventId="fixed-w2")]),
        (K, {"event": "rate"}),                                   # not an array
        (K, [_ev(minutes=n) for n in range(51)]),                 # over the cap of 50
        (K, [_ev(minutes=n, eventId=f"fixed-{n}") for n in range(50)]),
        (K, []),
        ({"accessKey": "nope"}, [_ev()]),
    ])
    def test_batch(self, services, params, body):
        both(services, "POST", "/batch/events.json", params, {}, body)

    @pytest.mark.parametrize("form, site, body", [
        (False, "segmentio", {"version": "2", "type": "track", "userId": "u9",
                              "event": "Played", "properties": {"song": "x"},
                              "timestamp": "2026-01-01T00:00:00.000Z"}),
        (False, "segmentio", {"version": "2", "type": "identify", "anonymousId": "a1",
                              "traits": {"plan": "pro"}, "context": {"ip": "1.2.3.4"},
                              "sentAt": "2026-01-01T00:00:01.000Z"}),
        (False, "segmentio", {"type": "track", "userId": "u9"}),      # no version: 400
        (False, "segmentio", {"version": "2", "type": "boom", "userId": "u9"}),
        (False, "segmentio", {"version": "2", "type": "track"}),      # no user: 400
        (True, "mailchimp", {"type": "subscribe", "fired_at": "2026-01-01 00:00:00",
                             "data[email]": "a@b.c", "data[id]": "x1"}),
        (True, "mailchimp", {"type": "upemail", "data[new_email]": "n@b.c",
                             "fired_at": "2026-01-01 00:00:02"}),
        (True, "mailchimp", {"type": "nope"}),
        (False, "nosuchsite", {}),
        (True, "segmentio", {}),                                   # JSON site as a form
    ])
    def test_webhooks(self, services, form, site, body):
        path = f"/webhooks/{site}.{'form' if form else 'json'}"
        both(services, "POST", path, K, {}, body)
        both(services, "GET", path, K)
        both(services, "GET", path, {"accessKey": "nope"})

    def test_stats_and_ingest_counters(self, services):
        both(services, "POST", "/batch/events.json", K, {},
             [_ev(minutes=n, eventId=f"fixed-{n}") for n in range(7)])
        both(services, "POST", "/events.json", K, {}, _ev(eventId="fixed-s"))
        both(services, "POST", "/events.json", {"accessKey": WL_KEY}, {}, _ev(name="buy"))
        status, doc = both(services, "GET", "/stats.json", K)
        assert status == 200
        assert doc["ingest"]["events"] == 8 and doc["ingest"]["batchSizeHistogram"] == {
            "1": 1, "7": 1}
        assert both(services, "GET", "/stats.json", {"accessKey": "nope"})[0] == 401

    @pytest.mark.parametrize("services", [{"stats": False}], indirect=True)
    def test_stats_off(self, services):
        assert both(services, "GET", "/stats.json", K) == (404, {
            "message": "To see stats, launch Event Server with --stats argument."})

    def test_blocker_plugin(self, tmp_path):
        services = (_jax_service(blocker=True), _port_service(blocker=True))
        try:
            assert both(services, "GET", "/plugins.json")[1]["plugins"]["inputblockers"][
                "block-spam"]["class"].endswith("BlockSpam")
            assert both(services, "POST", "/events.json", K, {}, _ev(name="spam"))[0] == 403
            _, statuses = both(services, "POST", "/batch/events.json", K, {},
                               [_ev(eventId="fixed-ok"), _ev(name="spam")])
            assert [s["status"] for s in statuses] == [201, 403]
        finally:
            for s in services:
                s.close()


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("steps", [
    [(0.0, 50)] * 3,
    [(0.3, 50), (0.0, 1), (1.2, 7), (0.0000001, 3), (2.5, 50), (61.0, 4), (0.4, 9)],
    [(0.05 * (n % 7), 1 + n % 50) for n in range(200)],
])
def test_ingest_stats_equal_jax(steps):
    """Batch sizes, the events/s EWMA and the windowed rate over one
    sequence of batches on one clock."""
    from predictionio_tpu.api.stats import IngestStats as JaxIngestStats
    from predictionio_tpu_torch.api.stats import IngestStats

    jclock, pclock = _Clock(), _Clock()
    jax_stats, port_stats = JaxIngestStats(clock=jclock), IngestStats(clock=pclock)
    for dt, n in steps:
        jclock.now += dt
        pclock.now += dt
        jax_stats.record_batch(n)
        port_stats.record_batch(n)
    jclock.now += 1.5
    pclock.now += 1.5
    drop = {"insertLatency"}
    assert {k: v for k, v in port_stats.snapshot().items() if k not in drop} == \
        {k: v for k, v in jax_stats.snapshot().items() if k not in drop}


def test_hourly_stats_equal_jax():
    from predictionio_tpu.api.stats import StatsKeeper as JaxStatsKeeper
    from predictionio_tpu.core.json_codec import event_from_json as jax_event_from_json
    from predictionio_tpu_torch.api.stats import StatsKeeper
    from predictionio_tpu_torch.core.json_codec import event_from_json

    jax_keeper, port_keeper = JaxStatsKeeper(), StatsKeeper()
    for n, status in enumerate([201, 201, 202, 201, 400, 201]):
        doc = _ev(name=("rate", "buy")[n % 2], target=None if n == 3 else "i1")
        jax_keeper.update(1 + n % 2, status, jax_event_from_json(doc))
        port_keeper.update(1 + n % 2, status, event_from_json(doc))
    for app_id in (1, 2, 3):
        assert _norm(port_keeper.get(app_id)) == _norm(jax_keeper.get(app_id))


# -- batch failures and the ride-through, side by side ----------------------

class _Spy:
    """Wraps one service's event DAO: counts calls, and can make
    ``insert_batch`` commit a prefix and then fail, or fail as a storage
    outage, or make ``insert`` fail as an outage after ``insert_ok``."""

    def __init__(self, svc, outage_cls, batch_mode=None, insert_ok=None):
        self.svc, self.outage_cls = svc, outage_cls
        self.real_batch, self.real_insert = svc.events.insert_batch, svc.events.insert
        self.calls = {"insert_batch": 0, "insert": 0}
        self.batch_mode, self.insert_ok = batch_mode, insert_ok
        svc.events.insert_batch, svc.events.insert = self.insert_batch, self.insert

    def insert_batch(self, events, app_id, channel_id=None):
        self.calls["insert_batch"] += 1
        if self.batch_mode == "prefix":
            self.real_batch(list(events)[:1], app_id, channel_id)
            raise RuntimeError("backend failed mid-batch")
        if self.batch_mode == "outage":
            raise self.outage_cls("spy", "backend down")
        return self.real_batch(events, app_id, channel_id)

    def insert(self, event, app_id, channel_id=None):
        self.calls["insert"] += 1
        if self.insert_ok is not None and self.calls["insert"] > self.insert_ok:
            raise self.outage_cls("spy", "backend down")
        return self.real_insert(event, app_id, channel_id)

    def lift(self):
        self.svc.events.insert_batch, self.svc.events.insert = self.real_batch, self.real_insert


def _spies(services, **kw):
    return (_Spy(services[0], jresilience.StorageUnavailableError, **kw),
            _Spy(services[1], resilience.StorageUnavailableError, **kw))


def _stored_ids(svc, app_id=1):
    return sorted(e.event_id for e in svc.events.find(app_id))


def _drained(svc, want: int, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if svc.wal.pending_records() == 0 and len(_stored_ids(svc)) >= want:
            return True
        time.sleep(0.02)
    return False


MIXED = [_ev(eventId="fixed-m0"), {"event": "rate"}, _ev(name="buy", eventId="fixed-m2"),
         _ev(eventId="fixed-m3")]


class TestFailuresSideBySide:
    def test_one_insert_batch_per_batch(self, services):
        spies = _spies(services)
        both(services, "POST", "/batch/events.json", K, {}, MIXED)
        for spy in spies:
            assert spy.calls == {"insert_batch": 1, "insert": 0}

    def test_partial_failure_falls_back_per_event_idempotently(self, services):
        spies = _spies(services, batch_mode="prefix")
        _, statuses = both(services, "POST", "/batch/events.json", K, {},
                           [_ev(minutes=n) for n in range(3)])
        assert [s["status"] for s in statuses] == [201, 201, 201]
        for spy, svc in zip(spies, services):
            assert spy.calls == {"insert_batch": 1, "insert": 3}
        # the prefix landed twice under one id: one copy of each event
        assert _stored_ids(services[1]) == sorted(s["eventId"] for s in statuses)

    def test_outage_without_wal_is_503_per_event(self, services):
        _spies(services, batch_mode="outage", insert_ok=0)
        _, statuses = both(services, "POST", "/batch/events.json", K, {}, MIXED)
        assert [s["status"] for s in statuses] == [503, 400, 503, 503]
        status, _ = both(services, "POST", "/events.json", K, {}, _ev())
        assert status == 503

    @pytest.mark.parametrize("services", [{"stats": True, "wal_dir": "on"}], indirect=True)
    def test_ride_through_statuses_stay_in_position(self, services):
        spies = _spies(services, batch_mode="outage", insert_ok=0)
        _, statuses = both(services, "POST", "/batch/events.json", {"accessKey": WL_KEY}, {},
                           MIXED)
        assert [s["status"] for s in statuses] == [202, 400, 403, 202]
        status, body = both(services, "POST", "/events.json", K, {}, _ev(eventId="fixed-one"))
        assert (status, body["durability"]) == (202, "journaled")
        for spy, svc in zip(spies, services):
            spy.lift()
            assert _drained(svc, 3)
            assert _stored_ids(svc) == ["fixed-m0", "fixed-m3", "fixed-one"]

    @pytest.mark.parametrize("services", [{"stats": True, "wal_dir": "on"}], indirect=True)
    def test_mid_fallback_outage_journals_the_tail(self, services):
        spies = _spies(services, batch_mode="prefix", insert_ok=1)
        _, statuses = both(services, "POST", "/batch/events.json", K, {},
                           [_ev(minutes=n, eventId=f"fixed-{n}") for n in range(4)])
        assert [s["status"] for s in statuses] == [201, 202, 202, 202]
        for spy, svc in zip(spies, services):
            assert spy.calls["insert"] == 2        # the dead store is not walked further
            spy.lift()
            assert _drained(svc, 4)

    @pytest.mark.parametrize("services", [{"stats": True, "wal_dir": "on",
                                           "wal_policy": "write-through"}], indirect=True)
    def test_write_through_answers_202(self, services):
        _, statuses = both(services, "POST", "/batch/events.json", K, {}, MIXED)
        assert [s["status"] for s in statuses] == [202, 400, 202, 202]
        assert both(services, "POST", "/events.json", K, {}, _ev())[0] == 202
        for svc in services:
            assert _drained(svc, 4)
            # how the drainer groups records into batches is timing
            status, doc = svc.handle("GET", "/stats.json", K, {})
            assert (status, doc["ingest"]["events"], doc["wal"]["mode"]) == (200, 4, "idle")
            assert doc["currentHour"]["statusCode"] == [{"key": 202, "value": 4}]

    @pytest.mark.parametrize("services", [{"stats": True, "wal_dir": "on",
                                           "wal_max_bytes": 600}], indirect=True)
    def test_journal_at_budget_sheds_503(self, services):
        _spies(services, batch_mode="outage", insert_ok=0)
        statuses = [both(services, "POST", "/events.json", K, {}, _ev(minutes=n))[0]
                    for n in range(4)]
        assert statuses[0] == 202 and statuses[-1] == 503

    @pytest.mark.parametrize("services", [{"stats": True, "wal_dir": "on"}], indirect=True)
    def test_auth_cache_serves_outage_and_ignores_bogus_keys(self, services):
        both(services, "POST", "/events.json", K, {}, _ev(eventId="fixed-warm"))
        for svc, mod in zip(services, (jresilience, resilience)):
            def down(key, error=mod.StorageUnavailableError):
                raise error("spy", "down")
            svc.access_keys.get = down
        _spies(services, batch_mode="outage", insert_ok=0)
        assert both(services, "POST", "/events.json", K, {}, _ev())[0] == 202
        assert both(services, "POST", "/events.json", {"accessKey": "bogus"}, {}, _ev())[0] == 503
        assert both(services, "GET", "/readyz")[1]["durability"] == "journaling"
        for svc in services:
            assert set(svc._auth_cache) == {("key", KEY)}


# -- the port over HTTP ------------------------------------------------------

def call(port, method, path, body=None, content_type="application/json", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    payload = None
    headers = dict(headers or {})
    if body is not None:
        payload = body if isinstance(body, (str, bytes)) else json.dumps(body)
        headers["Content-Type"] = content_type
    conn.request(method, path, body=payload, headers=headers)
    resp = conn.getresponse()
    data = json.loads(resp.read())
    out = resp.status, data, dict(resp.getheaders())
    conn.close()
    return out


@pytest.fixture
def http_server(tmp_path):
    storage = memory_storage()
    _seed(storage, App, AccessKey, Channel)
    srv = pes.EventServer(storage, pes.EventServerConfig(ip="127.0.0.1", port=0, stats=True))
    srv.start()
    yield srv
    srv.stop()


class TestHTTP:
    def test_routes_and_request_id(self, http_server):
        port = http_server.port
        status, body, headers = call(port, "POST", f"/events.json?accessKey={KEY}", _ev())
        assert status == 201 and "X-PIO-Request-Id" in headers
        eid = body["eventId"]
        assert call(port, "GET", f"/events/{eid}.json?accessKey={KEY}")[1]["entityId"] == "u1"
        assert call(port, "POST", f"/events.json?accessKey={KEY}", "{not json")[:2] == (
            400, {"message": "the request body is not valid JSON"})
        assert call(port, "GET", "/readyz")[:2] == (200, {"status": "ready", "storage": "ok"})

    def test_one_insert_batch_call_per_batch(self, http_server):
        spy = _Spy(http_server.service, resilience.StorageUnavailableError)
        status, statuses, _ = call(http_server.port, "POST",
                                   f"/batch/events.json?accessKey={KEY}",
                                   [_ev(minutes=n) for n in range(50)])
        assert status == 200 and {s["status"] for s in statuses} == {201}
        assert spy.calls == {"insert_batch": 1, "insert": 0}
        ingest = call(http_server.port, "GET", f"/stats.json?accessKey={KEY}")[1]["ingest"]
        assert (ingest["events"], ingest["batchSizeHistogram"]) == (50, {"50": 1})

    def test_partial_failure_fallback(self, http_server):
        _Spy(http_server.service, resilience.StorageUnavailableError, batch_mode="prefix")
        _, statuses, _ = call(http_server.port, "POST", f"/batch/events.json?accessKey={KEY}",
                              [_ev(minutes=n) for n in range(5)])
        assert [s["status"] for s in statuses] == [201] * 5
        assert len(_stored_ids(http_server.service)) == 5

    def test_webhooks(self, http_server):
        port = http_server.port
        status, body, _ = call(port, "POST", f"/webhooks/segmentio.json?accessKey={KEY}",
                               {"version": "2", "type": "track", "userId": "u7",
                                "event": "Played"})
        assert status == 201
        got = http_server.service.events.get(body["eventId"], 1)
        assert (got.event, got.entity_id) == ("track", "u7")
        form = urllib.parse.urlencode({"type": "subscribe", "data[email]": "x@y.z",
                                       "fired_at": "2026-01-01 00:00:00"})
        status, body, _ = call(port, "POST", f"/webhooks/mailchimp.form?accessKey={KEY}",
                               form, content_type="application/x-www-form-urlencoded")
        assert status == 201
        got = http_server.service.events.get(body["eventId"], 1)
        assert (got.event, got.entity_id, got.event_time) == ("subscribe", "x@y.z", T0)

    def test_input_blocker(self):
        storage = memory_storage()
        _seed(storage, App, AccessKey, Channel)
        srv = pes.EventServer(storage, pes.EventServerConfig(ip="127.0.0.1", port=0),
                              pplugins.EventServerPluginContext(
                                  [_blocker(pplugins.EventServerPlugin,
                                            pplugins.INPUT_BLOCKER)])).start()
        try:
            assert call(srv.port, "POST", f"/events.json?accessKey={KEY}",
                        _ev(name="spam"))[:2] == (403, {"message": "spam is blocked"})
            assert call(srv.port, "POST", f"/events.json?accessKey={KEY}", _ev())[0] == 201
        finally:
            srv.stop()

    def test_stats_off(self):
        storage = memory_storage()
        _seed(storage, App, AccessKey, Channel)
        srv = pes.EventServer(storage, pes.EventServerConfig(ip="127.0.0.1", port=0)).start()
        try:
            assert call(srv.port, "GET", f"/stats.json?accessKey={KEY}")[0] == 404
        finally:
            srv.stop()

    def test_max_batch_events_read_at_construction(self, monkeypatch):
        monkeypatch.setenv("PIO_EVENTSERVER_MAX_BATCH", "3")
        config = pes.EventServerConfig(ip="127.0.0.1", port=0)
        assert config.max_batch_events == 3
        monkeypatch.setenv("PIO_EVENTSERVER_MAX_BATCH", "zero")
        assert pes.EventServerConfig().max_batch_events == pes.MAX_EVENTS_PER_BATCH == 50
        monkeypatch.delenv("PIO_EVENTSERVER_MAX_BATCH")
        storage = memory_storage()
        _seed(storage, App, AccessKey, Channel)
        srv = pes.EventServer(storage, config).start()
        try:
            path = f"/batch/events.json?accessKey={KEY}"
            assert call(srv.port, "POST", path, [_ev()] * 3)[0] == 200
            assert call(srv.port, "POST", path, [_ev()] * 4)[:2] == (400, {
                "message": "Batch request must have less than or equal to 3 events"})
        finally:
            srv.stop()

    def test_ride_through_over_http(self, tmp_path):
        storage = memory_storage()
        _seed(storage, App, AccessKey, Channel)
        srv = pes.EventServer(storage, pes.EventServerConfig(
            ip="127.0.0.1", port=0, stats=True, wal_dir=str(tmp_path / "wal"))).start()
        try:
            call(srv.port, "POST", f"/events.json?accessKey={KEY}", _ev())   # warm auth
            spy = _Spy(srv.service, resilience.StorageUnavailableError, batch_mode="outage",
                       insert_ok=0)
            _, statuses, _ = call(srv.port, "POST", f"/batch/events.json?accessKey={KEY}",
                                  [_ev(minutes=n) for n in range(3)])
            assert [s["status"] for s in statuses] == [202] * 3
            status, body, headers = call(srv.port, "POST", f"/events.json?accessKey={KEY}",
                                         _ev(minutes=9))
            assert (status, body["durability"]) == (202, "journaled")
            spy.lift()
            assert _drained(srv.service, 5)
            assert set(_stored_ids(srv.service)) >= {s["eventId"] for s in statuses}
        finally:
            srv.stop()

    def test_concurrent_ingest_into_sqlite_loses_nothing(self, tmp_path):
        storage = Storage({"PIO_FS_BASEDIR": str(tmp_path / "store")})
        app_id = _seed(storage, App, AccessKey, Channel)
        srv = pes.EventServer(storage, pes.EventServerConfig(
            ip="127.0.0.1", port=0, stats=True)).start()
        errors: list = []
        sent: list[list[str]] = [[] for _ in range(8)]

        def client(c):
            try:
                conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
                for b in range(5):
                    batch = [_ev(entity=f"c{c}", minutes=b, target=f"i{n}") for n in range(20)]
                    conn.request("POST", f"/batch/events.json?accessKey={KEY}",
                                 json.dumps(batch), {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    statuses = json.loads(resp.read())
                    assert {s["status"] for s in statuses} == {201}
                    sent[c].extend(s["eventId"] for s in statuses)
                conn.close()
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not errors
            ids = sorted(i for s in sent for i in s)
            assert len(ids) == len(set(ids)) == 800
            assert sorted(e.event_id for e in storage.get_events().find(app_id)) == ids
            ingest = call(srv.port, "GET", f"/stats.json?accessKey={KEY}")[1]["ingest"]
            assert (ingest["events"], ingest["batches"]) == (800, 40)
        finally:
            srv.stop()
            storage.close()


# -- pio eventserver as a process --------------------------------------------

def test_pio_eventserver_imports_no_torch(tmp_path):
    """`pio eventserver` serves events without importing torch or the JAX
    package: the ingest process starts in well under a second."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_") and k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), PIO_FS_BASEDIR=str(tmp_path / "store"))
    pio = [sys.executable, "-m", "predictionio_tpu_torch.cli.pio"]
    out = subprocess.run(pio + ["app", "new", "A", "--access-key", KEY], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    code = (
        "import sys, threading, json, urllib.request\n"
        "from predictionio_tpu_torch.cli import pio\n"
        "from predictionio_tpu_torch.api import http_base\n"
        "def stop(server):\n"
        "    url = f'http://127.0.0.1:{server.port}/events.json?accessKey=" + KEY + "'\n"
        "    body = json.dumps({'event': 'view', 'entityType': 'user', 'entityId': 'u'})\n"
        "    req = urllib.request.Request(url, data=body.encode(), method='POST',\n"
        "                                 headers={'Content-Type': 'application/json'})\n"
        "    print('POST', urllib.request.urlopen(req, timeout=10).status)\n"
        "    server.stop()\n"
        "real = http_base.serve_until_stopped\n"
        "def serve(server):\n"
        "    threading.Thread(target=stop, args=(server,)).start()\n"
        "    real(server)\n"
        "http_base.serve_until_stopped = serve\n"
        "rc = pio.main(['eventserver', '--ip', '127.0.0.1', '--port', '0', '--stats'])\n"
        "bad = sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.')\n"
        "             or m == 'predictionio_tpu' or m.startswith('predictionio_tpu.'))\n"
        "print(rc, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert "Event Server listening on 127.0.0.1:" in lines[0]
    assert lines[-2:] == ["POST 201", "0 []"]


# -- deploy --feedback -------------------------------------------------------

class _StubEventServer:
    """Records the bodies POSTed to /events.json."""

    def __init__(self):
        self.bodies: list[tuple[str, dict]] = []
        self.got = threading.Condition()
        stub = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                data = self.rfile.read(int(self.headers["Content-Length"]))
                with stub.got:
                    stub.bodies.append((self.path, json.loads(data)))
                    stub.got.notify_all()
                self.send_response(201)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def wait(self, n, timeout=10.0):
        with self.got:
            self.got.wait_for(lambda: len(self.bodies) >= n, timeout)
            return list(self.bodies)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _als_pair(tmp_path, stub_port):
    rng = np.random.default_rng(0)
    U = rng.standard_normal((8, 4)).astype(np.float32)
    I = rng.standard_normal((30, 4)).astype(np.float32)
    seen = {u: np.arange(u, dtype=np.int32) for u in range(8)}
    uids, iids = {f"u{i}": i for i in range(8)}, {f"i{i}": i for i in range(30)}
    feedback = dict(ip="127.0.0.1", port=0, feedback=True, event_server_ip="127.0.0.1",
                    event_server_port=stub_port, access_key="fbkey")
    jmodel = jmodels.ALSModel(
        rank=4, user_factors=jnp.asarray(U), item_factors=jnp.asarray(I),
        user_ids=JaxEntityIdIxMap(JaxBiMap(uids)), item_ids=JaxEntityIdIxMap(JaxBiMap(iids)),
        seen_by_user=seen)
    deployed = JaxDeployedEngine(
        jrec.engine_factory(), JaxEngineInstance(
            id="jax", status="COMPLETED", start_time=T0, completion_time=T0, engine_id="e",
            engine_version="1", engine_variant="e", engine_factory="jax"),
        [jrec.ALSAlgorithm(jrec.ALSAlgorithmParams())], JaxFirstServing(), [jmodel])
    jax_srv = jengine.EngineServer(deployed, JaxServerConfig(**feedback),
                                   storage=jax_memory_storage())
    jax_srv.start()
    storage = memory_storage()
    iid = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=T0, completion_time=T0, engine_id="e",
        engine_version="1", engine_variant="e",
        engine_factory="predictionio_tpu_torch.templates.recommendation.engine_factory",
        algorithms_params=json.dumps([{"name": "als", "params": {}}])))
    save_models(storage, iid, [PersistentModelManifest(
        "predictionio_tpu_torch.templates.recommendation.ALSAlgorithm", str(tmp_path / "m"))])
    pmodels.ALSModel.from_jax(U, I, uids, iids, seen, device="cpu").save(str(tmp_path / "m"))
    port_srv = pengine.create_engine_server(storage, ServerConfig(
        device="cpu", engine_instance_id=iid, **feedback)).start()
    return jax_srv, port_srv


def test_deploy_feedback_posts_jax_predict_event(tmp_path):
    stub = _StubEventServer()
    jax_srv, port_srv = _als_pair(tmp_path, stub.httpd.server_address[1])
    try:
        queries = [{"user": "u3", "num": 4, "prId": "pr-fixed"}, {"user": "u5", "num": 3}]
        answers = {}
        for name, srv in (("jax", jax_srv), ("port", port_srv)):
            for q in queries:
                status, body, _ = call(srv.port, "POST", "/queries.json", q)
                assert status == 200
                answers.setdefault(name, []).append(body)
            posted = stub.wait(2 * len(answers))
            assert len(posted) == 2 * len(answers)
        bodies = stub.wait(4)
        # each server's two posts race on their own threads: order by query
        jax_posts, port_posts = (sorted(bodies[i:i + 2],
                                        key=lambda b: b[1]["properties"]["query"]["user"])
                                 for i in (0, 2))
        for (jpath, jdoc), (ppath, pdoc), ja, pa, q in zip(
                jax_posts, port_posts, answers["jax"], answers["port"], queries):
            assert jpath == ppath == "/events.json?accessKey=fbkey"
            assert pa["prId"] == pdoc["entityId"] and ja["prId"] == jdoc["entityId"]
            if "prId" in q:
                assert pa["prId"] == ja["prId"] == "pr-fixed"
            for doc in (jdoc, pdoc):
                doc["entityId"] = doc["properties"]["prediction"]["prId"] = "<pr>"
                for s in doc["properties"]["prediction"]["itemScores"]:
                    s["score"] = round(s["score"], 4)
            assert pdoc == jdoc
            assert pdoc["properties"]["query"] == {k: v for k, v in q.items() if k != "prId"}
    finally:
        jax_srv.stop()
        port_srv.stop()
        stub.close()


def test_feedback_failure_never_reaches_the_query(tmp_path):
    """An event server that is not there costs the query nothing."""
    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    jax_srv, port_srv = _als_pair(tmp_path, dead_port)
    try:
        status, body, _ = call(port_srv.port, "POST", "/queries.json", {"user": "u1", "num": 2})
        assert status == 200 and len(body["prId"]) == 32 and len(body["itemScores"]) == 2
    finally:
        jax_srv.stop()
        port_srv.stop()
