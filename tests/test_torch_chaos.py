"""The port's fault-injecting storage backend (``storage/chaos.py``) on the
CPU, against the JAX package's.

- For the same seed and the same script of calls, both injectors fault
  at the same calls, draw the same latencies and end with the same
  counters; through ``ChaosStorageClient.wrap`` the DAO results, the
  retry sleeps (a seeded retry RNG on a ManualClock) and the resilience
  counters are equal too.
- Sources built from ``PIO_STORAGE_SOURCES_*`` (``TARGET`` with its
  forwarded ``TARGET_<KEY>`` properties, ``FAULT_RATE``, ``SEED``,
  ``ERROR``, ``LATENCY_MS``/``DELAY_MS``, ``LATENCY_JITTER_MS``,
  ``DELAY_PROB``) get the same injector and the same retry-heavy policy.
- An injected fault reaches a caller only as a retried success or a
  ``StorageUnavailableError``: the port's event server over ``chaos``
  storage answers 201 or 503 with ``Retry-After``, never 500, loses no
  accepted event, and its ``/readyz`` turns 503 during an outage and
  200 after it, as tests/test_chaos_resilience.py holds JAX's.

Seeds come from numpy; every comparison is exact.
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.storage import base as jbase
from predictionio_tpu.storage import chaos as jchaos
from predictionio_tpu.storage.memory import MemoryStorageClient as JaxMemory
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage import base as pbase
from predictionio_tpu_torch.storage import chaos
from predictionio_tpu_torch.storage.memory import MemoryStorageClient
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils import resilience as pres

pytestmark = pytest.mark.chaos

SEEDS = [int(s) for s in np.random.default_rng(15).integers(0, 2**31, size=4)]
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)

#: (fault_rate, error, latency_ms, jitter_ms, delay_prob)
INJECTORS = [
    (0.3, "chaos", 0.0, 0.0, 1.0),
    (0.5, "connection", 2.0, 0.0, 1.0),
    (0.2, "timeout", 1.0, 3.0, 1.0),
    (0.3, "chaos", 5.0, 10.0, 0.25),
]


def _stream(module, seed: int, cfg: tuple, n: int = 400) -> tuple:
    fault_rate, error, latency_ms, jitter_ms, delay_prob = cfg
    clock = (jres if module is jchaos else pres).ManualClock()
    inj = module.ChaosInjector(fault_rate=fault_rate, seed=seed, error=error,
                               latency_ms=latency_ms, latency_jitter_ms=jitter_ms,
                               delay_prob=delay_prob, clock=clock)
    fired = []
    for i in range(n):
        if i == n // 2:
            inj.set_fault_rate(min(1.0, fault_rate * 2))
        try:
            inj.before(f"op{i % 7}")
            fired.append(None)
        except Exception as exc:
            fired.append((type(exc).__name__, str(exc)))
    return fired, clock.slept, (inj.calls, inj.faults_injected, inj.delays_injected)


class TestInjector:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("cfg", INJECTORS, ids=lambda c: f"{c[0]}-{c[1]}-{c[4]}")
    def test_same_faults_latencies_and_counters(self, seed, cfg):
        jax_out, port_out = _stream(jchaos, seed, cfg), _stream(chaos, seed, cfg)
        assert jax_out == port_out
        assert port_out[2][1] > 0                 # faults fired
        if cfg[2] or cfg[3]:
            assert port_out[1] and port_out[2][2] > 0

    def test_error_classes_and_unknown_error(self):
        for error, cls in (("chaos", chaos.ChaosError), ("connection", ConnectionError),
                           ("timeout", TimeoutError)):
            with pytest.raises(cls, match="injected"):
                chaos.ChaosInjector(fault_rate=1.0, error=error).before("op")
        assert issubclass(chaos.ChaosError, pres.TransientError)
        with pytest.raises(ValueError, match="unknown chaos ERROR") as port_err:
            chaos.ChaosInjector(error="nope")
        with pytest.raises(ValueError) as jax_err:
            jchaos.ChaosInjector(error="nope")
        assert str(port_err.value) == str(jax_err.value)


def _events(event_cls, datamap_cls, n: int) -> list:
    return [event_cls(event="rate", entity_type="user", entity_id=f"u{i % 9}",
                      target_entity_type="item", target_entity_id=f"i{i}",
                      properties=datamap_cls({"rating": i % 5}),
                      event_time=T0 + timedelta(minutes=i), event_id=f"e{i}",
                      creation_time=T0)
            for i in range(n)]


def _script(package: str, seed: int) -> dict:
    """One script of DAO calls through ``wrap`` over a memory store, with
    a seeded retry RNG on a ManualClock; everything it observed."""
    res, ch, base, mem = ((jres, jchaos, jbase, JaxMemory) if package == "jax"
                          else (pres, chaos, pbase, MemoryStorageClient))
    ev_cls, dm_cls = (JaxEvent, JaxDataMap) if package == "jax" else (Event, DataMap)
    clock = res.ManualClock()
    resilience = res.Resilience(
        f"chaos-parity-{package}", clock=clock, rng=random.Random(seed), register=False,
        policy=res.RetryPolicy(max_attempts=12, base_delay=0.001, max_delay=0.02))
    inner = mem()
    c = ch.ChaosStorageClient.wrap(inner, fault_rate=0.35, seed=seed, latency_ms=1.0,
                                   latency_jitter_ms=2.0, delay_prob=0.5,
                                   resilience=resilience, clock=clock)
    out = []
    app_id = c.apps().insert(base.App(0, "chaos-app", "d"))
    out.append(app_id)
    out.append(c.access_keys().insert(base.AccessKey("k" * 64, app_id, ("rate",))))
    out.append(c.channels().insert(base.Channel(0, "web", app_id)))
    events = c.events()
    events.init(app_id)
    ids = [events.insert(e, app_id) for e in _events(ev_cls, dm_cls, 40)]
    out.append(ids)
    out.append(events.insert_batch(_events(ev_cls, dm_cls, 60)[40:], app_id))
    found = list(events.find(app_id, None, base.EventFilter(entity_id="u3")))
    out.append([(e.event_id, e.target_entity_id, dict(e.properties.fields)) for e in found])
    out.append(events.delete("e7", app_id))
    out.append(sorted(e.event_id for e in inner.events().find(app_id)))
    c.models().insert(base.Model("m1", b"\x00blob"))
    out.append(c.models().get("m1").models)
    out.append([a.name for a in c.apps().get_all()])
    return {"results": out, "slept": clock.slept,
            "counters": (c.injector.calls, c.injector.faults_injected,
                         c.injector.delays_injected),
            "metrics": resilience.metrics.snapshot()}


class TestWrap:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_wrap_runs_the_same_in_both(self, seed):
        jax_run, port_run = _script("jax", seed), _script("port", seed)
        assert jax_run == port_run
        assert port_run["counters"][1] > 0
        # no lost or doubled event: 60 accepted, one deleted
        assert len(port_run["results"][7]) == 59

    def test_close_passes_through_and_private_attrs_are_not_guarded(self):
        inner = MemoryStorageClient()
        c = chaos.ChaosStorageClient.wrap(inner, fault_rate=1.0, seed=1)
        events = c.events()
        assert events._inner is inner.events()
        events.close()                                   # never faulted
        assert c.injector.calls == 0
        assert c.events() is events                     # one proxy per DAO

    @pytest.mark.parametrize("package", ["jax", "port"])
    def test_exhausted_retries_raise_storage_unavailable(self, package):
        res, ch, base = (jres, jchaos, jbase) if package == "jax" else (pres, chaos, pbase)
        mem = JaxMemory if package == "jax" else MemoryStorageClient
        clock = res.ManualClock()
        c = ch.ChaosStorageClient.wrap(
            mem(), fault_rate=1.0, seed=3, clock=clock,
            resilience=res.Resilience(f"outage-{package}", clock=clock, register=False,
                                      policy=res.RetryPolicy(max_attempts=3)))
        with pytest.raises(res.StorageUnavailableError) as err:
            c.apps().insert(base.App(0, "x"))
        assert "injected fault in insert" in str(err.value)
        assert c.injector.faults_injected == 3 and c.inner.apps().get_all() == []


def _env(tmp_path, **extra) -> dict:
    return {"PIO_STORAGE_SOURCES_C_TYPE": "chaos",
            "PIO_STORAGE_SOURCES_C_TARGET": "sqlite",
            "PIO_STORAGE_SOURCES_C_TARGET_PATH": str(tmp_path / "pio.sqlite"),
            **{f"PIO_STORAGE_SOURCES_C_{k}": v for k, v in extra.items()},
            **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "C"
               for r in ("METADATA", "EVENTDATA", "MODELDATA")}}


class TestRegistry:
    @pytest.mark.parametrize("extra", [
        {},
        {"FAULT_RATE": "0.45", "SEED": "77", "ERROR": "timeout"},
        {"LATENCY_MS": "3", "LATENCY_JITTER_MS": "2", "DELAY_PROB": "0.5"},
        {"DELAY_MS": "4", "RETRY_MAX_ATTEMPTS": "3", "RETRY_BASE_DELAY_MS": "5"},
    ])
    def test_env_builds_the_same_injector_and_policy(self, tmp_path, extra):
        jax_c = JaxStorage(_env(tmp_path / "j", **extra)).client_for_source("C")
        port_c = Storage(_env(tmp_path / "p", **extra)).client_for_source("C")
        assert type(port_c.inner).__name__ == type(jax_c.inner).__name__ == "SQLiteStorageClient"
        for attr in ("fault_rate", "seed", "_latency", "_jitter", "_delay_prob"):
            assert getattr(port_c.injector, attr) == getattr(jax_c.injector, attr), attr
        assert port_c.injector._error("op").__class__.__name__ == \
            jax_c.injector._error("op").__class__.__name__
        jp, pp = jax_c.resilience.policy, port_c.resilience.policy
        assert (pp.max_attempts, pp.base_delay, pp.max_delay) == \
            (jp.max_attempts, jp.base_delay, jp.max_delay)
        assert (port_c.resilience.breaker is None) == (jax_c.resilience.breaker is None)

    @pytest.mark.parametrize("env, message", [
        ({"PIO_STORAGE_SOURCES_C_TYPE": "chaos"}, "requires a TARGET"),
        ({"PIO_STORAGE_SOURCES_C_TYPE": "chaos", "PIO_STORAGE_SOURCES_C_TARGET": "nosuch"},
         "not a registered"),
    ])
    def test_bad_target_raises_as_in_jax(self, env, message):
        env = {**env, **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "C"
                         for r in ("METADATA", "EVENTDATA", "MODELDATA")}}
        with pytest.raises(Exception, match=message) as port_err:
            Storage(env).get_events()
        with pytest.raises(Exception, match=message) as jax_err:
            JaxStorage(env).get_events()
        assert type(port_err.value).__name__ == type(jax_err.value).__name__


def _post(url: str, payload) -> tuple[int, dict, dict]:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=15) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url: str) -> tuple[int, dict, dict]:
    try:
        with urllib.request.urlopen(url, timeout=15) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


class TestEventServerOverChaos:
    def test_ingest_survives_faults_with_no_500_and_no_loss(self, tmp_path):
        from predictionio_tpu_torch.api.event_server import EventServer, EventServerConfig

        storage = Storage(_env(tmp_path, FAULT_RATE="0.3", SEED=str(SEEDS[0])))
        app_id = storage.get_meta_data_apps().insert(pbase.App(0, "chaosapp"))
        storage.get_meta_data_access_keys().insert(pbase.AccessKey("chaoskey", app_id, ()))
        storage.get_events().init(app_id)
        server = EventServer(storage, EventServerConfig(ip="127.0.0.1", port=0)).start()
        try:
            url = f"http://127.0.0.1:{server.port}"
            statuses = []
            for i in range(60):
                payload = {"event": "rate", "entityType": "user", "entityId": f"u{i}",
                           "properties": {"rating": i % 5}}
                for _ in range(20):                # clients retry 503s
                    status, body, headers = _post(f"{url}/events.json?accessKey=chaoskey",
                                                  payload)
                    statuses.append(status)
                    assert status in (201, 503), (status, body)
                    if status == 503:
                        assert "Retry-After" in headers
                        time.sleep(0.01)
                        continue
                    break
                else:
                    pytest.fail(f"event {i} never accepted")
            batch = [{"event": "buy", "entityType": "user", "entityId": f"b{i}"}
                     for i in range(20)]
            status, body, _ = _post(f"{url}/batch/events.json?accessKey=chaoskey", batch)
            assert status in (200, 503) and 500 not in statuses
            stored = {e.entity_id for e in storage.get_events().find(app_id)}
            want = {f"u{i}" for i in range(60)}
            if status == 200:
                want |= {f"b{i}" for i, r in enumerate(body) if r["status"] == 201}
            assert stored == want
            assert _get(f"{url}/readyz")[0] == 200
            assert storage.client_for_source("C").injector.faults_injected > 20
        finally:
            server.stop()
            storage.close()

    def test_outage_gives_503_with_retry_after_and_readyz_flips(self, tmp_path):
        from predictionio_tpu_torch.api.event_server import EventServer, EventServerConfig

        storage = Storage(_env(tmp_path, FAULT_RATE="0.0"))
        app_id = storage.get_meta_data_apps().insert(pbase.App(0, "outage"))
        storage.get_meta_data_access_keys().insert(pbase.AccessKey("ok", app_id, ()))
        storage.get_events().init(app_id)
        server = EventServer(storage, EventServerConfig(ip="127.0.0.1", port=0)).start()
        url = f"http://127.0.0.1:{server.port}"
        event = {"event": "rate", "entityType": "user", "entityId": "u1"}
        try:
            assert _get(f"{url}/readyz")[0] == 200
            client = storage.client_for_source("C")
            client.injector.set_fault_rate(1.0)                    # total outage
            client.resilience.policy = pres.RetryPolicy(max_attempts=2, base_delay=0.001)
            status, body, headers = _post(f"{url}/events.json?accessKey=ok", event)
            assert status == 503 and "Retry-After" in headers, (status, body)
            status, body, headers = _get(f"{url}/readyz")
            assert status == 503 and body["status"] == "unavailable" and "Retry-After" in headers
            assert _get(f"{url}/healthz")[0] == 200              # liveness stays
            client.injector.set_fault_rate(0.0)                    # recovery
            assert _get(f"{url}/readyz")[0] == 200
            assert _post(f"{url}/events.json?accessKey=ok", event)[0] == 201
            assert [e.entity_id for e in storage.get_events().find(app_id)] == ["u1"]
        finally:
            server.stop()
            storage.close()
