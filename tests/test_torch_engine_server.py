"""The port's engine server beside the JAX package's, on the CPU (lanes:
tests/test_engine_server.py, tests/test_query_batching.py).

Both servers run with batching and the result cache on, over the same
small models: a sessionrec model trained by the JAX template, carried
into the port with ``models/seqrec.params_from_jax`` (both in f32), and
an ALS model of seeded factors (``models/als.params_from_jax``). The port
deploys a stored engine instance; the JAX server wraps its deployed
engine directly. Checked:

- 16 concurrent clients get the same items from both, scores within 1e-5
  (f32 products summed in another order by XLA and by torch);
- the status codes equal JAX's on invalid JSON, a non-object body, an
  unknown field, a raising blocker, /stop and /reload without the key, a
  blown X-PIO-Deadline-Ms, a malformed one, a chunked body and a
  malformed Content-Length;
- the /stats.json keys equal JAX's minus :data:`STATS_LEFT_OUT` (now
  none), the ``compile`` block's keys among them;
- a failed /reload keeps serving the old instance on both.

Port-only: a successful /reload (cache generation, /readyz, the next
repeat a miss), /readyz during a reload, the deadline of the unbatched
path, the launch identity of batched sessionrec serving (n_layers ×
Σ popcount(batch size) attention calls), plugins, and ``pio deploy
--batching --cache --server-key`` / ``pio undeploy`` as processes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.api import engine_server as jserver_mod
from predictionio_tpu.controller import FirstServing as JaxFirstServing
from predictionio_tpu.models import als as jmodels
from predictionio_tpu.storage.base import EngineInstance as JaxEngineInstance
from predictionio_tpu.templates import recommendation as jrec
from predictionio_tpu.templates import sessionrec as jsess
from predictionio_tpu.utils import resilience as jresilience
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu.utils.bimap import EntityIdIxMap as JaxEntityIdIxMap
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow.deploy import DeployedEngine as JaxDeployedEngine
from predictionio_tpu.workflow.deploy import ServerConfig as JaxServerConfig
from predictionio_tpu_torch.api import engine_server as pserver_mod
from predictionio_tpu_torch.controller import PersistentModelManifest
from predictionio_tpu_torch.models import als as pmodels
from predictionio_tpu_torch.models import seqrec
from predictionio_tpu_torch.storage.base import EngineInstance
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.templates import sessionrec as psess
from predictionio_tpu_torch.utils import resilience
from predictionio_tpu_torch.workflow.deploy import ServerConfig
from predictionio_tpu_torch.workflow.persistence import save_models

REPO = Path(__file__).resolve().parent.parent
KEY = "sekrit"
SCORE_TOL = 1e-5
#: /stats.json keys of the JAX server that the port leaves out (the
#: compile block came with the build sentinel, obs/compile.py)
STATS_LEFT_OUT: set[str] = set()
#: a query that the wrapped algorithms hold for SLOW_S (the deadline case)
SLOW_NUM, SLOW_S = 17, 0.4
#: a query whose prediction the test blocker rejects
REJECT_NUM = 13
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)


# -- the two servers ---------------------------------------------------------

def _blocker(base):
    class RejectThirteen(base):
        plugin_name = "reject13"
        plugin_type = "outputblocker"

        def process(self, info, context):
            if info.query.num == REJECT_NUM:
                raise ValueError("thirteen is not served")
            return info.prediction

    return RejectThirteen()


def _slowed(algo):
    """Hold any batch holding a SLOW_NUM query for SLOW_S seconds."""
    real = algo.batch_predict

    def batch_predict(model, queries):
        if any(q.num == SLOW_NUM for _, q in queries):
            time.sleep(SLOW_S)
        return real(model, queries)

    algo.batch_predict = batch_predict
    return algo


def _serving_config(cls, **extra):
    return cls(**{**dict(ip="127.0.0.1", port=0, batching=True, batch_max=16,
                         batch_wait_ms=20.0, cache_enabled=True, server_key=KEY), **extra})


def _jax_server(engine_factory, algo, model):
    deployed = JaxDeployedEngine(
        engine_factory(), JaxEngineInstance(
            id="jax-instance", status="COMPLETED", start_time=T0, completion_time=T0,
            engine_id="e", engine_version="1", engine_variant="e", engine_factory="jax"),
        [_slowed(algo)], JaxFirstServing(), [model])
    server = jserver_mod.EngineServer(
        deployed, _serving_config(JaxServerConfig), storage=jax_memory_storage(),
        plugin_context=jserver_mod.EngineServerPluginContext(
            [_blocker(jserver_mod.EngineServerPlugin)]))
    server.start()
    return server


def _store_instance(storage, factory: str, algo_name: str, algo_class: str, location: str,
                    start: datetime = T0) -> str:
    """A COMPLETED engine instance whose model blob is a manifest of
    ``location``."""
    iid = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=start, completion_time=start,
        engine_id="e", engine_version="1", engine_variant="e", engine_factory=factory,
        algorithms_params=json.dumps([{"name": algo_name, "params": {}}])))
    save_models(storage, iid, [PersistentModelManifest(algo_class, location)])
    return iid


SESS = ("predictionio_tpu_torch.templates.sessionrec.engine_factory", "seqrec",
        "predictionio_tpu_torch.templates.sessionrec.SeqRecAlgorithm")
REC = ("predictionio_tpu_torch.templates.recommendation.engine_factory", "als",
       "predictionio_tpu_torch.templates.recommendation.ALSAlgorithm")


def _save(model, location: str) -> None:
    if isinstance(model, psess.SeqRecEngineModel):
        psess.save_engine_model(model, location)
    else:
        model.save(location)


def _port_server(storage, kind, model, location, **extra):
    iid = _store_instance(storage, *kind, location)
    _save(model, location)
    server = pserver_mod.create_engine_server(
        storage, _serving_config(ServerConfig, device="cpu", engine_instance_id=iid, **extra),
        plugin_context=pserver_mod.EngineServerPluginContext(
            [_blocker(pserver_mod.EngineServerPlugin)])).start()
    _slowed(server.deployed.algorithms[0])
    return server


@pytest.fixture(scope="module")
def sessionrec_models():
    """(JAX algorithm, JAX f32 model, the port's f32 model of its arrays)."""
    rng = np.random.default_rng(0)
    sequences = {f"u{u}": [f"i{(int(rng.integers(12)) + t) % 12}" for t in range(9)]
                 for u in range(24)}
    algo = jsess.SeqRecAlgorithm(jsess.AlgorithmParams(
        d_model=32, n_heads=2, n_layers=2, max_len=16, epochs=4, batch_size=16, lr=3e-3,
        seed=0, use_mesh=False))
    jmodel = algo.train(None, jsess.TrainingData(sequences=sequences))
    jmodel32 = dataclasses.replace(
        jmodel, cfg=dataclasses.replace(jmodel.cfg, dtype=jnp.float32), device_tree=None)
    port = psess.SeqRecEngineModel.from_jax(
        jmodel32.params, dataclasses.asdict(jmodel32.cfg), jmodel32.item_index.to_dict(),
        jmodel32.histories, device="cpu")
    return algo, jmodel32, port


def _als_models(seed=0, users=40, items=500, rank=6, scale=1.0):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((users, rank)).astype(np.float32) * np.float32(scale)
    I = rng.standard_normal((items, rank)).astype(np.float32)
    seen = {u: np.sort(rng.choice(items, int(rng.integers(0, 30)), replace=False)
                       ).astype(np.int32) for u in range(users)}
    uids = {f"u{i}": i for i in range(users)}
    iids = {f"i{i}": i for i in range(items)}
    port = pmodels.ALSModel.from_jax(U, I, uids, iids, seen, device="cpu")
    jax_model = jmodels.ALSModel(
        rank=rank, user_factors=jnp.asarray(U), item_factors=jnp.asarray(I),
        user_ids=JaxEntityIdIxMap(JaxBiMap(uids)), item_ids=JaxEntityIdIxMap(JaxBiMap(iids)),
        seen_by_user=seen)
    return port, jax_model


@pytest.fixture(autouse=True)
def _fresh_registries():
    resilience.reset_registry()
    jresilience.reset_registry()
    yield
    resilience.reset_registry()
    jresilience.reset_registry()


@pytest.fixture(params=["sessionrec", "recommendation"])
def pair(request, sessionrec_models, tmp_path):
    """(template, JAX server, port server, 16 distinct queries)."""
    if request.param == "sessionrec":
        algo, jmodel, pmodel = sessionrec_models
        jax_srv = _jax_server(jsess.engine_factory, algo, jmodel)
        port_srv = _port_server(memory_storage(), SESS, pmodel, str(tmp_path / "m"))
        items = [f"i{n}" for n in range(12)]
        queries = ([{"user": f"u{u}", "num": 3 + u % 5} for u in range(10)]
                   + [{"items": items[j:j + 4], "num": 5} for j in range(4)]
                   + [{"user": "u3", "num": 4, "blackList": ["i1", "i2"]},
                      {"user": "nobody", "num": 2}])
    else:
        pmodel, jmodel = _als_models()
        jax_srv = _jax_server(jrec.engine_factory, jrec.ALSAlgorithm(jrec.ALSAlgorithmParams()),
                              jmodel)
        port_srv = _port_server(memory_storage(), REC, pmodel, str(tmp_path / "m"))
        picks = [f"i{j}" for j in range(0, 500, 7)]
        queries = ([{"user": f"u{u}", "num": (5, 10, 20)[u % 3]} for u in range(10)]
                   + [{"user": "u11", "num": 10, "whiteList": picks[:30]},
                      {"user": "u12", "num": 10, "blackList": picks[:40]},
                      {"user": "u13", "num": 4, "whiteList": picks[:20],
                       "blackList": picks[:5]},
                      {"user": "u14", "num": 10, "whiteList": []},
                      {"user": "nobody", "num": 5},
                      {"user": "u15", "num": 50}])
    yield request.param, jax_srv, port_srv, queries
    jax_srv.stop()
    port_srv.stop()


# -- HTTP helpers ------------------------------------------------------------

def _request(port, path, body=None, raw=None, headers=None, method=None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {},
                                 method=method or ("GET" if data is None else "POST"))
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _raw(port, request: bytes) -> bytes:
    """One request in one write; the response read to the end of its
    headers (the server may close with our unread bytes buffered)."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(request)
        data = b""
        try:
            while b"\r\n\r\n" not in data:
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
        except ConnectionResetError:
            pass
    return data


def _concurrently(port, bodies):
    out = [None] * len(bodies)
    barrier = threading.Barrier(len(bodies))

    def go(i):
        barrier.wait()
        out[i] = _request(port, "/queries.json", bodies[i])

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return out


def _answers(result):
    status, doc, _ = result
    assert status == 200, doc
    return [(s["item"], s["score"]) for s in doc["itemScores"]]


def _same_ranking(got, want, tol=SCORE_TOL):
    assert [i for i, _ in got] == [i for i, _ in want]
    assert max((abs(a - b) for (_, a), (_, b) in zip(got, want)), default=0.0) <= tol


def _key_paths(doc, prefix=""):
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k in ("serving", "batching", "cache", "compile"):
            out |= {f"{prefix}{k}.{p}" for p in _key_paths(v)}
    return out


# -- side by side ------------------------------------------------------------

class TestSideBySide:
    def test_concurrent_clients_get_jax_answers(self, pair):
        _, jax_srv, port_srv, queries = pair
        assert len(queries) == 16
        for _ in range(2):        # cold, then every answer from the cache
            got = _concurrently(port_srv.port, queries)
            want = _concurrently(jax_srv.port, queries)
            for g, w in zip(got, want):
                _same_ranking(_answers(g), _answers(w))
        ps = _request(port_srv.port, "/stats.json")[1]["serving"]
        js = _request(jax_srv.port, "/stats.json")[1]["serving"]
        for key in ("cacheHits", "cacheMisses", "batchedQueries", "expired"):
            assert ps[key] == js[key], key
        assert ps["cacheHits"] == 16 and ps["batchedQueries"] == 16
        hist = {int(n): c for n, c in ps["batchSizeHistogram"].items()}
        assert sum(n * c for n, c in hist.items()) + ps["deduped"] == 16

    @pytest.mark.parametrize("case", [
        "invalid_json", "non_object", "unknown_field", "empty_body", "blocker_raises",
        "stop_without_key", "reload_without_key", "reload_wrong_key", "deadline_blown",
        "deadline_malformed", "no_route", "chunked", "content_length_abc",
        "content_length_negative"])
    def test_status_codes_equal_jax(self, pair, case):
        _, jax_srv, port_srv, queries = pair
        user = queries[0].get("user", "u0")
        requests = {
            "invalid_json": dict(path="/queries.json", raw=b"{not json"),
            "non_object": dict(path="/queries.json", body=[1, 2]),
            "unknown_field": dict(path="/queries.json", body={"user": user, "bogus": 1}),
            "empty_body": dict(path="/queries.json", raw=b"", method="POST"),
            "blocker_raises": dict(path="/queries.json",
                                   body={"user": user, "num": REJECT_NUM}),
            "stop_without_key": dict(path="/stop", raw=b"", method="POST"),
            "reload_without_key": dict(path="/reload"),
            "reload_wrong_key": dict(path="/reload?accessKey=wrong"),
            "deadline_blown": dict(path="/queries.json", body={"user": user, "num": SLOW_NUM},
                                   headers={"X-PIO-Deadline-Ms": "50"}),
            "deadline_malformed": dict(path="/queries.json", body={"user": user},
                                       headers={"X-PIO-Deadline-Ms": "soon"}),
            "no_route": dict(path="/nope"),
        }
        raws = {
            "chunked": (b"POST /queries.json HTTP/1.1\r\nHost: x\r\nContent-Type: "
                        b"application/json\r\nTransfer-Encoding: chunked\r\n\r\n"
                        b"8\r\n{\"x\": 1}\r\n0\r\n\r\n"),
            "content_length_abc": b"GET /healthz HTTP/1.1\r\nHost: x\r\nContent-Length: abc\r\n\r\n",
            "content_length_negative": (b"GET /healthz HTTP/1.1\r\nHost: x\r\n"
                                        b"Content-Length: -1\r\n\r\n"),
        }
        if case in raws:
            got, want = _raw(port_srv.port, raws[case]), _raw(jax_srv.port, raws[case])
            assert got.split(b"\r\n")[0] == want.split(b"\r\n")[0]
            assert got.split(b" ")[1] in (b"411", b"400")
            assert b"connection: close" in got.lower()
            return
        got = _request(port_srv.port, **requests[case])
        want = _request(jax_srv.port, **requests[case])
        assert got[0] == want[0], (got, want)
        assert got[0] in (400, 401, 403, 404, 503), got
        assert ("Retry-After" in got[2]) == ("Retry-After" in want[2])
        assert got[2]["X-PIO-Request-Id"]
        # the servers keep serving, and the blown deadline's query still
        # answers when given its time
        assert _request(port_srv.port, "/healthz")[0] == 200

    def test_stats_keys_equal_jax_minus_the_left_out(self, pair):
        _, jax_srv, port_srv, queries = pair
        for srv in (jax_srv, port_srv):
            _concurrently(srv.port, queries[:4])
        got = _key_paths(_request(port_srv.port, "/stats.json")[1])
        want = _key_paths(_request(jax_srv.port, "/stats.json")[1])
        assert STATS_LEFT_OUT <= want
        assert got == want - STATS_LEFT_OUT

    def test_failed_reload_keeps_serving_the_old_instance(self, pair, monkeypatch):
        _, jax_srv, port_srv, queries = pair
        before = {srv: _answers(_request(srv.port, "/queries.json", queries[1]))
                  for srv in (jax_srv, port_srv)}

        def broken(*args, **kwargs):
            raise RuntimeError("model blob unreadable")

        monkeypatch.setattr(jserver_mod, "load_deployed_engine", broken)
        monkeypatch.setattr(pserver_mod, "load_deployed_engine", broken)
        codes = [_request(srv.port, f"/reload?accessKey={KEY}") for srv in (jax_srv, port_srv)]
        assert codes[0][0] == codes[1][0] == 503
        assert "Retry-After" in codes[1][2] and "still serving" in codes[1][1]["message"]
        for srv in (jax_srv, port_srv):
            assert _answers(_request(srv.port, "/queries.json", queries[1])) == before[srv]
            assert _request(srv.port, "/readyz")[0] == 200
        ports = _request(port_srv.port, "/stats.json")[1]["resilience"]
        jaxs = _request(jax_srv.port, "/stats.json")[1]["resilience"]
        assert ports["serving/reload"] == jaxs["serving/reload"]
        assert ports["serving/reload"]["fallbacks"] == 1
        assert _request(port_srv.port, "/")[1]["engineInstanceId"] == \
            port_srv.deployed.instance_id

    def test_plugins_json_equals_jax(self, pair):
        _, jax_srv, port_srv, _ = pair
        assert _request(port_srv.port, "/plugins.json")[1] == \
            _request(jax_srv.port, "/plugins.json")[1]


# -- the port alone ------------------------------------------------------------

class TestReload:
    def test_reload_swaps_moves_the_cache_generation_and_readyz(self, tmp_path):
        storage = memory_storage()
        old, _ = _als_models(seed=1)
        new, _ = _als_models(seed=1, scale=2.0)
        srv = _port_server(storage, REC, old, str(tmp_path / "old"))
        try:
            body = {"user": "u3", "num": 5}
            first = _answers(_request(srv.port, "/queries.json", body))
            assert _answers(_request(srv.port, "/queries.json", body)) == first   # a hit
            stats = _request(srv.port, "/stats.json")[1]
            assert stats["serving"]["cacheHits"] == 1 and stats["cache"]["generation"] == 0
            _save(new, str(tmp_path / "new"))
            newer = _store_instance(storage, *REC, str(tmp_path / "new"),
                                    start=datetime(2026, 2, 1, tzinfo=timezone.utc))
            assert _request(srv.port, "/reload")[0] == 401
            assert _request(srv.port, f"/reload?accessKey={KEY}")[:2] == (
                200, {"message": "Reloading"})
            assert _request(srv.port, "/readyz")[:2] == (
                200, {"status": "ready", "model": newer, "storage": "ok"})
            again = _answers(_request(srv.port, "/queries.json", body))
            assert [i for i, _ in again] == [i for i, _ in first]
            np.testing.assert_allclose([s for _, s in again], [2 * s for _, s in first],
                                       rtol=1e-6)
            stats = _request(srv.port, "/stats.json")[1]
            assert stats["cache"]["generation"] == 1
            assert stats["serving"]["cacheMisses"] == 2       # the repeat missed
            assert stats["serving"]["cacheInvalidations"] == 1
            assert stats["engineInstanceId"] == newer
        finally:
            srv.stop()

    def test_readyz_is_503_while_reloading(self, tmp_path, monkeypatch):
        model, _ = _als_models()
        srv = _port_server(memory_storage(), REC, model, str(tmp_path / "m"))
        entered, release = threading.Event(), threading.Event()
        real = pserver_mod.load_deployed_engine

        def slow_load(*args, **kwargs):
            entered.set()
            release.wait(10)
            return real(*args, **kwargs)

        monkeypatch.setattr(pserver_mod, "load_deployed_engine", slow_load)
        try:
            t = threading.Thread(target=_request, args=(srv.port, f"/reload?accessKey={KEY}"))
            t.start()
            assert entered.wait(10)
            status, doc, headers = _request(srv.port, "/readyz")
            assert (status, doc["status"]) == (503, "reloading") and "Retry-After" in headers
            assert _request(srv.port, "/queries.json", {"user": "u1"})[0] == 200
            release.set()
            t.join(10)
            assert _request(srv.port, "/readyz")[0] == 200
        finally:
            release.set()
            srv.stop()


class TestUnbatched:
    def test_one_query_at_a_time_and_the_deadline(self, tmp_path):
        """Unbatched, the deadline pool answers 503 at once, and a query
        whose budget ran out while it waited for the lock is not run."""
        model, _ = _als_models()
        srv = _port_server(memory_storage(), REC, model, str(tmp_path / "m"), batching=False)
        algo = srv.deployed.algorithms[0]
        calls = []
        real = algo.predict

        def predict(model, query):
            calls.append(query.user)
            if query.num == SLOW_NUM:
                time.sleep(SLOW_S)
            return real(model, query)

        algo.predict = predict
        try:
            slow = threading.Thread(target=_request, args=(
                srv.port, "/queries.json", {"user": "u1", "num": SLOW_NUM}))
            slow.start()
            time.sleep(0.1)                          # the slow query holds the lock
            t0 = time.monotonic()
            status, doc, headers = _request(srv.port, "/queries.json", {"user": "u2"},
                                            headers={"X-PIO-Deadline-Ms": "100"})
            assert status == 503 and "Retry-After" in headers
            assert time.monotonic() - t0 < SLOW_S
            slow.join(10)
            time.sleep(0.1)
            assert calls == ["u1"]                   # u2 never reached the model
            assert srv.service.serving_stats.count("expired") == 1
        finally:
            srv.stop()


class TestLaunchIdentity:
    def test_attention_calls_are_layers_times_popcounts(self, sessionrec_models, tmp_path,
                                                        monkeypatch):
        """What chip_smoke.py checks on the card: the batched server calls
        attention n_layers × popcount(n) times for a dispatched batch of
        n, and not at all for a cache hit."""
        _, _, model = sessionrec_models
        calls = []
        real = seqrec.flash_attention

        def counting(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        monkeypatch.setattr(seqrec, "flash_attention", counting)
        srv = _port_server(memory_storage(), SESS, model, str(tmp_path / "m"),
                           batch_wait_ms=50.0)
        try:
            bodies = [{"items": [f"i{j}" for j in range(n % 12 + 1)], "num": 3}
                      for n in range(11)]
            _concurrently(srv.port, bodies)
            _concurrently(srv.port, bodies)          # every one a hit
            stats = _request(srv.port, "/stats.json")[1]["serving"]
            hist = {int(n): c for n, c in stats["batchSizeHistogram"].items()}
            assert stats["cacheHits"] == 11
            assert len(calls) == model.cfg.n_layers * sum(
                c * bin(n).count("1") for n, c in hist.items())
        finally:
            srv.stop()


class TestPlugins:
    def test_blocker_transforms_and_sniffer_sees_every_query(self, tmp_path):
        model, _ = _als_models()
        seen = []

        class Top1(pserver_mod.EngineServerPlugin):
            plugin_name, plugin_type = "top1", pserver_mod.OUTPUT_BLOCKER

            def process(self, info, context):
                return dataclasses.replace(info.prediction,
                                           item_scores=info.prediction.item_scores[:1])

        class Sniffer(pserver_mod.EngineServerPlugin):
            plugin_name = "sniff"

            def process(self, info, context):
                seen.append(info.query.user)

        storage = memory_storage()
        iid = _store_instance(storage, *REC, str(tmp_path / "m"))
        model.save(str(tmp_path / "m"))
        srv = pserver_mod.create_engine_server(storage, ServerConfig(
            ip="127.0.0.1", port=0, device="cpu", engine_instance_id=iid),
            plugin_context=pserver_mod.EngineServerPluginContext([Top1(), Sniffer()])).start()
        try:
            for u in ("u1", "u2"):
                doc = _request(srv.port, "/queries.json", {"user": u, "num": 5})[1]
                assert len(doc["itemScores"]) == 1
            doc = _request(srv.port, "/queries.json", {"user": "u1"},
                           headers={"X-PIO-Experiment": "exp", "X-PIO-Variant": "v2"})[1]
            assert (doc["experimentId"], doc["variantId"]) == ("exp", "v2")
            deadline = time.monotonic() + 5
            while len(seen) < 3 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert seen == ["u1", "u2", "u1"]
            plugins = _request(srv.port, "/plugins.json")[1]["plugins"]
            assert set(plugins["outputblockers"]) == {"top1"}
            assert set(plugins["outputsniffers"]) == {"sniff"}
        finally:
            srv.stop()


class TestAccessLog:
    def test_one_json_line_per_request_with_the_echoed_id(self, tmp_path, monkeypatch):
        import logging

        records = []

        class Keep(logging.Handler):
            def emit(self, record):
                records.append(json.loads(record.getMessage()))

        handler = Keep()
        logging.getLogger("pio.access").addHandler(handler)
        monkeypatch.setenv("PIO_ACCESS_LOG", "1")
        model, _ = _als_models()
        srv = _port_server(memory_storage(), REC, model, str(tmp_path / "m"))
        try:
            status, _, headers = _request(srv.port, "/queries.json", {"user": "u1"},
                                          headers={"X-PIO-Request-Id": "req-42"})
            _request(srv.port, "/healthz", headers={"X-PIO-Request-Id": "bad id!"})
        finally:
            srv.stop()
            logging.getLogger("pio.access").removeHandler(handler)
        assert status == 200 and headers["X-PIO-Request-Id"] == "req-42"
        first, second = records
        assert (first["method"], first["path"], first["status"], first["request_id"]) == (
            "POST", "/queries.json", 200, "req-42")
        assert second["path"] == "/healthz" and second["request_id"] != "bad id!"


class TestStopAndUndeploy:
    def test_stop_needs_the_key_and_undeploy_stops(self, tmp_path):
        model, _ = _als_models()
        srv = _port_server(memory_storage(), REC, model, str(tmp_path / "m"))
        try:
            assert _request(srv.port, "/stop", raw=b"", method="POST")[0] == 401
            assert not srv.stopped.is_set()
            assert pserver_mod.undeploy("127.0.0.1", srv.port, KEY)
            assert srv.stopped.wait(10)
        finally:
            srv.stop()
        assert not pserver_mod.undeploy("127.0.0.1", 1)      # nothing listens on port 1

    def test_pio_undeploy_imports_no_torch(self, tmp_path):
        """`pio undeploy` is an administrative command: one POST, no torch."""
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("PIO_") and k != "PYTHONPATH"}
        env.update(PYTHONPATH=str(REPO), PIO_FS_BASEDIR=str(tmp_path / "store"))
        code = ("import sys\n"
                "from predictionio_tpu_torch.cli import pio\n"
                "rc = pio.main(['undeploy', '--ip', '127.0.0.1', '--port', '1'])\n"
                "print(rc, 'torch' in sys.modules)\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip().splitlines()[-1] == "1 False"

    def test_pio_deploy_flags_and_pio_undeploy(self, tmp_path):
        """`pio deploy --batching --cache --server-key` over a stored
        instance, then `pio undeploy`: both exit 0."""
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("PIO_") and k != "PYTHONPATH"}
        env.update(PYTHONPATH=str(REPO), PIO_FS_BASEDIR=str(tmp_path / "store"))
        from predictionio_tpu_torch.storage.registry import Storage

        storage = Storage({"PIO_FS_BASEDIR": env["PIO_FS_BASEDIR"]})
        model, _ = _als_models()
        _store_instance(storage, *REC, str(tmp_path / "m"))
        model.save(str(tmp_path / "m"))
        storage.close()
        pio = [sys.executable, "-m", "predictionio_tpu_torch.cli.pio"]
        log = open(tmp_path / "deploy.log", "w")
        proc = subprocess.Popen(
            pio + ["deploy", "--ip", "127.0.0.1", "--port", "0", "--device", "cpu",
                   "--engine-json", str(tmp_path / "none.json"), "--batching",
                   "--batch-max", "8", "--cache", "--server-key", KEY,
                   "--request-deadline-ms", "5000"],
            cwd=tmp_path, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 120
            port = None
            while port is None:
                text = (tmp_path / "deploy.log").read_text()
                found = [line for line in text.splitlines() if "listening on" in line]
                if found:
                    port = int(found[0].rsplit(":", 1)[1])
                    break
                assert proc.poll() is None and time.monotonic() < deadline, text
                time.sleep(0.2)
            status, doc, _ = _request(port, "/queries.json", {"user": "u1", "num": 3})
            assert status == 200 and len(doc["itemScores"]) == 3
            stats = _request(port, "/stats.json")[1]
            assert stats["batching"]["enabled"] and stats["batching"]["batchMax"] == 8
            assert stats["cache"]["enabled"]
            out = subprocess.run(pio + ["undeploy", "--ip", "127.0.0.1", "--port",
                                        str(port), "--server-key", KEY],
                                 cwd=tmp_path, env=env, capture_output=True, text=True,
                                 timeout=120)
            assert out.returncode == 0, out.stdout + out.stderr
            assert f"Undeployed engine server at 127.0.0.1:{port}" in out.stdout
            assert proc.wait(timeout=30) == 0
            # nothing listens on port 1 (the freed port may be reused)
            out = subprocess.run(pio + ["undeploy", "--ip", "127.0.0.1", "--port", "1"],
                                 cwd=tmp_path, env=env, capture_output=True, text=True,
                                 timeout=120)
            assert out.returncode == 1 and "[ERROR] No engine server running" in out.stdout
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            log.close()


# -- retrieval (ANN) side by side, through ``handle`` --------------------------

def _retrieval_pair(with_index: bool, retrieval: str):
    """(port EngineService, JAX EngineService) over one 1,500-item ALS
    model, with the same persisted-style index in both when
    ``with_index``, and ``retrieval`` applied as a deploy applies it."""
    from predictionio_tpu.ops import ann as jann
    from predictionio_tpu.workflow.deploy import apply_retrieval_config as japply

    from predictionio_tpu_torch.controller import FirstServing
    from predictionio_tpu_torch.ops import ann as pann
    from predictionio_tpu_torch.workflow.deploy import DeployedEngine, apply_retrieval_config

    pmodel, jmodel = _als_models(seed=3, items=1500)
    if with_index:
        jmodel.ann_index = jann.build_index(np.asarray(jmodel.item_factors))
        pmodel.ann_index = pann.build_index(pmodel.item_factors)
    common = dict(server_key=KEY, cache_enabled=True, retrieval=retrieval)
    pconfig = ServerConfig(device="cpu", **common)
    jconfig = JaxServerConfig(**common)
    pdep = DeployedEngine(prec.engine_factory(), "p", [prec.ALSAlgorithm(
        prec.ALSAlgorithmParams())], FirstServing(), [pmodel], torch.device("cpu"))
    jdep = JaxDeployedEngine(jrec.engine_factory(), JaxEngineInstance(
        id="j", status="COMPLETED", start_time=T0, completion_time=T0, engine_id="e",
        engine_version="1", engine_variant="e", engine_factory="jax"),
        [jrec.ALSAlgorithm(jrec.ALSAlgorithmParams())], JaxFirstServing(), [jmodel])
    apply_retrieval_config(pdep.models, pconfig)
    japply(jdep.models, jconfig)
    return (pserver_mod.EngineService(pdep, pconfig),
            jserver_mod.EngineService(jdep, jconfig))


def _post_both(services, path, body, params=None):
    port, jax = ((svc.handle("POST", path, params or {}, {}, body)) for svc in services)
    return port, jax


class TestRetrieval:
    def test_ann_answers_and_shortlist_histogram_equal_jax(self):
        services = _retrieval_pair(with_index=True, retrieval="ann")
        try:
            for svc in services:
                assert svc.ann_enabled()
            for u in range(12):
                body = {"user": f"u{u}", "num": (5, 10, 100)[u % 3]}
                if u % 4 == 0:
                    body["blackList"] = [f"i{j}" for j in range(0, 1500, 11)]
                port, jax = _post_both(services, "/queries.json", body)
                assert port[0] == jax[0] == 200
                _same_ranking([(s["item"], s["score"]) for s in port[1]["itemScores"]],
                              [(s["item"], s["score"]) for s in jax[1]["itemScores"]])
            pdoc, jdoc = (svc.handle("GET", "/stats.json", {}, {}, None)[1]
                          for svc in services)
            assert pdoc["annEnabled"] is jdoc["annEnabled"] is True
            assert pdoc["retrieval"] == jdoc["retrieval"] == "ann"
            for key in ("annQueries", "annRescored", "annShortlistHistogram"):
                assert pdoc["serving"][key] == jdoc["serving"][key], key
            assert pdoc["serving"]["annQueries"] == 12
            assert _key_paths(pdoc) == _key_paths(jdoc) - STATS_LEFT_OUT
        finally:
            for svc in services:
                svc.batcher is None or svc.batcher.close()

    def test_post_retrieval_statuses_and_bodies_equal_jax(self):
        services = _retrieval_pair(with_index=True, retrieval="ann")
        key = {"accessKey": KEY}
        cases = [({}, {"retrieval": "brute"}), (key, [1]), (key, {"nprobe": 3}),
                 (key, {"retrieval": "fast"}), (key, {"retrieval": "brute"}),
                 (key, {"retrieval": "ann", "annNprobe": -1}),
                 (key, {"retrieval": "ann", "annNprobe": "4"}),
                 (key, {"retrieval": "ann", "annNprobe": 4, "annRescore": 64})]
        query = {"user": "u2", "num": 10}
        for params, body in cases:
            _post_both(services, "/queries.json", query)       # warm the cache
            gens = [svc.cache.generation for svc in services]
            port, jax = _post_both(services, "/retrieval", body, params)
            assert port[:2] == jax[:2], (params, body)
            moved = [svc.cache.generation != g for svc, g in zip(services, gens)]
            assert moved[0] == moved[1] == (port[0] == 200)
            assert services[0].config.retrieval == services[1].config.retrieval
            assert services[0].config.ann_nprobe == services[1].config.ann_nprobe
            port, jax = _post_both(services, "/queries.json", query)
            _same_ranking([(s["item"], s["score"]) for s in port[1]["itemScores"]],
                          [(s["item"], s["score"]) for s in jax[1]["itemScores"]])
        assert [c[0] for c in (_post_both(services, "/retrieval", {"retrieval": "brute"},
                                          key))] == [200, 200]
        width = services[0].deployed.models[0].ann_index.shortlist_width(4, 64)
        hist = services[0].serving_stats.ann_histogram()
        assert hist == services[1].serving_stats.ann_histogram() and hist[width] >= 1

    def test_switch_to_ann_without_an_index_is_409_in_both(self):
        services = _retrieval_pair(with_index=False, retrieval="brute")
        port, jax = _post_both(services, "/retrieval", {"retrieval": "ann"},
                               {"accessKey": KEY})
        assert port[:2] == jax[:2] and port[0] == 409
        assert not services[0].ann_enabled() and services[0].config.retrieval == "brute"
