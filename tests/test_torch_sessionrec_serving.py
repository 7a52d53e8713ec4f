"""The port's sessionrec serving slice, end to end on the CPU.

A tiny JAX ``SeqRecAlgorithm`` is trained on the CPU; its arrays are
carried into the port's ``SeqRecEngineModel``, saved, deployed through
the port's engine server with ``device="cpu"``, and its /queries.json
answers are held against JAX ``SeqRecAlgorithm.predict`` on the same
queries: in f32 the same items (where scores are distinct) with scores
within 1e-4; in the template's default bf16 the same top item and
scores within 0.05 (bf16 rounding steps, see tests/test_torch_seqrec.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.controller.params import params_from_json as jax_params_from_json
from predictionio_tpu.core import wire as jax_wire
from predictionio_tpu.templates import sessionrec as jsess
from predictionio_tpu_torch.api.engine_server import create_engine_server
from predictionio_tpu_torch.controller import EngineParams, params_from_json
from predictionio_tpu_torch.core import wire
from predictionio_tpu_torch.models import seqrec
from predictionio_tpu_torch.templates import sessionrec
from predictionio_tpu_torch.workflow.deploy import ServerConfig, load_model_dir

REPO = Path(__file__).resolve().parent.parent
CYCLE = 10


@pytest.fixture(scope="module")
def jax_trained():
    """(JAX algorithm, JAX engine model): every user walks the same item
    cycle from a random start — a learnable next-item structure."""
    rng = np.random.default_rng(0)
    sequences = {}
    for u in range(24):
        start = int(rng.integers(CYCLE))
        sequences[f"u{u}"] = [f"i{(start + t) % CYCLE}" for t in range(8)]
    algo = jsess.SeqRecAlgorithm(jsess.AlgorithmParams(
        d_model=32, n_heads=2, n_layers=1, max_len=16, epochs=8,
        batch_size=16, lr=3e-3, seed=0, use_mesh=False))
    model = algo.train(None, jsess.TrainingData(sequences=sequences))
    return algo, model


def _port_model(jmodel, device="cpu"):
    return sessionrec.SeqRecEngineModel.from_jax(
        jmodel.params, dataclasses.asdict(jmodel.cfg), jmodel.item_index.to_dict(),
        jmodel.histories, device=device)


@pytest.fixture
def serve(tmp_path):
    """Start the port's server on a saved model; yields a POST helper."""
    servers = []

    def start(model, name="model"):
        model_dir = tmp_path / name
        sessionrec.save_engine_model(model, str(model_dir))
        srv = create_engine_server(config=ServerConfig(
            model_dir=str(model_dir), ip="127.0.0.1", port=0, device="cpu")).start()
        servers.append(srv)
        return srv

    yield start
    for srv in servers:
        srv.stop()


def _request(srv, path, body=None, raw=None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


QUERIES = [
    {"user": "u0", "num": 3},
    {"user": "u5", "num": 2, "blackList": ["i1", "i2"]},
    {"items": ["i3", "i4", "i5"], "num": 4},
    {"items": ["i7", "nope"], "num": 1},
    {"user": "u9", "num": 20},
]


def _jax_answer(algo, jmodel, body):
    q = jax_wire.from_wire(jsess.Query, body)
    return [(s.item, s.score) for s in algo.predict(jmodel, q).item_scores]


class TestServingVsJax:
    """(d) the port's server answers what JAX SeqRecAlgorithm.predict answers."""

    def test_f32_answers_equal_jax(self, jax_trained, serve):
        algo, jmodel = jax_trained
        jmodel32 = dataclasses.replace(
            jmodel, cfg=dataclasses.replace(jmodel.cfg, dtype=jnp.float32), device_tree=None)
        srv = serve(_port_model(jmodel32))
        for body in QUERIES:
            status, doc = _request(srv, "/queries.json", body)
            assert status == 200, doc
            got = [(s["item"], s["score"]) for s in doc["itemScores"]]
            want = _jax_answer(algo, jmodel32, body)
            assert len(got) == len(want) > 0
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-4)
            scores = [s for _, s in want]
            for n, ((gi, _), (wi, ws)) in enumerate(zip(got, want)):
                neighbours = scores[max(n - 1, 0):n] + scores[n + 1:n + 2]
                if all(abs(ws - s) > 1e-4 for s in neighbours):
                    assert gi == wi, (body, got, want)

    def test_bf16_answers_match_jax(self, jax_trained, serve):
        algo, jmodel = jax_trained
        srv = serve(_port_model(jmodel))
        for body in QUERIES:
            status, doc = _request(srv, "/queries.json", body)
            assert status == 200, doc
            got = [(s["item"], s["score"]) for s in doc["itemScores"]]
            want = _jax_answer(algo, jmodel, body)
            assert len(got) == len(want)
            assert got[0][0] == want[0][0]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=0.05)

    def test_predict_and_batch_predict_agree(self, jax_trained):
        _, jmodel = jax_trained
        model = _port_model(jmodel)
        algo = sessionrec.SeqRecAlgorithm()
        queries = [wire.from_wire(sessionrec.Query, b) for b in QUERIES]
        batched = dict(algo.batch_predict(model, list(enumerate(queries))))
        for i, q in enumerate(queries):
            single = algo.predict(model, q)
            assert [s.item for s in single.item_scores] == \
                [s.item for s in batched[i].item_scores]

    def test_never_serves_history_or_black_list(self, jax_trained):
        _, jmodel = jax_trained
        model = _port_model(jmodel)
        algo = sessionrec.SeqRecAlgorithm()
        hist = {model.item_index.inverse[i] for i in model.histories["u3"]}
        out = algo.predict(model, sessionrec.Query(user="u3", num=20, black_list=("i0",)))
        served = {s.item for s in out.item_scores}
        assert served and not served & (hist | {"i0"})
        assert served | hist | {"i0"} == {f"i{n}" for n in range(CYCLE)}


class TestServer:
    def test_status_health_and_errors(self, jax_trained, serve):
        _, jmodel = jax_trained
        srv = serve(_port_model(jmodel))
        status, doc = _request(srv, "/")
        assert status == 200 and doc["status"] == "alive" and doc["device"] == "cpu"
        assert isinstance(doc["kernelLaunches"]["flash_attention"], int)
        assert _request(srv, "/healthz") == (200, {"status": "ok"})
        assert _request(srv, "/nope")[0] == 404
        assert _request(srv, "/queries.json", {"user": "u0", "bogus": 1})[0] == 400
        assert _request(srv, "/queries.json", [1, 2])[0] == 400
        assert _request(srv, "/queries.json", raw=b"{not json")[0] == 400
        status, doc = _request(srv, "/queries.json", {"user": "stranger"})
        assert status == 200 and doc == {"itemScores": []}
        _request(srv, "/queries.json", {"user": "u1"})
        assert _request(srv, "/")[1]["requestCount"] == 2

    def test_cpu_serving_launches_no_kernel(self, jax_trained, serve):
        from predictionio_tpu_torch.ops import flash_attention as flash_ops

        _, jmodel = jax_trained
        srv = serve(_port_model(jmodel))
        before = flash_ops.LAUNCHES
        assert _request(srv, "/queries.json", {"user": "u2"})[0] == 200
        assert flash_ops.LAUNCHES == before

    def test_cli_entry_serves(self, jax_trained, tmp_path):
        _, jmodel = jax_trained
        sessionrec.save_engine_model(_port_model(jmodel), str(tmp_path / "m"))
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {**os.environ, "PYTHONPATH": str(REPO)}
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.api.engine_server",
             "--model-dir", str(tmp_path / "m"), "--ip", "127.0.0.1",
             "--port", str(port), "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        try:
            import time

            deadline = time.monotonic() + 60
            while True:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                                timeout=5) as r:
                        assert r.status == 200
                        break
                except OSError:
                    assert proc.poll() is None and time.monotonic() < deadline
                    time.sleep(0.2)
            req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                         data=b'{"user": "u0", "num": 2}', method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert len(json.loads(r.read())["itemScores"]) == 2
        finally:
            proc.terminate()
            proc.wait(timeout=30)
        assert proc.returncode is not None


class TestModelPersistenceAndDeploy:
    def test_save_load_round_trip(self, jax_trained, tmp_path):
        _, jmodel = jax_trained
        model = _port_model(jmodel)
        sessionrec.save_engine_model(model, str(tmp_path))
        assert sorted(os.listdir(tmp_path)) == ["model.json", "params.npz"]
        back = sessionrec.load_engine_model(str(tmp_path), device="cpu")
        assert back.cfg == model.cfg and back.item_index == model.item_index
        assert back.histories == model.histories
        assert all(torch.equal(back.params[k], model.params[k]) for k in model.params)

    def test_load_defaults_to_cuda(self, jax_trained, tmp_path, monkeypatch):
        _, jmodel = jax_trained
        sessionrec.save_engine_model(_port_model(jmodel), str(tmp_path))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            load_model_dir(str(tmp_path))

    def test_deploy_with_engine_params(self, jax_trained, tmp_path):
        _, jmodel = jax_trained
        sessionrec.save_engine_model(_port_model(jmodel), str(tmp_path))
        ep = EngineParams.of(algorithms=[("seqrec", sessionrec.AlgorithmParams(d_model=16))])
        ep = dataclasses.replace(
            ep, data_source_params=("", sessionrec.DataSourceParams(app_name="A")))
        deployed = load_model_dir(str(tmp_path), ep, device="cpu")
        assert deployed.query_class is sessionrec.Query
        out = deployed.query_batch([sessionrec.Query(user="u0", num=2),
                                    sessionrec.Query(user="none")])
        assert len(out[0].item_scores) == 2 and out[1].item_scores == ()
        assert deployed.request_count == 2

    def test_init_engine_model_and_train_not_ported(self):
        cfg = seqrec.SeqRecConfig(vocab=4, max_len=8, d_model=16, n_heads=1, n_layers=1)
        model = sessionrec.init_engine_model(cfg, ["a", "b", "c"], {"u": ["a", "c"]},
                                             seed=3, device="cpu")
        assert model.histories == {"u": [1, 3]}
        out = sessionrec.SeqRecAlgorithm().predict(model, sessionrec.Query(user="u"))
        assert [s.item for s in out.item_scores] == ["b"]
        with pytest.raises(ValueError):
            sessionrec.init_engine_model(cfg, ["a"], {}, device="cpu")
        # training and evaluation are ported (tests/test_torch_sessionrec_{train,eval}.py):
        # read_eval holds out each user's last item
        from predictionio_tpu_torch.core.event import Event
        from predictionio_tpu_torch.storage.base import App
        from predictionio_tpu_torch.storage.registry import memory_storage
        from predictionio_tpu_torch.workflow.context import EngineContext

        storage = memory_storage()
        app_id = storage.get_meta_data_apps().insert(App(0, "A"))
        storage.get_events().insert_batch(
            [Event("view", "user", "u", "item", i, event_id=i) for i in "abc"], app_id)
        (td, ei, qa), = sessionrec.SessionDataSource(
            sessionrec.DataSourceParams(app_name="A")).read_eval(
                EngineContext(storage=storage, device="cpu"))
        assert td.sequences == {"u": ["a", "b"]} and qa == [(sessionrec.Query(user="u"), "c")]


class TestControllerCopies:
    """The copied host layers bind exactly as the JAX package's."""

    @pytest.mark.parametrize("obj", [
        {}, {"dModel": 32, "nLayers": 3}, {"max_len": 128, "lr": 0.01},
        {"useMesh": False, "checkpointDir": "x"}])
    def test_params_from_json(self, obj):
        got = params_from_json(sessionrec.AlgorithmParams, obj)
        want = jax_params_from_json(jsess.AlgorithmParams, obj)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)

    def test_params_from_json_rejects_unknown(self):
        with pytest.raises(ValueError, match="Unknown"):
            params_from_json(sessionrec.AlgorithmParams, {"dmodel": 1})

    @pytest.mark.parametrize("body", QUERIES)
    def test_wire_binding(self, body):
        got = wire.from_wire(sessionrec.Query, body)
        want = jax_wire.from_wire(jsess.Query, body)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        result = sessionrec.PredictedResult((sessionrec.ItemScore("i1", 0.5),))
        assert wire.to_wire(result) == {"itemScores": [{"item": "i1", "score": 0.5}]}


class TestIndependence:
    """(e) the port and chip_smoke.py import neither JAX nor the JAX package."""

    def test_import_leaves_jax_out(self):
        code = (
            "import importlib, pkgutil, sys\n"
            "import predictionio_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
            "             or n == 'predictionio_tpu' or n.startswith('predictionio_tpu.'))\n"
            "want = ['ops.als', 'ops.topk', 'models.als', 'utils.checkpoint',\n"
            "        'templates.recommendation', 'templates.sessionrec', 'models.seqrec',\n"
            "        'controller.metrics', 'controller.evaluation', 'controller.fast_eval',\n"
            "        'workflow.evaluation', 'core.columns', 'core.aggregation',\n"
            "        'core.json_codec', 'storage.sqlite', 'storage.localfs',\n"
            "        'storage.memory', 'storage.registry', 'controller.persistent_model',\n"
            "        'workflow.persistence', 'workflow.train', 'workflow.deploy',\n"
            "        'workflow.engine_json', 'tools.export_import', 'cli.pio',\n"
            "        'api.engine_server', 'data.store', 'api.http_base', 'api.stats',\n"
            "        'obs.histogram', 'serving.batch_policy', 'serving.batcher',\n"
            "        'serving.result_cache', 'utils.resilience', 'utils.ssl_config',\n"
            "        'api.event_server', 'api.plugins', 'api.webhooks', 'data.wal',\n"
            "        'native', 'storage.binevents', 'storage.fileevents',\n"
            "        'controller.algorithm', 'templates.similarproduct',\n"
            "        'templates.ecommerce', 'templates.classification',\n"
            "        'models.naive_bayes', 'models.logreg', 'models.random_forest',\n"
            "        'utils.reflection', 'fleet.supervisor', 'experiment.grid',\n"
            "        'workflow.fake', 'data.movielens', 'e2.engine', 'e2.evaluation',\n"
            "        'e2.quality', 'obs', 'obs.trace', 'obs.registry', 'obs.exporter',\n"
            "        'obs.slo', 'obs.compile', 'obs.device', 'obs.aggregate',\n"
            "        'fleet.transport', 'fleet.workers', 'serving.workers',\n"
            "        'serving.placement', 'serving.shm_cache', 'utils.envcfg',\n"
            "        'online.service', 'online.overlay', 'obs.stitch',\n"
            "        'fleet.canary', 'fleet.stats', 'fleet.membership', 'fleet.router',\n"
            "        'fleet.gateway', 'fleet.controller', 'experiment.controller',\n"
            "        'experiment.cli', 'api.router_server']\n"
            "missing = [m for m in want if 'predictionio_tpu_torch.' + m not in sys.modules]\n"
            "print('BAD', bad, 'NOT IMPORTED', missing)\n"
            "sys.exit(1 if bad or missing else 0)\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(REPO)
        p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode == 0, p.stdout + p.stderr

    def test_no_jax_imports_in_sources(self):
        files = list((REPO / "predictionio_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
        pattern = re.compile(r"^\s*(import jax|from jax)|predictionio_tpu\.", re.M)
        offenders = [str(f) for f in files if pattern.search(f.read_text())]
        assert not offenders
