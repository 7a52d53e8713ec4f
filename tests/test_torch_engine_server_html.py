"""The engine server's ``GET /`` content negotiation, in both packages:
a browser's ``Accept: text/html`` gets the HTML status page and an API
client gets the JSON document. Both servers serve the JAX tests' sample
engine (``tests/sample_engine.py``; the port's copy is
``tests/test_torch_evaluation.py``'s) trained the same way, and answer
the same two requests.
"""

from __future__ import annotations

import json
import urllib.request

import pytest

from predictionio_tpu.api.engine_server import create_engine_server as jax_create_server
from predictionio_tpu.controller import EngineParams as JaxEngineParams
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu.workflow.deploy import ServerConfig as JaxServerConfig
from predictionio_tpu.workflow.train import run_train as jax_run_train
from predictionio_tpu_torch.api.engine_server import create_engine_server
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.workflow.context import EngineContext
from predictionio_tpu_torch.workflow.deploy import ServerConfig
from predictionio_tpu_torch.workflow.train import run_train
from tests import sample_engine as jax_sample
from tests import test_torch_evaluation as port_sample

HTML_ACCEPT = "text/html,application/xhtml+xml"
JSON_ACCEPT = "application/json"


def engine_factory():
    """The port's sample engine, as an engine factory spec can name it."""
    return port_sample.make_engine()


def _jax_server():
    storage = jax_memory_storage()
    jax_run_train(
        engine_factory="tests.sample_engine.engine_factory",
        engine_params=JaxEngineParams.of(
            data_source=jax_sample.DSParams(id=7, n_train=5),
            algorithms=[("sample", jax_sample.AlgoParams(id=0, mult=2))]),
        variant={"id": "sample-engine"}, storage=storage)
    return jax_create_server(storage=storage,
                             config=JaxServerConfig(ip="127.0.0.1", port=0))


def _port_server():
    storage = memory_storage()
    run_train(
        engine_factory="tests.test_torch_engine_server_html.engine_factory",
        engine_params=EngineParams.of(
            data_source=port_sample.DSParams(id=7, n_train=5),
            algorithms=[("sample", port_sample.AlgoParams(id=0, mult=2))]),
        variant={"id": "sample-engine"}, storage=storage,
        ctx=EngineContext(storage=storage, device="cpu"))
    return create_engine_server(storage=storage,
                                config=ServerConfig(ip="127.0.0.1", port=0, device="cpu"))


@pytest.fixture(scope="module")
def both():
    jax_srv, port_srv = _jax_server(), _port_server()
    jax_srv.start()
    port_srv.start()
    yield {"jax": jax_srv, "port": port_srv}
    jax_srv.stop()
    port_srv.stop()


def _get(server, accept: str) -> tuple[int, str, str]:
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/",
                                 headers={"Accept": accept})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


@pytest.mark.parametrize("accept", [HTML_ACCEPT, JSON_ACCEPT])
def test_status_content_type_equals_jax(both, accept):
    jax_status, jax_ctype, _ = _get(both["jax"], accept)
    port_status, port_ctype, _ = _get(both["port"], accept)
    assert port_status == jax_status == 200
    assert port_ctype == jax_ctype


@pytest.mark.parametrize("side", ["jax", "port"])
def test_status_html_negotiation(both, side):
    """Browsers get the HTML index page; API clients keep JSON."""
    _, ctype, page = _get(both[side], HTML_ACCEPT)
    assert ctype.startswith("text/html")
    assert "<html>" in page and "Engine instance" in page
    assert "SampleAlgorithm" in page
    _, ctype, body = _get(both[side], JSON_ACCEPT)
    assert ctype.startswith("application/json")
    doc = json.loads(body)
    assert doc["status"] == "alive" and doc["algorithms"] == ["SampleAlgorithm"]


def test_html_page_holds_the_status_doc(both):
    """Every key of the JSON status document is a row of the page, and
    the heading names the served instance."""
    _, _, page = _get(both["port"], HTML_ACCEPT)
    _, _, body = _get(both["port"], JSON_ACCEPT)
    doc = json.loads(body)
    for key in ("status", "engineInstanceId", "engineFactory", "algorithms", "requestCount"):
        assert f"<tr><th>{key}</th>" in page
    assert f"<h1>Engine instance {doc['engineInstanceId']}</h1>" in page
