"""The port's observability plane (``predictionio_tpu_torch/obs/``) beside
the JAX package's, on the CPU (lanes: tests/test_observability.py and
tests/test_compile_obs.py).

Same inputs through both packages:

- ``render_prometheus`` gives byte-identical text for registries filled
  alike, with hypothesis-made label values that need escaping;
- ``parse_trace_context`` gives the same answers on one table of headers;
- ``Trace.to_dict`` has the same structure under one injected clock;
- ``SLOEngine`` burn rates (and ``fleet_pressure``) agree within 1e-12
  under ``ManualClock``;
- ``summarize_train_report`` prints the same line for one report;
- an engine server and an event server of each package, tracing on,
  give the same span-name sequences per route (cache hit, batched,
  unbatched, fallback; single, batch and journaled ingest, WAL replay),
  and their ``/metrics`` bodies carry the same family names and types.
"""

from __future__ import annotations

import json
import math
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from predictionio_tpu.api import engine_server as jengine
from predictionio_tpu.api import event_server as jes
from predictionio_tpu.controller import FirstServing as JaxFirstServing
from predictionio_tpu.experiment import grid as jgrid
from predictionio_tpu.models import als as jmodels
from predictionio_tpu.obs import compile as jcompile
from predictionio_tpu.obs import device as jdevice
from predictionio_tpu.obs import exporter as jexporter
from predictionio_tpu.obs import histogram as jhistogram
from predictionio_tpu.obs import registry as jregistry
from predictionio_tpu.obs import slo as jslo
from predictionio_tpu.obs import trace as jtrace
from predictionio_tpu.storage.base import AccessKey as JaxAccessKey
from predictionio_tpu.storage.base import App as JaxApp
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
from predictionio_tpu_torch.controller import PersistentModelManifest
from predictionio_tpu_torch.experiment import grid as pgrid
from predictionio_tpu_torch.models import als as pmodels
from predictionio_tpu_torch.obs import compile as pcompile
from predictionio_tpu_torch.obs import device as pdevice
from predictionio_tpu_torch.obs import exporter as pexporter
from predictionio_tpu_torch.obs import histogram as phistogram
from predictionio_tpu_torch.obs import registry as pregistry
from predictionio_tpu_torch.obs import slo as pslo
from predictionio_tpu_torch.obs import trace as ptrace
from predictionio_tpu_torch.storage.base import AccessKey, App, EngineInstance
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.utils import resilience
from predictionio_tpu_torch.workflow.deploy import ServerConfig
from predictionio_tpu_torch.workflow.persistence import save_models

pytestmark = pytest.mark.obs

T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
KEY = "obs-key"
BURN_TOL = 1e-12
#: families of the JAX event server that the port leaves out: the
#: experiment conversion counters (ROADMAP.md queue 1 item 23)
EVENT_FAMILIES_LEFT_OUT = {("pio_experiment_conversions_ingested_total", "counter")}

BOTH = {"jax": (jregistry, jexporter, jhistogram),
        "port": (pregistry, pexporter, phistogram)}


@pytest.fixture(autouse=True)
def _fresh_registries(monkeypatch):
    """Fresh resilience counters and cold build/compile recorders in both
    packages: a recorder left past warmup by an earlier test in this
    process would add a compile span to a JAX query's trace."""
    for mod in (jcompile, pcompile):
        monkeypatch.setattr(mod, "_GLOBAL_RECORDER", mod.CompileRecorder())
    resilience.reset_registry()
    jresilience.reset_registry()
    yield
    resilience.reset_registry()
    jresilience.reset_registry()


# -- exporter ----------------------------------------------------------------

_label_text = st.text(alphabet=st.sampled_from(list('ab\\"\n z=,{}é')), max_size=12)


def _filled(pkg: str, labels: list[str], values: list[float], seconds: list[float]) -> str:
    """One registry of ``pkg`` filled with a counter, a gauge, a latency
    histogram family and a count-table histogram, rendered."""
    registry_mod, exporter_mod, histogram_mod = BOTH[pkg]
    Metric = registry_mod.Metric
    reg = registry_mod.MetricRegistry()
    fam = registry_mod.HistogramFamily("pio_x_seconds", "latency\nby route", "route",
                                       ("a", "b"))
    for i, s in enumerate(seconds):
        fam.observe(("a", "b", "zz")[i % 3], s)
    hist = histogram_mod.LatencyHistogram()
    hist.observe_many(seconds)
    counts = {int(v) % 7 + 1: i + 1 for i, v in enumerate(values)}
    reg.register(fam.collect)
    reg.register(lambda: [
        Metric("pio_c_total", "counter", 'a "counter" \\ help',
               samples=[({"k": lab, "n": str(i)}, v)
                        for i, (lab, v) in enumerate(zip(labels, values))]),
        Metric("pio_g", "gauge", "gauge", samples=[({}, v) for v in values[:1]]),
        Metric("pio_h", "histogram", "hist", histograms=[({"who": labels[0] if labels else ""},
                                                          hist.snapshot())]),
        Metric("pio_sizes", "histogram", "sizes",
               histograms=[({}, registry_mod.counts_to_snapshot(counts))]),
    ])
    # a second collector on a shared name folds into one family
    reg.register(lambda: [Metric("pio_c_total", "counter", "ignored",
                                 samples=[({"k": "extra"}, 1.5)])])
    return exporter_mod.render_prometheus(reg)


@settings(max_examples=60, deadline=None)
@given(labels=st.lists(_label_text, min_size=1, max_size=5),
       values=st.lists(st.floats(min_value=-1e6, max_value=1e6, allow_nan=False),
                       min_size=1, max_size=5),
       seconds=st.lists(st.floats(min_value=0.0, max_value=30.0), max_size=20))
def test_render_prometheus_is_byte_identical(labels, values, seconds):
    assert _filled("port", labels, values, seconds) == _filled("jax", labels, values, seconds)


@pytest.mark.parametrize("value", ['plain', 'back\\slash', 'quo"te', 'new\nline',
                                   '\\"\n', ''])
def test_escape_label_value_matches_jax(value):
    assert pexporter.escape_label_value(value) == jexporter.escape_label_value(value)


def test_exporter_content_type_and_empty_registry_match_jax():
    assert pexporter.CONTENT_TYPE == jexporter.CONTENT_TYPE
    assert (pexporter.render_prometheus(pregistry.MetricRegistry())
            == jexporter.render_prometheus(jregistry.MetricRegistry()))


def test_kind_mismatch_on_one_name_fails_loud_in_both():
    for registry_mod in (pregistry, jregistry):
        reg = registry_mod.MetricRegistry()
        reg.register(lambda m=registry_mod.Metric: [m("x", "counter", "h")])
        reg.register(lambda m=registry_mod.Metric: [m("x", "gauge", "h")])
        with pytest.raises(ValueError, match="registered as both"):
            reg.collect()


# -- trace context -----------------------------------------------------------

HEADER_TABLE = [
    {},
    {"X-PIO-Trace-Id": "abc123"},
    {"x-pio-trace-id": "abc123", "x-pio-parent-span": "s1.2"},
    {"X-PIO-Trace-Id": "has space"},
    {"X-PIO-Trace-Id": "a" * 128, "X-PIO-Parent-Span": "b" * 129},
    {"X-PIO-Trace-Id": 'quo"te', "X-PIO-Parent-Span": "ok:1-2_3.4"},
    {"X-PIO-Trace-Id": "", "X-PIO-Parent-Span": "p"},
    {"X-PIO-Trace-Id": "new\nline"},
    {"X-PIO-Parent-Span": "only-parent"},
]


@pytest.mark.parametrize("headers", HEADER_TABLE)
def test_parse_trace_context_matches_jax(headers):
    assert ptrace.parse_trace_context(headers) == jtrace.parse_trace_context(headers)


@pytest.mark.parametrize("raw,want", [(None, False), ("1", True), ("true", True),
                                      (" ON ", True), ("yes", True), ("0", False),
                                      ("off", False)])
def test_tracing_default_reads_pio_trace_like_jax(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("PIO_TRACE", raising=False)
    else:
        monkeypatch.setenv("PIO_TRACE", raw)
    assert ptrace.tracing_default() is jtrace.tracing_default() is want


class _Clock:
    """One injected clock for ``time.perf_counter`` and ``time.time``."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        self.now += 0.00125
        return self.now


def _masked(doc: dict) -> dict:
    """``to_dict`` with the drawn ids replaced by their position."""
    ids = {s["spanId"]: f"span{i}" for i, s in enumerate(doc["spans"])}
    out = dict(doc, traceId="trace")
    out["spans"] = [{**s, "spanId": ids[s["spanId"]],
                     **({"parentId": ids.get(s["parentId"], "remote")}
                        if "parentId" in s else {})} for s in doc["spans"]]
    return out


def _traced(trace_mod) -> dict:
    tr = trace_mod.start_trace("queries.json", request_id="r1", parent_span_id="remote",
                               service="engine")
    with trace_mod.use_trace(tr):
        with trace_mod.span("parse") as outer:
            pass
        with tr.span("bind", parent_id=outer.span_id):
            pass
    reserved = tr.reserve_span_id()
    t = time.perf_counter()
    tr.add_span("batcher.queue_wait", t - 0.002, t)
    tr.add_span("feedback", t, t + 0.004, span_id=reserved)
    # no ambient trace: a shared no-op
    with trace_mod.span("dropped"):
        pass
    tr.finish(status=200)
    return tr.to_dict()


def test_trace_to_dict_has_jax_structure_under_one_clock(monkeypatch):
    docs = {}
    for name, mod in (("jax", jtrace), ("port", ptrace)):
        clock = _Clock()
        monkeypatch.setattr(time, "perf_counter", clock)
        monkeypatch.setattr(time, "time", clock)
        docs[name] = _traced(mod)
    assert _masked(docs["port"]) == _masked(docs["jax"])
    assert [s["name"] for s in docs["port"]["spans"]] == [
        "parse", "bind", "batcher.queue_wait", "feedback"]


def test_trace_log_and_stage_seconds_match_jax():
    for mod in (ptrace, jtrace):
        log = mod.TraceLog(maxlen=2)
        traces = [mod.Trace(f"t{i}") for i in range(3)]
        for tr in traces:
            tr.add_span("read", 1.0, 1.5)
            tr.add_span("read", 2.0, 2.25)
            tr.add_span("train", 3.0, 4.0)
            log.record(tr)
        assert traces[0].stage_seconds() == {"read": 0.75, "train": 1.0}
        assert [d["name"] for d in log.snapshot()] == ["t2", "t1"]
        assert log.recorded == 3
        assert log.find(traces[1].trace_id)[0]["name"] == "t1"


# -- SLO engine --------------------------------------------------------------

OUTCOMES = st.lists(st.tuples(st.booleans(), st.floats(0.0, 2.0), st.integers(0, 400)),
                    max_size=60)


def _burns(slo_mod, clock_mod, objectives, windows, outcomes):
    clock = clock_mod.ManualClock(50.0)
    engine = slo_mod.SLOEngine(objectives, windows, clock=clock)
    for ok, latency, advance in outcomes:
        clock.advance(advance)
        engine.record(ok, latency)
    return engine.burn_rates(), engine.max_burns()


@settings(max_examples=80, deadline=None)
@given(outcomes=OUTCOMES, target=st.floats(0.5, 0.9999), threshold=st.floats(1.0, 1500.0))
def test_slo_burn_rates_agree_within_1e_12(outcomes, target, threshold):
    windows = (("fast", 300.0), ("slow", 3600.0))
    burns = {}
    for name, slo_mod, clock_mod in (("jax", jslo, jresilience), ("port", pslo, resilience)):
        objectives = (slo_mod.SLOObjective("availability", target),
                      slo_mod.SLOObjective(f"latency_{threshold:g}ms", 0.99,
                                           kind=slo_mod.LATENCY, threshold_ms=threshold))
        burns[name] = _burns(slo_mod, clock_mod, objectives, windows, outcomes)
    (jrates, jmax), (prates, pmax) = burns["jax"], burns["port"]
    assert prates.keys() == jrates.keys() and pmax.keys() == jmax.keys()
    for key in jrates:
        assert abs(prates[key] - jrates[key]) <= BURN_TOL
    for key in jmax:
        assert abs(pmax[key] - jmax[key]) <= BURN_TOL


def test_slo_defaults_and_collector_match_jax(monkeypatch):
    monkeypatch.setenv("PIO_SLO_LATENCY_MS", "250")
    monkeypatch.setenv("PIO_SLO_FAST_WINDOW_S", "60")
    assert ([dict(vars(o)) for o in pslo.default_slos()]
            == [dict(vars(o)) for o in jslo.default_slos()])
    assert pslo.default_windows() == jslo.default_windows()
    texts = []
    for slo_mod, clock_mod, exporter_mod in ((pslo, resilience, pexporter),
                                             (jslo, jresilience, jexporter)):
        clock = clock_mod.ManualClock(10.0)
        engine = slo_mod.SLOEngine(clock=clock)
        for i in range(40):
            engine.record(i % 7 != 0, 0.1 * (i % 5))
            clock.advance(3)
        texts.append(exporter_mod.render_metrics(
            engine.collector()() + [slo_mod.labeled_burn_metric([({"engine": "e1"}, engine)])]))
    assert texts[0] == texts[1]
    assert 'pio_slo_burn_rate{engine="e1",slo="availability",window="fast"}' in texts[0]


@pytest.mark.parametrize("bad", [dict(target=1.0), dict(target=0.0),
                                 dict(target=0.9, kind="nope"),
                                 dict(target=0.9, kind="latency")])
def test_slo_objective_validation_matches_jax(bad):
    for slo_mod in (pslo, jslo):
        with pytest.raises(ValueError):
            slo_mod.SLOObjective("x", **bad)


@settings(max_examples=40, deadline=None)
@given(waits=st.lists(st.floats(0.0, 5.0), max_size=30),
       device=st.lists(st.floats(0.0, 5.0), max_size=30))
def test_fleet_pressure_agrees_on_the_same_snapshots(waits, device):
    got = []
    for slo_mod, histogram_mod, exporter_mod in ((pslo, phistogram, pexporter),
                                                 (jslo, jhistogram, jexporter)):
        qw, dd = histogram_mod.LatencyHistogram(), histogram_mod.LatencyHistogram()
        qw.observe_many(waits)
        dd.observe_many(device)
        got.append((slo_mod.fleet_pressure(qw.snapshot(), dd.snapshot()),
                    exporter_mod.render_metrics(
                        [slo_mod.pressure_metric(qw.snapshot(), dd.snapshot(), {"e": "x"})])))
    assert abs(got[0][0] - got[1][0]) <= BURN_TOL
    assert got[0][1] == got[1][1]


def test_eval_points_collector_matches_jax(monkeypatch):
    """``pio_eval_points_total{status}`` over the same counts renders the
    same text (the port's reads a Python counter: no CUDA)."""
    texts = []
    for grid_mod, exporter_mod in ((pgrid, pexporter), (jgrid, jexporter)):
        monkeypatch.setattr(grid_mod, "_point_counts", {"COMPLETED": 3, "FAILED": 1})
        texts.append(exporter_mod.render_metrics(grid_mod.eval_points_collector()))
    assert texts[0] == texts[1]
    assert 'pio_eval_points_total{status="failed"} 1' in texts[0]


# -- the train report summary ------------------------------------------------

def _report(**changes) -> dict:
    report = {
        "schema": "pio.train_report.v1", "instanceId": "i1", "status": "COMPLETED",
        "deviceKind": "NVIDIA H100 80GB HBM3", "deviceCount": 1, "wallSeconds": 12.3456,
        "stages": {"read": {"wallSeconds": 1.0, "compileSeconds": 0.0,
                            "executeSeconds": 1.0}},
        "compile": {"totalSeconds": 8.125, "totalCompiles": 1, "table": []},
        "flops": {"executed": 3.2e13, "peakPerChip": 989e12, "peakSource": "table"},
        "mfu": 0.0026, "mfuReason": "ok",
        "hbm": {"peakBytes": 9.5e9, "perStage": None}, "profileDir": None,
    }
    report.update(changes)
    return report


@pytest.mark.parametrize("changes", [
    {},
    {"mfu": None, "mfuReason": "no peak-FLOPs table entry for device kind 'cpu'"},
    {"hbm": {"peakBytes": None, "perStage": None}, "deviceKind": "cpu"},
    {"compile": {}, "mfu": 1, "wallSeconds": 0.0},
])
def test_summarize_train_report_prints_jax_line(changes):
    report = _report(**changes)
    assert pdevice.summarize_train_report(report) == jdevice.summarize_train_report(report)


# -- the servers -------------------------------------------------------------

def _als_models(users=20, items=60, rank=4):
    rng = np.random.default_rng(5)
    U = rng.standard_normal((users, rank)).astype(np.float32)
    I = rng.standard_normal((items, rank)).astype(np.float32)
    seen = {u: np.sort(rng.choice(items, 5, replace=False)).astype(np.int32)
            for u in range(users)}
    uids = {f"u{i}": i for i in range(users)}
    iids = {f"i{i}": i for i in range(items)}
    port = pmodels.ALSModel.from_jax(U, I, uids, iids, seen, device="cpu")
    jax_model = jmodels.ALSModel(
        rank=rank, user_factors=jnp.asarray(U), item_factors=jnp.asarray(I),
        user_ids=JaxEntityIdIxMap(JaxBiMap(uids)), item_ids=JaxEntityIdIxMap(JaxBiMap(iids)),
        seen_by_user=seen)
    return port, jax_model


@pytest.fixture(scope="module")
def als_models():
    return _als_models()


def _engine_servers(als_models, tmp_path, jax_extra=None, port_extra=None, **serving):
    """(JAX server, port server), tracing on, over the same factors;
    ``*_extra`` are one package's own config fields."""
    pmodel, jmodel = als_models
    common = dict(ip="127.0.0.1", port=0, tracing=True, batch_wait_ms=1.0, **serving)
    deployed = JaxDeployedEngine(
        jrec.engine_factory(), JaxEngineInstance(
            id="jax-instance", status="COMPLETED", start_time=T0, completion_time=T0,
            engine_id="e", engine_version="1", engine_variant="e", engine_factory="jax"),
        [jrec.ALSAlgorithm(jrec.ALSAlgorithmParams())], JaxFirstServing(), [jmodel])
    jax_srv = jengine.EngineServer(deployed, JaxServerConfig(**common, **(jax_extra or {})),
                                   storage=jax_memory_storage())
    jax_srv.start()
    storage = memory_storage()
    location = str(tmp_path / "model")
    iid = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=T0, completion_time=T0, engine_id="e",
        engine_version="1", engine_variant="e",
        engine_factory="predictionio_tpu_torch.templates.recommendation.engine_factory",
        algorithms_params=json.dumps([{"name": "als", "params": {}}])))
    save_models(storage, iid, [PersistentModelManifest(
        "predictionio_tpu_torch.templates.recommendation.ALSAlgorithm", location)])
    pmodel.save(location)
    port_srv = pengine.create_engine_server(
        storage, ServerConfig(device="cpu", engine_instance_id=iid, **common,
                              **(port_extra or {}))).start()
    return jax_srv, port_srv


def _http(port: int, path: str, body=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method or ("GET" if data is None else "POST"),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _span_names(port: int, trace_id: str, path: str = "/traces.json") -> list[str]:
    """The span names of one trace, in start order. The handler records
    a trace after its response is written, so this polls briefly."""
    deadline = time.monotonic() + 10
    while True:
        status, raw, _ = _http(port, path)
        assert status == 200, raw
        doc = json.loads(raw)
        assert doc["tracing"] is True
        found = [t for t in doc["traces"] if t["traceId"] == trace_id]
        if found or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    assert len(found) == 1, (trace_id, doc)
    trace = found[0]
    for s in trace["spans"]:
        # every child lies inside its root
        assert 0.0 <= s["startMs"]
        assert s["startMs"] + s["durationMs"] <= trace["durationMs"] + 2e-3
    return [s["name"] for s in trace["spans"]]


def _families(text: str) -> set[tuple[str, str]]:
    return {tuple(line.split()[2:4]) for line in text.splitlines()
            if line.startswith("# TYPE ")}


ENGINE_ROUTES = {
    "unbatched": (dict(batching=False, cache_enabled=False),
                  ["parse", "bind", "codec_key", "predict", "encode"]),
    "batched": (dict(batching=True, cache_enabled=False),
                ["parse", "bind", "codec_key", "batcher.queue_wait",
                 "batcher.device_dispatch", "encode"]),
    "cache_hit": (dict(batching=False, cache_enabled=True),
                  ["parse", "bind", "codec_key", "cache_lookup", "encode"]),
    "fallback": (dict(batching=True, cache_enabled=False),
                 ["parse", "bind", "codec_key", "batcher.queue_wait",
                  "batcher.fallback_predict", "encode"]),
}


@pytest.mark.parametrize("route", sorted(ENGINE_ROUTES))
def test_engine_server_span_names_per_route_equal_jax(route, als_models, tmp_path):
    serving, want = ENGINE_ROUTES[route]
    servers = _engine_servers(als_models, tmp_path, **serving)
    try:
        names = []
        for srv in servers:
            if route == "fallback":
                def broken(queries):
                    raise RuntimeError("the batch fails; each query is retried alone")
                srv.service.deployed.query_batch = broken
            body = {"user": "u3", "num": 4}
            if route == "cache_hit":
                assert _http(srv.port, "/queries.json", body)[0] == 200
            status, raw, headers = _http(srv.port, "/queries.json", body)
            assert status == 200, raw
            assert headers["X-PIO-Trace-Id"]
            names.append(_span_names(srv.port, headers["X-PIO-Trace-Id"]))
        assert names[1] == names[0] == want
    finally:
        for srv in servers:
            srv.stop()


def test_engine_server_adopts_inbound_trace_context_like_jax(als_models, tmp_path):
    servers = _engine_servers(als_models, tmp_path, batching=False)
    try:
        docs = []
        for srv in servers:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/queries.json",
                data=json.dumps({"user": "u1", "num": 2}).encode(), method="POST",
                headers={"Content-Type": "application/json", "X-PIO-Trace-Id": "tr-1",
                         "X-PIO-Parent-Span": "sp-9"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert resp.headers["X-PIO-Trace-Id"] == "tr-1"
            assert _span_names(srv.port, "tr-1")[0] == "parse"
            doc = json.loads(_http(srv.port, "/traces.json")[1])["traces"][0]
            docs.append({k: doc[k] for k in ("traceId", "parentSpanId", "service", "name")})
            # untraced routes carry no trace header
            assert "X-PIO-Trace-Id" not in _http(srv.port, "/stats.json")[2]
        assert docs[0] == docs[1] == {"traceId": "tr-1", "parentSpanId": "sp-9",
                                      "service": "engine", "name": "queries.json"}
    finally:
        for srv in servers:
            srv.stop()


def test_engine_server_metrics_families_equal_jax(als_models, tmp_path, monkeypatch):
    # one recorder state for both packages: a compile each, no profiled
    # train (other tests in this process may have left either)
    for mod in (jcompile, pcompile):
        rec = mod.CompileRecorder()
        rec.record_compile("f", "sig", 0.25)
        monkeypatch.setattr(mod, "_GLOBAL_RECORDER", rec)
    for mod in (jdevice, pdevice):
        monkeypatch.setattr(mod, "_LAST_REPORT", None)
    servers = _engine_servers(als_models, tmp_path, batching=True, cache_enabled=True)
    try:
        texts, stats = [], []
        for srv in servers:
            for u in range(4):
                assert _http(srv.port, "/queries.json", {"user": f"u{u}", "num": 3})[0] == 200
            status, raw, headers = _http(srv.port, "/metrics")
            assert status == 200
            assert headers["Content-Type"] == pexporter.CONTENT_TYPE
            texts.append(raw.decode())
            stats.append(json.loads(_http(srv.port, "/stats.json")[1])["compile"])
        got, want = _families(texts[1]), _families(texts[0])
        assert got == want
        assert ("pio_serving_recompile_total", "counter") in got
        assert ("pio_slo_burn_rate", "gauge") in got
        assert ("pio_serving_ann_enabled", "gauge") in got
        # the first answered query marked warmup in both
        assert stats[0] == stats[1] == {"compiles": 1, "compileSeconds": 0.25,
                                        "servingRecompiles": 0, "warmupComplete": True,
                                        "byFunction": {"f": 1}}
        # no device gauges in a process that has not initialized CUDA
        assert not any(name.startswith("pio_device_") for name, _ in got)
    finally:
        for srv in servers:
            srv.stop()


def _event_servers(tmp_path, **config):
    servers = []
    for name, mod, storage, app_cls, key_cls in (
            ("jax", jes, jax_memory_storage(), JaxApp, JaxAccessKey),
            ("port", pes, memory_storage(), App, AccessKey)):
        app_id = storage.get_meta_data_apps().insert(app_cls(0, "obsapp"))
        storage.get_meta_data_access_keys().insert(key_cls(KEY, app_id, ()))
        storage.get_events().init(app_id)
        cfg = dict(ip="127.0.0.1", port=0, tracing=True, **config)
        if cfg.get("wal_dir"):
            cfg["wal_dir"] = str(tmp_path / f"{name}-wal")
        srv = mod.EventServer(storage, mod.EventServerConfig(**cfg))
        srv.start()
        servers.append(srv)
    return servers


def _event(i: int) -> dict:
    return {"event": "view", "entityType": "user", "entityId": f"u{i}",
            "targetEntityType": "item", "targetEntityId": f"i{i}"}


EVENT_ROUTES = {
    "single": ({}, "/events.json", _event(1), ["parse", "validate", "insert"]),
    "batch": ({}, "/batch/events.json", [_event(i) for i in range(50)],
              ["parse", "validate", "insert_batch"]),
    "journaled": ({"wal_dir": "wal", "wal_policy": "write-through"}, "/events.json",
                  _event(2), ["parse", "validate", "journal"]),
}


@pytest.mark.parametrize("route", sorted(EVENT_ROUTES))
def test_event_server_span_names_per_route_equal_jax(route, tmp_path):
    config, path, body, want = EVENT_ROUTES[route]
    servers = _event_servers(tmp_path, **config)
    try:
        names = []
        for srv in servers:
            status, raw, headers = _http(srv.port, f"{path}?accessKey={KEY}", body)
            assert status in (200, 201, 202), raw
            # /traces.json carries per-request data: behind the key
            assert _http(srv.port, "/traces.json")[0] == 401
            names.append(_span_names(srv.port, headers["X-PIO-Trace-Id"],
                                     f"/traces.json?accessKey={KEY}"))
        assert names[1] == names[0] == want
    finally:
        for srv in servers:
            srv.stop()


def _trace_where(port: int, path: str, match) -> dict:
    """The first trace on ``path`` that ``match`` accepts, polled (the
    feedback post and its span land after the query's response)."""
    deadline = time.monotonic() + 20
    while True:
        found = [t for t in json.loads(_http(port, path)[1])["traces"] if match(t)]
        if found or time.monotonic() > deadline:
            assert found, path
            return found[0]
        time.sleep(0.02)


def test_feedback_post_carries_the_trace_like_jax(als_models, tmp_path):
    jax_events, port_events = _event_servers(tmp_path)
    feedback = dict(feedback=True, event_server_ip="127.0.0.1", access_key=KEY)
    servers = _engine_servers(als_models, tmp_path, batching=False,
                              jax_extra=dict(feedback, event_server_port=jax_events.port),
                              port_extra=dict(feedback, event_server_port=port_events.port))
    try:
        docs = []
        for srv, events in zip(servers, (jax_events, port_events)):
            status, _, headers = _http(srv.port, "/queries.json", {"user": "u4", "num": 2})
            assert status == 200
            trace_id = headers["X-PIO-Trace-Id"]
            engine = _trace_where(srv.port, "/traces.json", lambda t: t["traceId"] == trace_id
                                  and t["spans"][-1]["name"] == "feedback")
            event = _trace_where(events.port, f"/traces.json?accessKey={KEY}",
                                 lambda t: t["traceId"] == trace_id)
            # the event server's segment nests under the feedback span
            assert event["parentSpanId"] == engine["spans"][-1]["spanId"]
            docs.append(([s["name"] for s in engine["spans"]],
                         [s["name"] for s in event["spans"]], event["name"], event["service"]))
        assert docs[1] == docs[0] == (
            ["parse", "bind", "codec_key", "predict", "encode", "feedback"],
            ["parse", "validate", "insert"], "events.json", "event")
    finally:
        for srv in (*servers, jax_events, port_events):
            srv.stop()


def test_wal_replay_trace_equals_jax(tmp_path):
    servers = _event_servers(tmp_path, wal_dir="wal", wal_policy="write-through")
    try:
        replays = []
        for srv in servers:
            for i in range(3):
                assert _http(srv.port, f"/events.json?accessKey={KEY}", _event(i))[0] == 202
            deadline = time.monotonic() + 20
            while True:
                traces = json.loads(_http(srv.port, f"/traces.json?accessKey={KEY}")[1])[
                    "traces"]
                found = [t for t in traces if t["name"] == "wal.replay"
                         and any(s["name"] == "insert_batch" for s in t["spans"])]
                if found or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            assert found, traces
            replays.append([s["name"] for s in found[-1]["spans"]])
        assert replays[1] == replays[0] == ["decode", "insert_batch", "commit"]
    finally:
        for srv in servers:
            srv.stop()


def test_event_server_metrics_families_equal_jax(tmp_path):
    servers = _event_servers(tmp_path, wal_dir="wal")
    try:
        texts = []
        for srv in servers:
            assert _http(srv.port, f"/batch/events.json?accessKey={KEY}",
                         [_event(i) for i in range(5)])[0] == 200
            status, raw, headers = _http(srv.port, "/metrics")    # no key needed
            assert status == 200
            assert headers["Content-Type"] == pexporter.CONTENT_TYPE
            texts.append(raw.decode())
        got, want = _families(texts[1]), _families(texts[0])
        assert EVENT_FAMILIES_LEFT_OUT <= want
        assert got == want - EVENT_FAMILIES_LEFT_OUT
        for family in ("pio_ingest_events_total", "pio_ingest_wal_depth",
                       "pio_slo_burn_rate", "pio_server_info"):
            assert any(name == family for name, _ in got), family
        assert "pio_ingest_events_total 5" in texts[1]
    finally:
        for srv in servers:
            srv.stop()


def test_untraced_servers_record_nothing(als_models, tmp_path, monkeypatch):
    monkeypatch.delenv("PIO_TRACE", raising=False)
    pmodel, _ = als_models
    storage = memory_storage()
    iid = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=T0, completion_time=T0, engine_id="e",
        engine_version="1", engine_variant="e",
        engine_factory="predictionio_tpu_torch.templates.recommendation.engine_factory",
        algorithms_params=json.dumps([{"name": "als", "params": {}}])))
    location = str(tmp_path / "m2")
    save_models(storage, iid, [PersistentModelManifest(
        "predictionio_tpu_torch.templates.recommendation.ALSAlgorithm", location)])
    pmodel.save(location)
    srv = pengine.create_engine_server(storage, ServerConfig(
        ip="127.0.0.1", port=0, device="cpu", engine_instance_id=iid,
        batching=True)).start()
    try:
        status, _, headers = _http(srv.port, "/queries.json", {"user": "u2", "num": 3})
        assert status == 200 and "X-PIO-Trace-Id" not in headers
        doc = json.loads(_http(srv.port, "/traces.json")[1])
        assert doc == {"tracing": False, "traces": []}
        assert math.isfinite(srv.service.serving_stats.device_time.snapshot().sum)
    finally:
        srv.stop()
