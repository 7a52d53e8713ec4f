"""The port's admin tools and data helpers (``tools/{admin,dashboard}.py``,
``data/{view,self_cleaning}.py`` and the ``pio`` commands ``dashboard``,
``adminserver``, ``build``, ``run``, ``upgrade``, ``template`` and
``status --router``) on the CPU, against the JAX package's.

- ``AdminService.handle`` and ``DashboardService.handle`` give equal
  statuses and bodies over the same stores; the dashboards' CORS
  headers (preflight and plain GET) are equal over HTTP.
- ``BatchView`` chains, ``data_map_aggregator`` steps and
  ``create_data_view`` (cache miss, hit and bypass; one cache file
  name) give equal results on seeded events.
- ``SelfCleaningDataSource.clean_events`` and ``clean_persisted_events``
  give equal events on a seeded set with duplicates, ``$set`` runs and
  events outside the window.
- Each command gives JAX's exit code and message (the package name in a
  message is the only difference allowed), and those that must not load
  torch or JAX leave both out of ``sys.modules``.

Seeds come from numpy; every comparison is exact.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.data import self_cleaning as jclean
from predictionio_tpu.data import view as jview
from predictionio_tpu.storage import base as jbase
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.tools import admin as jadmin
from predictionio_tpu.tools import dashboard as jdash
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.data import self_cleaning as pclean
from predictionio_tpu_torch.data import view as pview
from predictionio_tpu_torch.storage import base as pbase
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.tools import admin as padmin
from predictionio_tpu_torch.tools import dashboard as pdash

REPO = Path(__file__).resolve().parents[1]
T0 = datetime(2026, 3, 1, tzinfo=timezone.utc)
NOW = T0 + timedelta(days=30)

PACKAGES = {
    "jax": dict(Event=JaxEvent, DataMap=JaxDataMap, base=jbase, Storage=JaxStorage,
                admin=jadmin, dash=jdash, view=jview, clean=jclean),
    "port": dict(Event=Event, DataMap=DataMap, base=pbase, Storage=Storage,
                 admin=padmin, dash=pdash, view=pview, clean=pclean),
}


def _memory_env() -> dict:
    return {"PIO_STORAGE_SOURCES_M_TYPE": "memory",
            **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
               for r in ("METADATA", "EVENTDATA", "MODELDATA")}}


def _file_env(base_dir) -> dict:
    return {"PIO_FS_BASEDIR": str(base_dir)}


def _fields(e) -> tuple:
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type, e.target_entity_id,
            json.dumps(e.properties.fields, sort_keys=True), e.event_time, e.event_id)


def _seeded_events(package: str, seed: int = 15, n: int = 160) -> list:
    """View, rate, ``$set``/``$unset``/``$delete`` events over a month
    (some before the cleaning window), with exact duplicates."""
    P = PACKAGES[package]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = ["view", "rate", "$set", "$set", "$unset", "$delete"][int(rng.integers(0, 6))]
        entity = f"u{int(rng.integers(0, 6))}"
        minutes = int(rng.integers(0, 30 * 24 * 60))
        props = {}
        if kind == "$set":
            props = {f"p{int(rng.integers(0, 4))}": int(rng.integers(0, 100)),
                     "tags": [int(x) for x in rng.integers(0, 9, size=2)]}
        elif kind == "$unset":
            props = {f"p{int(rng.integers(0, 4))}": None}
        elif kind == "rate":
            props = {"rating": float(rng.integers(1, 11)) / 2}
        out.append(P["Event"](
            event=kind, entity_type="user", entity_id=entity,
            target_entity_type="item" if kind in ("view", "rate") else None,
            target_entity_id=f"i{int(rng.integers(0, 20))}" if kind in ("view", "rate") else None,
            properties=P["DataMap"](props), event_time=T0 + timedelta(minutes=minutes),
            event_id=f"e{i}", creation_time=T0))
    dups = [dataclasses.replace(out[int(j)], event_id=f"d{k}")
            for k, j in enumerate(rng.integers(0, n, size=24))]
    return out + dups


# ---------------------------------------------------------------------------
# admin service
# ---------------------------------------------------------------------------

ADMIN_SCRIPT = [
    ("GET", "/", None),
    ("GET", "/cmd/app", None),
    ("POST", "/cmd/app", {"name": "alpha", "description": "first"}),
    ("POST", "/cmd/app", {"name": "alpha"}),
    ("POST", "/cmd/app", {"description": "no name"}),
    ("POST", "/cmd/app", ["not", "a", "dict"]),
    ("POST", "/cmd/app", {"name": "beta", "id": 7}),
    ("POST", "/cmd/app", {"name": "gamma", "id": 7}),
    ("GET", "/cmd/app", None),
    ("DELETE", "/cmd/app/alpha/data", None),
    ("DELETE", "/cmd/app/nosuch/data", None),
    ("DELETE", "/cmd/app/nosuch", None),
    ("DELETE", "/cmd/app/alpha", None),
    ("GET", "/cmd/app", None),
    ("PUT", "/cmd/app", None),
    ("GET", "/nope", None),
]


def _mask_keys(body):
    """Access keys are random: keep their length only."""
    if isinstance(body, dict):
        return {k: (len(v) if k == "accessKey" else
                    [len(x) for x in v] if k == "accessKeys" else _mask_keys(v))
                for k, v in body.items()}
    if isinstance(body, list):
        return [_mask_keys(x) for x in body]
    return body


class TestAdminService:
    def test_script_gives_equal_statuses_and_bodies(self):
        runs = {}
        for name, P in PACKAGES.items():
            storage = P["Storage"](_memory_env())
            service = P["admin"].AdminService(storage)
            app_events = []
            out = []
            for method, path, body in ADMIN_SCRIPT:
                status, payload = service.handle(method, path, body)
                out.append((status, _mask_keys(payload)))
                if (method, path) == ("POST", "/cmd/app") and status == 201:
                    storage.get_events().insert(P["Event"](
                        event="view", entity_type="user", entity_id="u1",
                        event_time=T0), payload["id"])
                    app_events.append(payload["id"])
            out.append([len(list(storage.get_events().find(a))) for a in app_events])
            runs[name] = out
        assert runs["jax"] == runs["port"]
        assert runs["port"][2][0] == 201 and runs["port"][-1] == [0, 1]

    def test_same_store_lists_the_same_apps(self, tmp_path):
        writer = Storage(_file_env(tmp_path))
        padmin.AdminService(writer).handle("POST", "/cmd/app", {"name": "shared"})
        padmin.AdminService(writer).handle("POST", "/cmd/app", {"name": "other", "id": 9})
        bodies = [P["admin"].AdminService(P["Storage"](_file_env(tmp_path))).handle(
            "GET", "/cmd/app", None) for P in PACKAGES.values()]
        assert bodies[0] == bodies[1]
        assert [a["name"] for a in bodies[1][1]["apps"]] == ["shared", "other"]

    def test_http_server_routes_and_bad_json(self):
        results = {}
        for name, P in PACKAGES.items():
            server = P["admin"].AdminServer(P["Storage"](_memory_env()), ip="127.0.0.1",
                                             port=0)
            server.start()
            try:
                out = []
                for method, path, data in [
                        ("GET", "/", None), ("POST", "/cmd/app", b'{"name": "h"}'),
                        ("POST", "/cmd/app", b"{bad json"), ("GET", "/cmd/app?x=1", None),
                        ("DELETE", "/cmd/app/h", None)]:
                    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                                 data=data, method=method)
                    try:
                        with urllib.request.urlopen(req, timeout=10) as r:
                            out.append((r.status, _mask_keys(json.loads(r.read()))))
                    except urllib.error.HTTPError as e:
                        out.append((e.code, json.loads(e.read())))
                results[name] = out
            finally:
                server.stop()
        assert results["jax"] == results["port"]
        assert [s for s, _ in results["port"]] == [200, 201, 400, 200, 200]


# ---------------------------------------------------------------------------
# dashboard
# ---------------------------------------------------------------------------

def _evaluations(storage, base) -> list[str]:
    t = datetime(2026, 2, 1, tzinfo=timezone.utc)
    dao = storage.get_meta_data_evaluation_instances()
    ids = []
    for i, status in enumerate(["EVALCOMPLETED", "INIT", "EVALCOMPLETED", "FAILED"]):
        ids.append(dao.insert(base.EvaluationInstance(
            f"ev{i}", status, t + timedelta(hours=i), t + timedelta(hours=i, minutes=5),
            evaluation_class="chip.Eval<&>", engine_params_generator_class="chip.Gen",
            evaluator_results=f"HitRate@10 = 0.{i}5 <b>" + "x" * (250 * (i == 2)),
            evaluator_results_html=f"<p>{i}</p>",
            evaluator_results_json=json.dumps({"score": i / 4}) if i != 2 else "")))
    return ids


class TestDashboardService:
    def test_routes_give_equal_responses_over_one_store(self, tmp_path):
        ids = _evaluations(JaxStorage(_file_env(tmp_path)), jbase)
        services = [P["dash"].DashboardService(P["Storage"](_file_env(tmp_path)),
                                               access_log=False)
                    for P in PACKAGES.values()]
        paths = ["/", "/nope", "/engine_instances/nosuch/evaluator_results.txt"]
        for i in ids:
            paths += [f"/engine_instances/{i}/evaluator_results.{fmt}"
                      for fmt in ("txt", "html", "json", "csv")]
        for path in paths:
            jax_out, port_out = (s.handle("GET", path) for s in services)
            assert jax_out == port_out, path
        assert services[0].handle("POST", "/") == services[1].handle("POST", "/")
        index = services[1].handle("GET", "/")[2]
        assert "ev0" in index and "ev2" in index and "ev1" not in index
        assert index.index("ev2") < index.index("ev0")          # newest first
        status, ctype, text = services[1].handle("GET", "/metrics")
        assert (status, ctype) == services[0].handle("GET", "/metrics")[:2]
        # the resilience families come from each package's process-wide
        # registry, which the tests run before this one in the process fill
        families = lambda t: sorted({ln.split()[2] for ln in t.splitlines()  # noqa: E731
                                     if ln.startswith("# TYPE")
                                     and not ln.split()[2].startswith("pio_resilience_")})
        assert families(text) == families(services[0].handle("GET", "/metrics")[2]) == [
            "pio_http_request_seconds", "pio_server_info"]
        assert 'pio_server_info{server="dashboard"' in text

    def test_cors_headers_are_equal_over_http(self, tmp_path):
        _evaluations(Storage(_file_env(tmp_path)), pbase)
        got = {}
        for name, P in PACKAGES.items():
            server = P["dash"].Dashboard(P["Storage"](_file_env(tmp_path)), ip="127.0.0.1",
                                         port=0, access_log=False)
            server.start()
            try:
                out = []
                for method, path in [("OPTIONS", "/"), ("OPTIONS", "/metrics"),
                                     ("OPTIONS", "/engine_instances/ev0/evaluator_results.json"),
                                     ("OPTIONS", "/nope"), ("GET", "/"),
                                     ("GET", "/engine_instances/ev0/evaluator_results.json")]:
                    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                                 method=method)
                    try:
                        r = urllib.request.urlopen(req, timeout=10)
                    except urllib.error.HTTPError as e:
                        r = e
                    headers = {k: v for k, v in r.headers.items()
                               if k.startswith("Access-Control") or k == "Content-Type"}
                    out.append((r.status, headers, r.read()))
                got[name] = out
            finally:
                server.stop()
        assert got["jax"] == got["port"]
        assert got["port"][0][1]["Access-Control-Max-Age"] == "1728000"
        assert got["port"][3][0] == 404


# ---------------------------------------------------------------------------
# batch views
# ---------------------------------------------------------------------------

def _view_run(package: str) -> list:
    P = PACKAGES[package]
    V = P["view"]
    events = _seeded_events(package)
    with pytest.warns(DeprecationWarning):
        view = V.BatchView(events)
    mid = T0 + timedelta(days=12)
    out = [
        [_fields(e) for e in view.event_name("rate").entity_type("user").after(mid).events()],
        [_fields(e) for e in view.filter_by(event="view", start_time=mid,
                                            until_time=mid + timedelta(days=5)).events()],
        [_fields(e) for e in view.before(mid).filter(lambda e: e.entity_id == "u2").events()],
        len(view.filter_by(entity_type="item")),
        {k: dict(v.fields) for k, v in view.aggregate_properties("user").items()},
        {k: dict(v.fields) for k, v in view.aggregate_properties("user", until_time=mid).items()},
        {k: [e.event_id for e in v] for k, v in view.group_by_entity().items()},
        view.fold(0, lambda acc, e: acc + len(e.properties.fields)),
    ]
    agg = view.aggregate_by_entity_ordered(None, V.data_map_aggregator())
    out.append({k: (None if v is None else dict(v.fields)) for k, v in agg.items()})
    step = V.data_map_aggregator()
    acc, steps = None, []
    for e in sorted(events, key=lambda e: (e.event_time, e.event_id)):
        if e.entity_id == "u3":
            acc = step(acc, e)
            steps.append(None if acc is None else dict(acc.fields))
    out.append(steps)
    return out


def to_row(e):
    """A module-level conversion: its source text keys the view cache."""
    if e.event != "rate":
        return None
    return {"user": e.entity_id, "item": e.target_entity_id,
            "rating": e.properties.get("rating")}


class TestViews:
    def test_batch_view_chains_and_aggregator_steps(self):
        jax_out, port_out = _view_run("jax"), _view_run("port")
        assert jax_out == port_out
        assert port_out[0] and port_out[-1]

    def test_create_data_view_miss_hit_and_bypass(self, tmp_path):
        pytest.importorskip("pyarrow")
        store_env = _file_env(tmp_path / "store")
        writer = JaxStorage(store_env)
        app_id = writer.get_meta_data_apps().insert(jbase.App(0, "viewapp"))
        writer.get_events().insert_batch(_seeded_events("jax"), app_id)
        until = T0 + timedelta(days=20)
        tables, files = {}, {}
        for name, P in PACKAGES.items():
            storage = P["Storage"](store_env)
            cache = tmp_path / f"cache-{name}"
            make = lambda until_time, v="1": P["view"].create_data_view(  # noqa: E731
                "viewapp", to_row, name="rates", version=v, storage=storage,
                start_time=T0 + timedelta(days=2), until_time=until_time,
                base_dir=str(cache))
            miss = make(until)
            files[name] = sorted(p.name for p in cache.iterdir())
            storage.get_events().insert(P["Event"](
                event="rate", entity_type="user", entity_id="late", target_entity_type="item",
                target_entity_id="i0", properties=P["DataMap"]({"rating": 5.0}),
                event_time=T0 + timedelta(days=3)), app_id)
            hit = make(until)                       # cached: the late event is not in it
            other = make(until, v="2")              # a new version misses
            bypass = make(None)                     # no until_time: a fresh read
            tables[name] = [t.to_pylist() for t in (miss, hit, other, bypass)]
            storage.get_events().delete(
                next(e.event_id for e in storage.get_events().find(app_id)
                     if e.entity_id == "late"), app_id)
        assert tables["jax"] == tables["port"]
        assert files["jax"] == files["port"] and len(files["port"]) == 1
        miss, hit, other, bypass = tables["port"]
        assert miss == hit and len(other) == len(miss) + 1
        assert {"user": "late", "item": "i0", "rating": 5.0} in bypass


# ---------------------------------------------------------------------------
# self-cleaning data source
# ---------------------------------------------------------------------------

WINDOWS = [
    dict(duration=None, remove_duplicates=True, compress_properties=False),
    dict(duration=timedelta(days=10), remove_duplicates=False, compress_properties=True),
    dict(duration=timedelta(days=20), remove_duplicates=True, compress_properties=True),
    None,
]


def _cleaner(package: str, window):
    C = PACKAGES[package]["clean"]
    return type("DS", (C.SelfCleaningDataSource,), {
        "event_window": None if window is None else C.EventWindow(**window)})()


class TestSelfCleaning:
    @pytest.mark.parametrize("window", WINDOWS, ids=["dedup", "compress", "both", "none"])
    def test_clean_events(self, window):
        got = {name: [_fields(e) for e in _cleaner(name, window).clean_events(
            _seeded_events(name), now=NOW)] for name in PACKAGES}
        assert got["jax"] == got["port"]
        if window is not None:
            assert len(got["port"]) < len(_seeded_events("port"))

    @pytest.mark.parametrize("window", WINDOWS[:3], ids=["dedup", "compress", "both"])
    def test_clean_persisted_events(self, window):
        got = {}
        for name, P in PACKAGES.items():
            storage = P["Storage"](_memory_env())
            storage.get_events().insert_batch(_seeded_events(name), 3)
            kept = _cleaner(name, window).clean_persisted_events(storage, 3, now=NOW)
            got[name] = (kept, sorted(_fields(e) for e in storage.get_events().find(3)))
        assert got["jax"] == got["port"]
        assert got["port"][0] == len(got["port"][1]) < len(_seeded_events("port"))


# ---------------------------------------------------------------------------
# the pio commands
# ---------------------------------------------------------------------------

_DRIVER = textwrap.dedent("""\
    import importlib, sys
    pio = importlib.import_module(sys.argv[1] + ".cli.pio")
    rc = pio.main(sys.argv[2:])
    print("RC", rc, "TORCH", "torch" in sys.modules, "JAX", "jax" in sys.modules, flush=True)
""")


def _env(tmp_path) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_")}
    env.update(PIO_FS_BASEDIR=str(tmp_path / "store"), JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(tmp_path), str(REPO)]))
    return env


def _pio(package: str, args: list[str], tmp_path, cwd=None) -> tuple[str, bool, bool]:
    """``pio <args>`` of a package in a fresh process: its output with the
    package name normalized, and whether torch and JAX were loaded."""
    pkg = "predictionio_tpu" if package == "jax" else "predictionio_tpu_torch"
    p = subprocess.run([sys.executable, "-c", _DRIVER, pkg, *args], cwd=cwd or tmp_path,
                       env=_env(tmp_path), capture_output=True, text=True, timeout=240)
    lines = p.stdout.strip().splitlines()
    assert lines and lines[-1].startswith("RC "), p.stdout + p.stderr
    _, rc, _, torch_in, _, jax_in = lines[-1].split()
    text = "\n".join(lines[:-1] + [f"rc={rc}"]).replace("predictionio_tpu_torch",
                                                         "predictionio_tpu")
    return text, torch_in == "True", jax_in == "True"


_MAIN_MODULE = textwrap.dedent("""\
    def main(*args):
        print("ARGS", list(args))
        return len(args)

    def truthy():
        return True

    def falsy():
        return False

    def nothing():
        return None
""")


class TestCommands:
    @pytest.mark.parametrize("args", [
        ["upgrade"],
        ["template"],
        ["template", "get", "x"],
        ["run", "user_main"],
        ["run", "user_main", "a", "--b", "c"],
        ["run", "user_main:truthy"],
        ["run", "user_main:falsy"],
        ["run", "user_main:nothing"],
        ["run", "user_main:missing"],
        ["run", "nosuch_module_xyz"],
        ["build"],
        ["build", "--engine-factory", "nosuch_module_xyz.factory"],
        ["build", "--engine-json", "bad.json"],
    ], ids=lambda a: "-".join(a))
    def test_same_code_and_message_without_torch_or_jax(self, tmp_path, args):
        (tmp_path / "user_main.py").write_text(_MAIN_MODULE)
        (tmp_path / "bad.json").write_text("{not json")
        jax_text, _, _ = _pio("jax", args, tmp_path)
        port_text, torch_in, jax_in = _pio("port", args, tmp_path)
        assert port_text == jax_text
        assert not torch_in and not jax_in

    @pytest.mark.parametrize("case", ["ok", "no-bind", "min-version", "no-factory"])
    def test_build_binds_a_template_variant(self, tmp_path, case):
        variant = {"id": "default", "datasource": {"params": {"appName": "A"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 4, "numIterations": 2, "lambda": 0.01, "seed": 3}}]}
        if case == "no-bind":
            variant["algorithms"][0]["name"] = "nosuch-algorithm"
        if case == "min-version":
            (tmp_path / "template.json").write_text(
                json.dumps({"pio": {"version": {"min": "99.0.0"}}}))
        out = {}
        for name, pkg in (("jax", "predictionio_tpu"), ("port", "predictionio_tpu_torch")):
            if case != "no-factory":
                variant["engineFactory"] = f"{pkg}.templates.recommendation.engine_factory"
            (tmp_path / "engine.json").write_text(json.dumps(variant))
            out[name] = _pio(name, ["build"], tmp_path)[0]
        assert out["jax"] == out["port"]
        assert out["port"].endswith("rc=0" if case == "ok" else "rc=1")

    def test_status_router_prints_the_same_table(self, tmp_path):
        doc = {"defaultEngine": "default", "engines": [
            {"name": "default", "groups": {"stable": {"up": 2, "size": 2},
                                           "canary": {"up": 0, "size": 1}},
             "canary": {"weightPct": 12.5, "aborted": True},
             "quota": {"limited": True, "qps": 50, "maxInflight": None},
             "scale": {"actualReplicas": 2, "desiredReplicas": 3, "minReplicas": 1,
                       "maxReplicas": 4, "dryRun": True, "lastDecision": "grow",
                       "lastReason": "pressure"}},
            {"name": "ml100k", "groups": {"stable": {"up": 1, "size": 1}}}],
            "experiment": {"name": "exp", "state": "RUNNING",
                           "decision": {"winner": "v1"},
                           "variants": [{"name": "v0", "weightPct": 50, "requests": 10,
                                         "errors": 0, "conversions": 2, "onlineScore": 0.2},
                                        {"name": "v1", "weightPct": 50, "aborted": True}]}}

        class Stub(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                body = json.dumps(doc).encode() if self.path == "/fleet/engines" else b"{}"
                self.send_response(200 if self.path == "/fleet/engines" else 404)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        server = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            args = ["status", "--router", f"127.0.0.1:{server.server_address[1]}",
                    "--timeout", "5"]
            jax_text = _pio("jax", args, tmp_path)[0]
            port_text, torch_in, jax_in = _pio("port", args, tmp_path)
        finally:
            server.shutdown()
        assert port_text == jax_text and not torch_in and not jax_in
        assert "stable 2/2 up" in port_text and "ml100k: stable 1/1 up" in port_text
        unreachable = ["status", "--router", "127.0.0.1:1", "--timeout", "2"]
        assert _pio("port", unreachable, tmp_path)[0] == _pio("jax", unreachable, tmp_path)[0]

    @pytest.mark.parametrize("command, label", [("adminserver", "Admin API"),
                                                ("dashboard", "Dashboard")])
    def test_servers_announce_and_answer_like_jax(self, tmp_path, command, label):
        answers = {}
        for name, pkg in (("jax", "predictionio_tpu"), ("port", "predictionio_tpu_torch")):
            proc = subprocess.Popen(
                [sys.executable, "-c", _DRIVER, pkg, command, "--ip", "127.0.0.1",
                 "--port", "0"], cwd=tmp_path, env=_env(tmp_path),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            try:
                first = proc.stdout.readline().strip()
                assert first.startswith(f"[INFO] {label} listening on 127.0.0.1:"), first
                port = int(first.rsplit(":", 1)[1])
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
                    body = r.read().decode()
                answers[name] = (first.rsplit(":", 1)[0], r.status,
                                 json.loads(body) if command == "adminserver" else body)
            finally:
                proc.send_signal(signal.SIGTERM)
                out, _ = proc.communicate(timeout=30)
            if name == "port":
                assert proc.returncode == 0
                assert out.strip().splitlines()[-1] == "RC 0 TORCH False JAX False"
        assert answers["jax"] == answers["port"]
