"""The port's router tier held against the JAX package's: the canary,
the membership hysteresis, the hedge policy and the router config as
units, then the two routers side by side over HTTP in front of the same
stdlib replicas (``tests/fleet_replica_child.py``), and ``pio router``,
``pio trace`` and ``pio experiment`` of the port as a user runs them.

Units: a seeded ``random.Random`` gives equal canary picks over 10,000
draws; equal guardrail scripts give equal verdicts; equal probe scripts
give equal membership transitions.

Servers: one query script gives equal statuses and bodies through both
routers, equal ``/fleet`` document keys and equal sets of metric
families on ``/metrics`` and ``/fleet/metrics``. On the port: a replica
killed mid-script costs no 5xx and counts retries, the canary's weight
and promotion work over ``/fleet/canary``, ``/stop`` is refused without
the router key, and the ``pio router`` process loads no torch.
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request
from argparse import Namespace
from datetime import datetime, timezone
from pathlib import Path

import pytest

from predictionio_tpu.api import router_server as jrs
from predictionio_tpu.fleet import canary as jcanary
from predictionio_tpu.fleet import membership as jmem
from predictionio_tpu.fleet import router as jrouter
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu_torch.api import router_server as prs
from predictionio_tpu_torch.experiment import cli as pcli
from predictionio_tpu_torch.fleet import canary as pcanary
from predictionio_tpu_torch.fleet import membership as pmem
from predictionio_tpu_torch.fleet import router as prouter
from predictionio_tpu_torch.storage.base import EvaluationInstance
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.utils import resilience as pres

from tests.netutil import free_port, wait_until

REPO = Path(__file__).resolve().parent.parent
CHILD = REPO / "tests" / "fleet_replica_child.py"
KEY = "router-key"

JAX = (jcanary, jmem, jrouter, jres, jrs)
PORT = (pcanary, pmem, prouter, pres, prs)


@pytest.fixture(autouse=True)
def _fresh_registries():
    for mod in (jres, pres):
        mod.reset_registry()
    yield
    for mod in (jres, pres):
        mod.reset_registry()


# -- units --------------------------------------------------------------------

@pytest.mark.parametrize("weight, seed", [(10.0, 42), (30.0, 7), (0.0, 1), (100.0, 3),
                                          (2.5, 11)])
def test_canary_picks_over_10000_draws(weight, seed):
    picks = []
    for canary, *_ in (JAX, PORT):
        c = canary.CanaryController(weight_pct=weight, rng=random.Random(seed))
        picks.append([c.pick_group() for _ in range(10_000)])
    assert picks[1] == picks[0]
    share = picks[1].count("canary") / 10_000
    p = weight / 100.0
    assert abs(share - p) <= 5 * (p * (1 - p) / 10_000) ** 0.5


#: (guardrail, [(group, ok, latency_s)] or ("weight", pct) / ("abort",))
GUARDRAILS = {
    "error_rate": (dict(min_requests=10, max_error_rate=0.3, window=50),
                   [("canary", False, 0.01)] * 11),
    "p99": (dict(min_requests=20, max_error_rate=0.0, max_p99_ms=100.0, window=100),
            [("canary", True, 0.001)] * 19 + [("canary", True, 0.5)]),
    "stable_never_counts": (dict(min_requests=1, max_error_rate=0.01),
                            [("stable", False, 0.01)] * 50),
    "weight_clears_latch": (dict(min_requests=2, max_error_rate=0.1),
                            [("canary", False, 0.01)] * 2 + [("weight", 25.0)]
                            + [("canary", True, 0.01)] * 3),
    "operator_abort": (dict(min_requests=5), [("canary", True, 0.01)] * 3 + [("abort",)]
                       + [("canary", False, 0.01)] * 6),
    "window_slides": (dict(min_requests=4, max_error_rate=0.5, window=4),
                      [("canary", False, 0.01), ("canary", True, 0.01)] * 6
                      + [("canary", False, 0.01)] * 3),
}


@pytest.mark.parametrize("name", sorted(GUARDRAILS))
def test_canary_guardrail_script(name):
    guardrail, script = GUARDRAILS[name]

    def run(canary):
        c = canary.CanaryController(weight_pct=50.0,
                                    guardrail=canary.GuardrailConfig(**guardrail),
                                    rng=random.Random(0))
        trace = []
        for step in script:
            if step[0] == "weight":
                c.set_weight(step[1])
            elif step[0] == "abort":
                c.abort()
            else:
                trace.append(c.record(*step))
            trace.append(c.snapshot())
        return trace, c.state_doc()

    assert run(pcanary) == run(jcanary)


def test_canary_state_document_adopted_across_packages():
    for src_mod, dst_mod in ((jcanary, pcanary), (pcanary, jcanary)):
        src = src_mod.CanaryController(weight_pct=40.0)
        src.set_weight(15.0, guardrail=src_mod.GuardrailConfig(min_requests=3))
        src.abort("bad rollout")
        dst = dst_mod.CanaryController()
        assert dst.adopt_state(json.loads(json.dumps(src.state_doc())))
        assert dst.snapshot() == src.snapshot()


#: probe scripts: (ok, reason, down_after, up_after) or ("mark_down", reason)
PROBES = {
    "streaks": [(False, "boom", 2, 2), (False, "boom", 2, 2), (True, None, 2, 2),
                (False, "boom", 2, 2), (True, None, 2, 2), (True, None, 2, 2)],
    "data_path_mark_down": [("mark_down", "refused"), ("mark_down", "again"),
                            (True, None, 2, 1)],
    "single_flap": [(False, "x", 1, 1), (True, None, 1, 1), (False, "x", 3, 1),
                    (False, "x", 3, 1), (False, "x", 3, 1)],
}


@pytest.mark.parametrize("name", sorted(PROBES))
def test_membership_hysteresis_script(name):
    def run(mods):
        _, mem, _, res, _ = mods
        b = mem.Backend(mem.BackendSpec.parse("127.0.0.1:1", "stable"),
                        clock=res.ManualClock())
        trace = []
        for step in PROBES[name]:
            if step[0] == "mark_down":
                trace.append(b.mark_down(step[1]))
            else:
                trace.append(b.record_probe(*step))
            trace.append((b.state, b.is_routable()))
        return trace, b.snapshot()

    assert run(PORT) == run(JAX)


def test_breaker_open_makes_a_backend_unroutable():
    def run(mods):
        _, mem, _, res, _ = mods
        clock = res.ManualClock()
        b = mem.Backend(mem.BackendSpec.parse("127.0.0.1:1", "stable"), clock=clock)
        for _ in range(3):
            b.resilience.breaker.record_failure()
        out = [b.state, b.is_routable()]
        clock.advance(10.0)
        return out + [b.is_routable(), b.snapshot()]

    assert run(PORT) == run(JAX) == ["up", False, True, run(PORT)[3]]


def test_routable_filters_groups_and_exclusions():
    def run(mods):
        _, mem, _, res, _ = mods
        backends = [mem.Backend(mem.BackendSpec.parse(f"127.0.0.1:{i}", g),
                                clock=res.ManualClock())
                    for i, g in ((1, "stable"), (2, "stable"), (3, "canary"))]
        m = mem.FleetMembership(backends)
        out = [[b.id for b in m.routable("stable")], [b.id for b in m.routable("canary")]]
        backends[0].mark_down("dead")
        out += [[b.id for b in m.routable("stable")],
                [b.id for b in m.routable("stable", exclude={"127.0.0.1:2"})]]
        return out, m.snapshot()

    assert run(PORT) == run(JAX)


@pytest.mark.parametrize("text, group", [("10.0.0.7:8000", "canary"), ("h:1", "stable"),
                                         ("no-port", "stable"), ("h:port", "stable"),
                                         ("[::1]:80", "stable")])
def test_backend_spec_parse(text, group):
    def run(mem):
        try:
            spec = mem.BackendSpec.parse(text, group)
        except ValueError as exc:
            return str(exc)
        return (spec.host, spec.port, spec.group, spec.id)

    assert run(pmem) == run(jmem)


HISTORIES = [[0.01, 0.02, 0.05, 0.01, 0.3, 0.02, 0.02], [0.2] * 19, [0.2] * 20,
             [0.2] * 20 + [30.0] * 50, [0.001 * i for i in range(1, 200)]]


@pytest.mark.parametrize("history", range(len(HISTORIES)))
def test_hedge_policy_decisions(history):
    def run(router):
        p = router.HedgePolicy(min_delay_ms=10, max_delay_ms=500, min_samples=20)
        out = []
        for lat in HISTORIES[history]:
            p.observe(lat)
            out.append(p.delay_s())
        out += [p.should_hedge(alt, budget) for alt in (0, 1, 3)
                for budget in (None, 10.0, 0.001)]
        return out

    assert run(prouter) == run(jrouter)


def test_router_config_env_defaults(monkeypatch):
    monkeypatch.setenv("PIO_ROUTER_MAX_INFLIGHT", "7")
    monkeypatch.setenv("PIO_ROUTER_HEDGE", "true")
    monkeypatch.setenv("PIO_ROUTER_PROBE_TIMEOUT_S", "2.5")
    got = prouter.RouterConfig().__dict__
    assert got == jrouter.RouterConfig().__dict__
    assert (got["max_inflight"], got["hedge"], got["probe_timeout_s"]) == (7, True, 2.5)
    monkeypatch.setenv("PIO_ROUTER_MAX_INFLIGHT", "bogus")
    assert prouter.RouterConfig().max_inflight == jrouter.RouterConfig().max_inflight == 128


def test_admission_gate():
    def run(router):
        gate = router.AdmissionGate(2)
        out = [gate.admit(), gate.admit(), gate.admit(), gate.inflight, gate.headroom()]
        gate.release()
        return out + [gate.inflight, gate.headroom(), gate.admit()]

    assert run(prouter) == run(jrouter)


def test_forwarded_headers_equal_jax():
    assert prouter._FORWARD_HEADERS == jrouter._FORWARD_HEADERS
    assert {"x-pio-experiment", "x-pio-variant"} <= set(prouter._FORWARD_HEADERS)


# -- the routers over HTTP -------------------------------------------------------

def _spawn_replicas(tags):
    procs, ports = [], []
    for tag in tags:
        port = free_port()
        procs.append(subprocess.Popen([sys.executable, str(CHILD), "--port", str(port),
                                       "--tag", tag]))
        ports.append(port)
    for port in ports:
        wait_until(lambda port=port: _get(port, "/healthz")[0] == 200, timeout=10,
                   message=f"replica :{port}")
    return procs, ports


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait(timeout=10)


@pytest.fixture(scope="module")
def replicas():
    procs, ports = _spawn_replicas(["s0", "s1", "c0"])
    yield ports
    _stop(procs)


def _request(port, method, path, body=None, headers=None, timeout=10.0):
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), {k.lower(): v for k, v in r.headers.items()}
    except urllib.error.HTTPError as e:
        return e.code, e.read(), {k.lower(): v for k, v in e.headers.items()}


def _get(port, path):
    status, raw, _ = _request(port, "GET", path)
    return status, raw


def _router(rs, router, stable, canary=(), **kw):
    config = router.RouterConfig(
        ip="127.0.0.1", port=0, backends=tuple(f"127.0.0.1:{p}" for p in stable),
        canary_backends=tuple(f"127.0.0.1:{p}" for p in canary),
        probe_interval_s=kw.pop("probe_interval_s", 0.25), **kw)
    server = rs.RouterServer(config)
    server.start()
    return server


def _both(replicas, **kw):
    out = []
    for _, _, router, _, rs in (JAX, PORT):
        out.append(_router(rs, router, replicas[:2], **kw))
    return out


def _key_paths(doc, prefix=""):
    if isinstance(doc, dict):
        out = set()
        for k, v in doc.items():
            out |= {f"{prefix}/{k}"} | _key_paths(v, f"{prefix}/{k}")
        return out
    if isinstance(doc, list):
        return set().union(*(_key_paths(v, prefix + "[]") for v in doc)) if doc else set()
    return set()


def _families(text):
    return {(line.split()[2], line.split()[3]) for line in text.splitlines()
            if line.startswith("# TYPE ")}


#: (method, path, body, headers): a query script, replica answers and the
#: router's own refusals alike
SCRIPT = ([("POST", "/queries.json", {"user": f"u{i}", "num": i}, {}) for i in range(6)]
          + [("POST", "/queries.json", b"{not json", {}),
             ("POST", "/queries.json", {"user": "x"}, {"X-PIO-Engine": "nope"}),
             ("POST", "/engines/nope/queries.json", {"user": "x"}, {}),
             ("GET", "/queries.json", None, {}),
             ("GET", "/nope", None, {}),
             ("GET", "/healthz", None, {}),
             ("GET", "/readyz", None, {}),
             ("POST", "/fleet/canary", {"weight": 150}, {}),
             ("POST", "/fleet/canary", b"[1]", {}),
             ("POST", "/fleet/experiments", {"action": "frobnicate"}, {}),
             ("POST", "/stop", b"", {})])


def test_query_script_equal_through_both_routers(replicas):
    routers = _both(replicas, router_key=KEY)
    try:
        results = []
        for server in routers:
            out = []
            for method, path, body, headers in SCRIPT:
                status, raw, hdrs = _request(server.port, method, path, body,
                                             {"X-PIO-Request-Id": "rid-1", **headers})
                out.append((status, json.loads(raw), hdrs.get("x-pio-request-id")))
            results.append(out)
        assert results[1] == results[0]
        statuses = [s for s, *_ in results[1]]
        assert statuses[:6] == [200] * 6 and 500 not in statuses
        assert {body["tag"] for _, body, _ in results[1][:6]} == {"s0", "s1"}
        assert statuses[-1] == 401                       # /stop without the key
    finally:
        for server in routers:
            server.stop()


def test_fleet_documents_and_metric_families_equal(replicas):
    routers = _both(replicas)
    try:
        docs = []
        for server in routers:
            for i in range(4):
                assert _request(server.port, "POST", "/queries.json", {"i": i})[0] == 200
            docs.append({path: _get(server.port, path) for path in
                         ("/fleet", "/stats.json", "/fleet/canary", "/fleet/engines",
                          "/fleet/experiments", "/metrics", "/fleet/metrics",
                          "/traces.json")})
        (jdoc, pdoc) = docs
        for path in ("/fleet", "/stats.json", "/fleet/canary", "/fleet/engines",
                     "/fleet/experiments", "/traces.json"):
            assert pdoc[path][0] == jdoc[path][0] == 200
            assert _key_paths(json.loads(pdoc[path][1])) == \
                _key_paths(json.loads(jdoc[path][1])), path
        for path in ("/metrics", "/fleet/metrics"):
            got, want = _families(pdoc[path][1].decode()), _families(jdoc[path][1].decode())
            assert got == want, path
        assert ("pio_resilience_breaker_state", "gauge") in \
            _families(pdoc["/metrics"][1].decode())
        fleet_text = pdoc["/fleet/metrics"][1].decode()
        assert "pio_child_requests_total" in fleet_text
        assert fleet_text.count('pio_fleet_scrape_ok{group="stable"') == 2
    finally:
        for server in routers:
            server.stop()


def test_engine_groups_route_by_path_and_header(replicas):
    def run(mods):
        gw_mod = sys.modules[mods[2].__name__.replace(".router", ".gateway")]
        config = mods[2].RouterConfig(
            ip="127.0.0.1", port=0, probe_interval_s=0.25,
            engines=(gw_mod.EngineSpec(name="rec", backends=(f"127.0.0.1:{replicas[0]}",)),
                     gw_mod.EngineSpec(name="ecom",
                                       backends=(f"127.0.0.1:{replicas[2]}",))),
            default_engine="rec")
        server = mods[4].RouterServer(config)
        server.start()
        try:
            out = []
            for path, headers in (("/queries.json", {}),
                                  ("/queries.json", {"X-PIO-Engine": "ecom"}),
                                  ("/engines/ecom/queries.json", {}),
                                  ("/engines/rec/queries.json", {}),
                                  ("/engines/zzz/queries.json", {})):
                status, raw, _ = _request(server.port, "POST", path, {"q": 1}, headers)
                out.append((status, json.loads(raw).get("tag")))
            return out, _families(_get(server.port, "/metrics")[1].decode())
        finally:
            server.stop()

    import predictionio_tpu.fleet.gateway  # noqa: F401
    import predictionio_tpu_torch.fleet.gateway  # noqa: F401

    got = run(PORT)
    assert got == run(JAX)
    assert got[0] == [(200, "s0"), (200, "c0"), (200, "c0"), (200, "s0"), (404, None)]


def test_replica_killed_mid_script_costs_no_5xx():
    procs, ports = _spawn_replicas(["k0", "k1"])
    server = _router(prs, prouter, ports, probe_interval_s=0.2)
    try:
        statuses, tags = [], []
        for i in range(40):
            if i == 10:
                procs[0].send_signal(signal.SIGKILL)
                procs[0].wait(timeout=5)
            status, raw, _ = _request(server.port, "POST", "/queries.json", {"i": i})
            statuses.append(status)
            tags.append(json.loads(raw).get("tag"))
        assert statuses == [200] * 40
        assert set(tags[15:]) == {"k1"}
        doc = json.loads(_get(server.port, "/fleet")[1])
        assert doc["router"]["retries"] >= 1
        wait_until(lambda: {b["id"]: b["state"] for b in json.loads(
            _get(server.port, "/fleet")[1])["backends"]}[f"127.0.0.1:{ports[0]}"] == "down",
            timeout=10, message="the killed replica marked down")
    finally:
        server.stop()
        _stop(procs)


def test_canary_weight_and_promotion_over_http(replicas):
    server = _router(prs, prouter, replicas[:2], canary=replicas[2:], router_key=KEY)
    try:
        def tags(n):
            return [json.loads(_request(server.port, "POST", "/queries.json", {"i": i})[1])
                    ["tag"] for i in range(n)]

        assert "c0" not in tags(20)                         # weight 0
        assert _request(server.port, "POST", "/fleet/canary", {"weight": 50})[0] == 401
        status, raw, _ = _request(server.port, "POST", f"/fleet/canary?accessKey={KEY}",
                                  {"weight": 50})
        assert status == 200 and json.loads(raw)["weightPct"] == 50.0
        share = tags(200).count("c0") / 200
        assert abs(share - 0.5) <= 5 * (0.25 / 200) ** 0.5
        # promotion: the whole traffic goes to the canary group
        assert _request(server.port, "POST", f"/fleet/canary?accessKey={KEY}",
                        {"weight": 100})[0] == 200
        assert set(tags(20)) == {"c0"}
        status, raw, _ = _request(server.port, "POST", f"/fleet/canary?accessKey={KEY}",
                                  {"action": "abort"})
        assert status == 200 and json.loads(raw)["aborted"] is True
        assert "c0" not in tags(20)
    finally:
        server.stop()


def test_stop_needs_the_router_key(replicas):
    server = _router(prs, prouter, replicas[:1], router_key=KEY)
    try:
        assert _request(server.port, "POST", "/stop", b"")[0] == 401
        assert _request(server.port, "POST", "/stop?accessKey=wrong", b"")[0] == 401
        assert not server.stopped.is_set()
        assert _request(server.port, "POST", f"/stop?accessKey={KEY}", b"")[0] == 200
        assert server.stopped.wait(10)
    finally:
        server.stop()


def test_stitched_trace_and_pio_trace(replicas, capsys, tmp_path):
    from predictionio_tpu_torch.cli import pio

    server = _router(prs, prouter, replicas[:2], tracing=True)
    try:
        status, _, headers = _request(server.port, "POST", "/queries.json", {"i": 1})
        trace_id = headers["x-pio-trace-id"]
        wait_until(lambda: _get(server.port, f"/traces.json?trace_id={trace_id}")[0] == 200,
                   timeout=5, message="the router's segment")
        router = f"127.0.0.1:{server.port}"
        assert pio.main(["trace", trace_id, "--router", router]) == 0
        text = capsys.readouterr().out
        assert "queries.json" in text and "attempt" in text
        out = tmp_path / "trace.json"
        assert pio.main(["trace", trace_id, "--router", router, "--chrome",
                         "--out", str(out)]) == 0
        assert json.loads(out.read_text())["traceEvents"]
        assert pio.main(["trace", "no-such-trace", "--router", router]) == 1
    finally:
        server.stop()


def test_pio_experiment_against_the_port_router(replicas, capsys):
    server = _router(prs, prouter, replicas[:1], router_key=KEY)
    storage = memory_storage()
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    results = {"engineParamsScores": [{"score": 0.2}, {"score": 0.9}, {"score": None}]}
    instance_id = storage.get_meta_data_evaluation_instances().insert(EvaluationInstance(
        id="", status="EVALCOMPLETED", start_time=t0, completion_time=t0,
        evaluator_results_json=json.dumps(results)))
    router = f"127.0.0.1:{server.port}"
    common = dict(router=router, router_key=KEY, timeout=10.0)
    try:
        args = Namespace(experiment_cmd="start", name="ab", instance=instance_id, top_k=2,
                         backends=[f"127.0.0.1:{replicas[1]}", f"127.0.0.1:{replicas[2]}"],
                         ascending=False, ramp_s=60.0, measure_s=60.0, min_requests=20,
                         conversion_weight=0.5, max_error_rate=0.5, max_p99_ms=0.0,
                         guardrail_min_requests=20, guardrail_window=200, **common)
        assert pcli._cmd_experiment(args, storage) == 0
        stamps = set()
        for i in range(20):
            status, raw, headers = _request(server.port, "POST", "/queries.json", {"i": i})
            body = json.loads(raw)
            assert status == 200
            assert (body["experimentId"], body["variantId"]) == (
                headers["x-pio-experiment"], headers["x-pio-variant"])
            stamps.add((body["variantId"], body["tag"]))
        # the best offline point (grid index 1) serves from the first group
        assert stamps == {("ab-v1", "s1"), ("ab-v0", "c0")}
        assert pcli._cmd_experiment(Namespace(experiment_cmd="status", **common), None) == 0
        assert "experiment ab" in capsys.readouterr().out
        snap = json.loads(_get(server.port, "/fleet/experiments")[1])["experiment"]
        assert sum(v["requests"] for v in snap["variants"]) == 20
        metrics = _get(server.port, "/metrics")[1].decode()
        assert "pio_experiment_requests_total" in metrics
        assert "pio_eval_points_total" in metrics
    finally:
        server.stop()


# -- `pio router` as a process ----------------------------------------------------

ROUTER_PROCESS = textwrap.dedent("""
    import json, sys, threading, time, urllib.request
    from predictionio_tpu_torch.cli import pio

    port, key = int(sys.argv[1]), sys.argv[2]

    def check():
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 12
        streak, doc = 0, None
        while time.time() < deadline and streak < 10:
            try:
                with urllib.request.urlopen(base + "/queries.json", data=b"{}", timeout=2) as r:
                    streak = streak + 1 if r.status == 200 else 0
                with urllib.request.urlopen(base + "/fleet", timeout=2) as r:
                    doc = json.loads(r.read())
            except OSError:
                streak = 0
                time.sleep(0.1)
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            metrics = r.read().decode()
        print(json.dumps({"torch": "torch" in sys.modules, "jax": "jax" in sys.modules,
                          "streak": streak, "supervisor": "supervisor" in (doc or {}),
                          "workers": [l for l in metrics.splitlines()
                                      if l.startswith("pio_router_workers")]}), flush=True)
        req = urllib.request.Request(base + f"/stop?accessKey={key}", data=b"", method="POST")
        urllib.request.urlopen(req, timeout=5).close()

    threading.Thread(target=check, daemon=True).start()
    sys.exit(pio.main(sys.argv[3:]))
""")


@pytest.mark.parametrize("workers", [1, 2])
def test_pio_router_process_loads_no_torch(workers, tmp_path):
    port, base = free_port(), free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "TMPDIR": str(tmp_path)}
    argv = ["router", "--ip", "127.0.0.1", "--port", str(port), "--router-key", KEY,
            "--supervise", "--replica-cmd",
            f"{sys.executable} {CHILD} --port {{port}} --tag t",
            "--replica-port-base", str(base), "--replicas", "2",
            "--probe-interval-s", "0.2", "--workers", str(workers)]
    proc = subprocess.run([sys.executable, "-c", ROUTER_PROCESS, str(port), KEY, *argv],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=18)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert proc.returncode == 0 and lines, proc.stdout + proc.stderr
    doc = json.loads(lines[-1])
    assert doc["torch"] is False and doc["jax"] is False
    assert doc["streak"] >= 10
    if workers > 1:
        assert doc["workers"] in (["pio_router_workers 2"], ["pio_router_workers 1"])
    else:
        assert doc["supervisor"] is True
    assert "Fleet Router listening" in proc.stdout
