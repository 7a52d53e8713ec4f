"""The port's ``fleet/gateway.py`` held against the JAX package's.

``parse_engine_flag`` over a table of flag strings (the malformed ones
must raise in both, with the same message), ``EngineSpec`` documents,
the per-engine token bucket's admit/reject sequences and burst credits
under a ``ManualClock``, and an ``EngineGateway``'s route resolution,
runtime table mutations, shared table document and metric families.
No gateway here is started: nothing is probed or forwarded.
"""

from __future__ import annotations

import pytest

from predictionio_tpu.fleet import gateway as jgw
from predictionio_tpu.fleet import router as jrouter
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu_torch.fleet import gateway as pgw
from predictionio_tpu_torch.fleet import router as prouter
from predictionio_tpu_torch.utils import resilience as pres

JAX = (jgw, jrouter, jres)
PORT = (pgw, prouter, pres)


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except (ValueError, KeyError, TypeError) as exc:
        return (type(exc).__name__, str(exc))


FLAGS = [
    "name=rec,backend=10.0.0.1:8000+10.0.0.2:8000,canary=10.0.0.3:8000,"
    "weight=12.5,qps=100,burst=200,max-inflight=64,replicas=2,port-base=8300",
    "name=ecom,backend=h:1",
    "name=a-b_c.9,backend= h:1 + h:2 ,credits=50,min-replicas=1,max-replicas=4",
    "name=x,,backend=h:1,",
    "name=rec-v3",
    "backend=1.2.3.4:80",
    "name=x,bogus=1",
    "name=x,qps=fast",
    "name=x,replicas=2.5",
    "name=a/b",
    "name=,backend=h:1",
    "name=x,backend",
    "",
]


@pytest.mark.parametrize("text", FLAGS)
def test_parse_engine_flag_equal_jax(text):
    want = _outcome(jgw.parse_engine_flag, text)
    got = _outcome(pgw.parse_engine_flag, text)
    assert got == want


def test_engine_query_path_and_constants():
    for name in ("rec", "rec-v3", "a.b_c"):
        assert pgw.engine_query_path(name) == jgw.engine_query_path(name)
    assert pgw.QUERIES_PATH == jgw.QUERIES_PATH
    assert pgw.ENGINE_NAME_RE.pattern == jgw.ENGINE_NAME_RE.pattern


SPECS = [
    dict(name="ecom", backends=("h:1", "h:2"), canary_backends=("h:3",),
         canary_weight_pct=5.0, quota_qps=10.0, quota_burst=None, max_inflight=8),
    dict(name="rec", backends=("h:1",), quota_qps=10.0, burst_credits=50.0,
         min_replicas=1, max_replicas=4),
    dict(name="bad name"),
    dict(name="w", canary_weight_pct=150.0),
    dict(name="q", quota_qps=-1.0),
]


@pytest.mark.parametrize("kw", SPECS, ids=[s["name"] for s in SPECS])
def test_engine_spec_doc_round_trip(kw):
    def run(gw):
        spec = _outcome(gw.EngineSpec, **kw)
        if spec[0] != "ok":
            return spec
        doc = spec[1].to_doc()
        return doc, gw.EngineSpec.from_doc(doc) == spec[1], spec[1].topology_key()

    assert run(pgw) == run(jgw)


#: quota scripts: ("admit", fleet_idle) / ("release",) / ("advance", s)
QUOTA_SCRIPTS = {
    "burst_then_refill": (dict(qps=10.0, burst=5.0),
                          [("admit", False)] * 6 + [("advance", 0.05), ("admit", False),
                                                    ("advance", 0.05), ("admit", False),
                                                    ("admit", False)]),
    "burst_caps_refill": (dict(qps=100.0, burst=3.0),
                          [("admit", False)] * 3 + [("advance", 60.0)]
                          + [("admit", False)] * 5),
    "inflight_cap": (dict(max_inflight=2),
                     [("admit", False)] * 3 + [("release",), ("admit", False)]),
    "default_burst_is_qps": (dict(qps=0.4), [("admit", False)] * 3
                             + [("advance", 2.5), ("admit", False)]),
    "unlimited": (dict(), [("admit", False)] * 50),
    "credits_spend_with_headroom": (
        dict(qps=1.0, burst=2.0, burst_credits=3.0),
        [("advance", 10.0), ("admit", False), ("admit", False), ("admit", False)]
        + [("admit", True)] * 4),
    "no_reservoir_no_borrowing": (
        dict(qps=1.0, burst=2.0),
        [("advance", 10.0)] + [("admit", False)] * 2 + [("admit", True)]),
}


@pytest.mark.parametrize("name", sorted(QUOTA_SCRIPTS))
def test_quota_admit_reject_sequence(name):
    kw, script = QUOTA_SCRIPTS[name]

    def run(gw, res):
        clock = res.ManualClock()
        quota = gw.EngineQuota(clock=clock, **kw)
        trace = [(quota.limited, quota.burst)]
        for step in script:
            if step[0] == "admit":
                hint = quota.try_admit(fleet_idle=step[1])
                trace.append(None if hint is None else round(hint, 9))
            elif step[0] == "release":
                quota.release()
            else:
                clock.advance(step[1])
        trace.append(quota.snapshot())
        return trace

    got = run(pgw, pres)
    assert got == run(jgw, jres)
    assert any(step is not None for step in got[1:-1]) or not got[0][0]


def test_per_engine_buckets_are_independent():
    def run(gw, res):
        clock = res.ManualClock()
        a = gw.EngineQuota(qps=5.0, burst=2.0, clock=clock)
        b = gw.EngineQuota(qps=5.0, burst=2.0, clock=clock)
        return [a.try_admit(), a.try_admit(), a.try_admit() is not None,
                b.try_admit(), b.try_admit()]

    assert run(pgw, pres) == run(jgw, jres) == [None, None, True, None, None]


# -- the gateway (built, never started) ----------------------------------------

def _gateway(mods):
    gw, router, res = mods
    config = router.RouterConfig(
        ip="127.0.0.1", port=0, backends=("127.0.0.1:1",),
        engines=(gw.EngineSpec(name="rec", backends=("127.0.0.1:2",), quota_qps=5.0),
                 gw.EngineSpec(name="ecom", backends=("127.0.0.1:3", "127.0.0.1:4"),
                               canary_backends=("127.0.0.1:5",),
                               canary_weight_pct=10.0)))
    return gw.EngineGateway(config, clock=res.ManualClock())


ROUTES = [("/queries.json", {}), ("/queries.json", {"x-pio-engine": "rec"}),
          ("/queries.json", {"x-pio-engine": "nope"}),
          ("/engines/ecom/queries.json", {}),
          ("/engines/ecom/queries.json", {"x-pio-engine": "rec"}),
          ("/engines/none/queries.json", {}), ("/queries", {}), ("/fleet", {})]


def test_gateway_resolution_equal_jax():
    def run(mods):
        gateway = _gateway(mods)
        try:
            return (gateway.default_engine, gateway.engine_names(), gateway.labeled,
                    [gateway.is_query_path(p) for p, _ in ROUTES],
                    [getattr(gateway.resolve(p, h), "name", None) for p, h in ROUTES])
        finally:
            gateway.close()

    got = run(PORT)
    assert got == run(JAX)
    assert got[4][:5] == ["default", "rec", None, "ecom", "ecom"]


#: POST /fleet/engines bodies, applied in order
ADMIN_SCRIPT = [
    {"action": "register", "engine": {"name": "rec-v2", "backends": ["127.0.0.1:6"]}},
    {"action": "register", "engine": {"name": "rec-v2", "backends": ["127.0.0.1:7"]}},
    {"action": "register", "engine": {"name": "bad name"}},
    {"action": "quota", "name": "rec", "qps": 50, "burst": 60},
    {"action": "weight", "name": "ecom", "weight": 25},
    {"action": "weight", "name": "ecom", "weight": 250},
    {"action": "default", "name": "rec-v2"},
    {"action": "retire", "name": "ecom"},
    {"action": "retire", "name": "ecom"},
    {"action": "frobnicate", "name": "rec"},
    {"action": "retire"},
]


def _mutations(gateway):
    out = []
    for doc in ADMIN_SCRIPT:
        result = _outcome(gateway.admin_mutate, doc)
        out.append(result[0] if result[0] == "ok" else result)
    return out


def test_gateway_admin_mutations_equal_jax():
    def run(mods):
        gateway = _gateway(mods)
        try:
            verdicts = _mutations(gateway)
            return (verdicts, gateway.snapshot(), gateway.table_doc(),
                    gateway.default_engine, gateway.engine_names())
        finally:
            gateway.close()

    got = run(PORT)
    assert got == run(JAX)
    assert got[0].count("ok") == 5 and got[3] == "rec-v2"


def test_gateway_table_document_adopted_by_a_sibling():
    """The cumulative table a worker publishes, adopted by a sibling of
    the other package: both packages read each other's document."""
    for source, target in ((PORT, JAX), (JAX, PORT)):
        a, b = _gateway(source), _gateway(target)
        try:
            _mutations(a)
            assert b.adopt_table(a.table_doc()) is True
            assert b.engine_names() == a.engine_names()
            assert b.default_engine == a.default_engine
            assert b.table_doc() == a.table_doc()
            assert b.adopt_table(a.table_doc()) is False
        finally:
            a.close()
            b.close()


def test_gateway_metric_families_equal_jax():
    def run(mods):
        gateway = _gateway(mods)
        try:
            _mutations(gateway)
            gateway.record_outcome("rec", ok=True, latency_s=0.01)
            gateway.record_outcome("rec", ok=False, latency_s=0.02)
            gateway.record_outcome(None, ok=True, latency_s=0.01)
            return sorted((m.name, m.kind, sorted(
                (tuple(sorted(lb.items())), v) for lb, v in m.samples))
                for m in gateway.collector()())
        finally:
            gateway.close()

    got = run(PORT)
    assert got == run(JAX)
    assert any(name == "pio_router_quota_throttled_total" for name, *_ in got)
