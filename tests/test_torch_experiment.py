"""The port's experiment plane held against the JAX package's:
``experiment/controller.py`` (define → ramp → measure → promote|abort
over the canary guardrails), ``experiment/cli.py``'s grid ranking and
conversion sweep, and the event server's conversion counters.

The same scripts on a ``ManualClock`` with a seeded ``random.Random``
give equal lifecycle transitions, verdicts, gateway actions, snapshots
and metric families, equal assignment sequences over 10,000 draws, and
shared-state documents that each package adopts from the other.
"""

from __future__ import annotations

import json
import random
from datetime import datetime, timezone

import pytest

from predictionio_tpu.api import event_server as jes
from predictionio_tpu.experiment import cli as jcli
from predictionio_tpu.experiment import controller as jexp
from predictionio_tpu.fleet import canary as jcanary
from predictionio_tpu.storage.base import AccessKey as JaxAccessKey
from predictionio_tpu.storage.base import App as JaxApp
from predictionio_tpu.storage.base import EvaluationInstance as JaxEvaluationInstance
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu.utils.testing import memory_storage as jax_memory_storage
from predictionio_tpu_torch.api import event_server as pes
from predictionio_tpu_torch.experiment import cli as pcli
from predictionio_tpu_torch.experiment import controller as pexp
from predictionio_tpu_torch.fleet import canary as pcanary
from predictionio_tpu_torch.storage.base import AccessKey, App, EvaluationInstance
from predictionio_tpu_torch.storage.registry import memory_storage
from predictionio_tpu_torch.utils import resilience as pres

JAX = (jexp, jcanary, jres)
PORT = (pexp, pcanary, pres)


class RecordingGateway:
    """Records the promotion's actions; retiring an unknown engine raises
    KeyError like the real gateway."""

    def __init__(self):
        self.engines = {"a", "b", "c"}
        self.actions: list[tuple[str, str]] = []

    def set_default(self, name):
        if name not in self.engines:
            raise KeyError(name)
        self.actions.append(("default", name))

    def retire(self, name):
        if name not in self.engines:
            raise KeyError(name)
        self.engines.discard(name)
        self.actions.append(("retire", name))


def _config(mods, **overrides):
    exp, canary, _ = mods
    kw = dict(name="exp", ramp_s=5.0, measure_s=30.0, min_requests=4,
              conversion_weight=0.5,
              guardrail=canary.GuardrailConfig(min_requests=5, max_error_rate=0.4,
                                               max_p99_ms=0.0, window=20))
    kw.update(overrides)
    return exp.ExperimentConfig(**kw)


def _controller(mods, seed=7, gateway=None):
    exp, _, res = mods
    clock = res.ManualClock()
    return exp.ExperimentController(gateway=gateway, clock=clock,
                                    rng=random.Random(seed)), clock


def _variants(mods, *names, weights=None):
    exp = mods[0]
    weights = weights or [100.0 / max(1, len(names))] * len(names)
    return [exp.VariantSpec(name=n, weight_pct=w, grid_idx=i)
            for i, (n, w) in enumerate(zip(names, weights))]


#: lifecycle scripts: ("define", config overrides, names), ("feed", variant,
#: n, ok, latency_s), ("tick",), ("advance", s), ("conv", variant, total),
#: ("abort", reason), ("assign", n)
LIFECYCLES = {
    "ramp_measure_promote": [
        ("define", {}, ("a", "b")), ("feed", "a", 10, True, 0.01),
        ("feed", "b", 10, True, 0.01), ("tick",), ("advance", 5.0), ("tick",),
        ("tick",), ("advance", 30.0), ("feed", "b", 2, False, 0.01), ("tick",)],
    "promotion_waits_for_min_requests": [
        ("define", {}, ("a", "b")), ("advance", 5.0), ("tick",), ("advance", 30.0),
        ("feed", "a", 10, True, 0.01), ("feed", "b", 3, True, 0.01), ("tick",),
        ("feed", "b", 1, True, 0.01)],
    "operator_abort": [("define", {}, ("a", "b")), ("abort", "rollback"), ("assign", 5)],
    "breaching_variant_auto_aborts": [
        ("define", {}, ("a", "b")), ("feed", "a", 10, True, 0.01),
        ("feed", "b", 6, False, 0.01), ("assign", 20)],
    "all_arms_breached": [("define", {}, ("a", "b")), ("feed", "a", 6, False, 0.01),
                          ("feed", "b", 6, False, 0.01)],
    "conversions_decide_ties": [
        ("define", {}, ("a", "b")), ("advance", 5.0), ("tick",),
        ("feed", "a", 10, True, 0.01), ("feed", "b", 10, True, 0.01), ("conv", "b", 7),
        ("advance", 30.0), ("tick",)],
    "totals_are_cumulative": [
        ("define", {}, ("a",)), ("feed", "a", 10, True, 0.01), ("conv", "a", 5),
        ("conv", "a", 3), ("conv", "a", 5), ("conv", "ghost", 1)],
    "conversion_rate_capped": [("define", dict(conversion_weight=1.0), ("a",)),
                               ("feed", "a", 4, True, 0.01), ("conv", "a", 400)],
    "latency_guardrail": [
        ("define", dict(guardrail=None), ("a", "b", "c")),
        ("feed", "a", 8, True, 0.01), ("feed", "b", 8, True, 2.5),
        ("feed", "c", 8, True, 0.02), ("advance", 5.0), ("tick",), ("assign", 30)],
    "terminal_state_stops_splitting": [
        ("define", dict(measure_s=0.0), ("a",)), ("advance", 5.0), ("tick",),
        ("feed", "a", 4, True, 0.01), ("assign", 3)],
}


def _run_lifecycle(mods, script, seed=7):
    exp, canary, _ = mods
    gateway = RecordingGateway()
    ctl, clock = _controller(mods, seed=seed, gateway=gateway)
    trace = []
    for step in script:
        op = step[0]
        if op == "define":
            overrides = dict(step[1])
            if "guardrail" in overrides:
                overrides["guardrail"] = canary.GuardrailConfig(
                    min_requests=5, max_error_rate=0.9, max_p99_ms=500.0, window=20)
            try:
                ctl.define(_config(mods, **overrides), _variants(mods, *step[2]))
                trace.append("defined")
            except ValueError as exc:
                trace.append(("ValueError", str(exc)))
        elif op == "feed":
            trace.append([ctl.record(step[1], ok=step[3], latency_s=step[4])
                          for _ in range(step[2])])
        elif op == "tick":
            trace.append(ctl.tick())
        elif op == "advance":
            clock.advance(step[1])
        elif op == "conv":
            trace.append(ctl.record_conversions(step[1], step[2]))
        elif op == "abort":
            ctl.abort(step[1])
        else:
            trace.append([ctl.assign() for _ in range(step[1])])
        trace.append(ctl.snapshot())
    return trace, gateway.actions, ctl.collector(), ctl.state_doc()


def _families(families):
    return [(m.name, m.kind, sorted((tuple(sorted(lb.items())), v) for lb, v in m.samples))
            for m in families]


@pytest.mark.parametrize("name", sorted(LIFECYCLES))
def test_lifecycle_equal_jax(name):
    want = _run_lifecycle(JAX, LIFECYCLES[name])
    got = _run_lifecycle(PORT, LIFECYCLES[name])
    assert got[:2] == want[:2]
    assert _families(got[2]) == _families(want[2])
    assert got[3] == want[3]


EXPECTED_END = {
    "ramp_measure_promote": (pexp.PROMOTED, "a", [("default", "a"), ("retire", "b")]),
    "all_arms_breached": (pexp.ABORTED, None, [("retire", "a"), ("retire", "b")]),
    "conversions_decide_ties": (pexp.PROMOTED, "b", [("default", "b"), ("retire", "a")]),
    "operator_abort": (pexp.ABORTED, None, []),
}


@pytest.mark.parametrize("name", sorted(EXPECTED_END))
def test_lifecycle_verdict(name):
    trace, actions, _, _ = _run_lifecycle(PORT, LIFECYCLES[name])
    state, winner, want_actions = EXPECTED_END[name]
    snap = next(s for s in reversed(trace) if isinstance(s, dict))
    assert snap["state"] == state
    assert (snap.get("decision") or {}).get("winner") == winner
    assert sorted(actions) == sorted(want_actions)


def test_define_validates_equal_jax():
    for names in ((), ("a", "a")):
        out = []
        for mods in (JAX, PORT):
            ctl, _ = _controller(mods)
            with pytest.raises(ValueError) as exc:
                ctl.define(_config(mods), _variants(mods, *names))
            out.append(str(exc.value))
        assert out[0] == out[1]


@pytest.mark.parametrize("weights", [(90.0, 10.0), (50.0, 30.0, 20.0), (1.0, 1.0)])
def test_assignment_sequence_over_10000_draws(weights):
    names = tuple("abc"[:len(weights)])
    seqs = []
    for mods in (JAX, PORT):
        ctl, _ = _controller(mods, seed=123)
        ctl.define(_config(mods), _variants(mods, *names, weights=list(weights)))
        seqs.append([ctl.assign() for _ in range(10_000)])
    assert seqs[1] == seqs[0]
    share = seqs[1].count(("exp", "a")) / 10_000
    want = weights[0] / sum(weights)
    # binomial: 5 standard deviations of the share over 10,000 draws
    assert abs(share - want) <= 5 * (want * (1 - want) / 10_000) ** 0.5


@pytest.mark.parametrize("source, target", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_shared_state_document_adopted_across_packages(source, target):
    src, _ = _controller(source)
    src.define(_config(source), _variants(source, "a", "b"))
    src.record_conversions("a", 3)
    for _ in range(6):
        src.record("b", ok=False, latency_s=0.01)       # b trips its guardrail
    doc = json.loads(json.dumps(src.state_doc()))
    dst, _ = _controller(target)
    assert dst.adopt_state(doc)
    assert not dst.adopt_state(doc)                       # same seq: a no-op
    got, want = dst.snapshot(), src.snapshot()
    assert {v["name"]: (v["conversions"], v["aborted"]) for v in got["variants"]} == \
        {v["name"]: (v["conversions"], v["aborted"]) for v in want["variants"]}
    assert (got["name"], got["state"], got["seq"]) == (want["name"], want["state"], want["seq"])


def test_malformed_state_documents_ignored():
    for mods in (JAX, PORT):
        ctl, _ = _controller(mods)
        ctl.define(_config(mods), _variants(mods, "a"))
        before = ctl.state_doc()
        for junk in (None, 17, "x", {}, {"seq": "NaN-ish", "config": {}},
                     {"seq": 99, "config": {"name": "e"}, "state": "RAMP"}):
            assert not ctl.adopt_state(junk)
        assert ctl.state_doc() == before


@pytest.mark.parametrize("doc", [
    {"name": "e"},
    {"name": "e", "rampS": 1, "measureS": 2, "minRequests": 3, "conversionWeight": 0.2,
     "guardrail": {"minRequests": 4, "maxErrorRate": 0.1, "maxP99Ms": 50, "window": 9}},
    {"rampS": 1},
    {"name": "e", "minRequests": "many"},
])
def test_experiment_config_documents(doc):
    def run(mods):
        try:
            config = mods[0].ExperimentConfig.from_doc(doc)
        except (KeyError, TypeError, ValueError) as exc:
            return type(exc).__name__
        return config.to_doc()

    assert run(PORT) == run(JAX)


def test_attribution_names_equal_jax():
    for name in ("EXPERIMENT_HEADER", "VARIANT_HEADER", "EXPERIMENT_FIELD", "VARIANT_FIELD"):
        assert getattr(pexp, name) == getattr(jexp, name)
    doc = {"name": "v", "weightPct": 25, "gridIdx": 3, "offlineScore": 0.5}
    assert pexp.VariantSpec.from_doc(doc).to_doc() == jexp.VariantSpec.from_doc(doc).to_doc()


# -- conversions at the event server --------------------------------------------

KEY = "conv-key"
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)


def _event(i, event="buy", experiment="exp", variant=None):
    props = {"experimentId": experiment} if experiment else {}
    if variant:
        props["variantId"] = variant
    return {"event": event, "entityType": "user", "entityId": f"u{i}",
            "targetEntityType": "item", "targetEntityId": f"i{i}",
            "properties": props, "eventTime": "2026-01-01T00:00:00.000Z"}


ATTRIBUTED = ([_event(i, variant="exp-v0") for i in range(3)]
              + [_event(i, variant="exp-v1") for i in range(2)]
              + [_event(9, event="predict", variant="exp-v0"),       # the server's own
                 _event(8, variant=None), _event(7, experiment=None, variant="exp-v1"),
                 _event(6, experiment="other", variant="exp-v0")])


def _services():
    out = []
    for mod, storage, app_cls, key_cls in (
            (jes, jax_memory_storage(), JaxApp, JaxAccessKey),
            (pes, memory_storage(), App, AccessKey)):
        app_id = storage.get_meta_data_apps().insert(app_cls(0, "convapp"))
        storage.get_meta_data_access_keys().insert(key_cls(KEY, app_id, ()))
        storage.get_events().init(app_id)
        out.append((mod.EventService(storage, mod.EventServerConfig()), storage, app_id))
    return out


def test_event_server_conversion_counts_equal_jax():
    services = _services()
    try:
        docs = []
        for svc, storage, app_id in services:
            params = {"accessKey": KEY}
            for event in ATTRIBUTED[:4]:
                assert svc.handle("POST", "/events.json", params, {}, event)[0] == 201
            assert svc.handle("POST", "/batch/events.json", params, {}, ATTRIBUTED[4:])[0] == 200
            text = svc.handle("GET", "/metrics", {}, {}, None)[1]
            lines = sorted(line for line in str(text).splitlines()
                           if line.startswith("pio_experiment_conversions_ingested_total"))
            docs.append((svc.conversion_counts("exp"), svc.conversion_counts("other"), lines,
                         jcli.sweep_conversions(storage, app_id, "exp")
                         if svc.__class__.__module__.startswith("predictionio_tpu.")
                         else pcli.sweep_conversions(storage, app_id, "exp")))
        assert docs[1] == docs[0]
        assert docs[1][0] == {"exp-v0": 3, "exp-v1": 2}
        assert docs[1][3] == {"exp-v0": 3, "exp-v1": 2}
    finally:
        for svc, *_ in services:
            svc.close()


# -- pio experiment's grid ranking ----------------------------------------------

RESULTS = {"engineParamsScores": [
    {"score": 0.30, "engineParams": {"p": 0}}, {"score": None, "engineParams": {"p": 1}},
    {"score": 0.55, "engineParams": {"p": 2}}, {"error": "FAILED", "engineParams": {"p": 3}},
    {"score": 0.10, "engineParams": {"p": 4}}]}


@pytest.mark.parametrize("top_k, ascending", [(1, False), (2, False), (3, True), (0, False),
                                              (9, True)])
def test_ranked_points_equal_jax(top_k, ascending):
    got = []
    for cli, cls in ((jcli, JaxEvaluationInstance), (pcli, EvaluationInstance)):
        instance = cls(id="ev1", status="EVALCOMPLETED", start_time=T0, completion_time=T0,
                       evaluator_results_json=json.dumps(RESULTS))
        got.append(cli._ranked_points(instance, top_k, ascending))
    assert got[1] == got[0]
    assert all(p["score"] is not None for p in got[1])
