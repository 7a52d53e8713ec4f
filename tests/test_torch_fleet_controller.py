"""The port's ``fleet/controller.py`` held against the JAX package's.

The same ``ScaleSignals`` sequence on a ``ManualClock`` gives equal
decisions, desired counts, actuations and exported families in both
packages: the single scale controller's decision table, the per-engine
scale set under a shared ``CapacityArbiter`` (budget contention and the
pre-emption case), crash-looped replicas that count as no capacity, and
the per-engine policy precedence.
"""

from __future__ import annotations

import pytest

from predictionio_tpu.fleet import controller as jctl
from predictionio_tpu.fleet import supervisor as jsup
from predictionio_tpu.obs import exporter as jexp
from predictionio_tpu.obs import registry as jreg
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu_torch.fleet import controller as pctl
from predictionio_tpu_torch.fleet import supervisor as psup
from predictionio_tpu_torch.obs import exporter as pexp
from predictionio_tpu_torch.obs import registry as preg
from predictionio_tpu_torch.utils import resilience as pres

JAX = (jctl, jsup, jexp, jreg, jres)
PORT = (pctl, psup, pexp, preg, pres)


class CountingActuator:
    """Counts replicas; a shared ``events`` list records the order of
    actuations across engines (the pre-emption drains before it grows)."""

    def __init__(self, current: int = 0, name: str = "", events: list | None = None):
        self.n = current
        self.name = name
        self.events = events if events is not None else []

    def current(self) -> int:
        return self.n

    def add_replica(self) -> bool:
        self.n += 1
        self.events.append(f"add:{self.name}")
        return True

    def remove_replica(self, reason=None) -> bool:
        if self.n <= 0:
            return False
        self.n -= 1
        self.events.append(f"remove:{self.name}:{reason}")
        return True


def _equal(fn):
    want, got = fn(JAX), fn(PORT)
    assert got == want
    return got


# -- the single controller's decision table ------------------------------------

DEFAULT_POLICY = dict(min_replicas=1, max_replicas=3, pressure_up=0.5, burn_up=14.4,
                      pressure_down=0.1, up_sustain_s=10.0, down_sustain_s=30.0,
                      cooldown_s=20.0, interval_s=1.0, dry_run=False)

#: (policy overrides, starting replicas, [(clock advance, signals kwargs)])
DECISION_TABLE = {
    "pressure_must_sustain": ({}, 2, [(0, dict(pressure=0.9)), (5, dict(pressure=0.3)),
                                      (20, dict(pressure=0.9)), (10, dict(pressure=0.9))]),
    "fast_burn_at_low_pressure": ({}, 1, [(0, dict(pressure=0.05, fast_burn=20.0)),
                                          (10, dict(pressure=0.05, fast_burn=20.0))]),
    "cooldown_blocks": (dict(cooldown_s=25.0), 1, [(0, dict(pressure=0.9))]
                        + [(step, dict(pressure=0.9)) for step in (10, 10, 10, 5)]),
    "scale_down_clamps_at_min": (dict(cooldown_s=0.0), 2,
                                 [(0, dict(pressure=0.02)), (30, dict(pressure=0.02)),
                                  (0.1, dict(pressure=0.02)), (30, dict(pressure=0.02))]),
    "slow_burn_vetoes_down": (dict(cooldown_s=0.0), 2,
                              [(30, dict(pressure=0.02, slow_burn=2.0))] * 5),
    "clamps_at_max": (dict(cooldown_s=0.0), 3, [(0, dict(pressure=0.9)),
                                                (10, dict(pressure=0.9))]),
    "dry_run_never_actuates": (dict(dry_run=True, cooldown_s=0.0), 1,
                               [(0, dict(pressure=0.9)), (10, dict(pressure=0.9)),
                                (10, dict(pressure=0.9)), (10, dict(pressure=0.9))]),
    "no_pressure_reading": ({}, 2, [(0, dict(pressure=None)), (40, dict(pressure=None)),
                                    (40, dict(pressure=None, fast_burn=30.0)),
                                    (10, dict(pressure=None, fast_burn=30.0))]),
    "up_then_down": (dict(cooldown_s=5.0, down_sustain_s=15.0), 1,
                     [(0, dict(pressure=0.9)), (10, dict(pressure=0.9)),
                      (1, dict(pressure=0.0)), (15, dict(pressure=0.0)),
                      (15, dict(pressure=0.0))]),
}


#: the verdicts of each script (the JAX package's decision table)
DECISIONS = {
    "clamps_at_max": ["hold", "hold"],
    "cooldown_blocks": ["hold", "up", "hold", "cooldown_hold", "up"],
    "dry_run_never_actuates": ["hold", "up", "hold", "up"],
    "fast_burn_at_low_pressure": ["hold", "up"],
    "no_pressure_reading": ["hold", "hold", "hold", "up"],
    "pressure_must_sustain": ["hold", "hold", "hold", "up"],
    "scale_down_clamps_at_min": ["hold", "down", "hold", "hold"],
    "slow_burn_vetoes_down": ["hold"] * 5,
    "up_then_down": ["hold", "up", "hold", "down", "hold"],
}


@pytest.mark.parametrize("name", sorted(DECISION_TABLE))
def test_scale_controller_decision_table(name):
    overrides, start, script = DECISION_TABLE[name]

    def run(mods):
        ctl, _, exp, _, res = mods
        clock = res.ManualClock()
        act = CountingActuator(start)
        signals = {}
        controller = ctl.ScaleController(ctl.ScalePolicy(**{**DEFAULT_POLICY, **overrides}),
                                         lambda: signals["v"], act, clock=clock)
        trace = []
        for advance, kw in script:
            clock.advance(advance)
            signals["v"] = ctl.ScaleSignals(**kw)
            trace.append((controller.tick(), act.n, controller.snapshot()["desiredReplicas"]))
        return (trace, act.events, controller.snapshot(),
                exp.render_metrics(ctl.controller_collector(controller)()))

    trace, events, *_ = _equal(run)
    assert [decision for decision, *_ in trace] == DECISIONS[name]
    if name == "dry_run_never_actuates":
        assert events == [] and trace[-1][2] == 2


def test_unreadable_signals_hold_and_count():
    def run(mods):
        ctl, *_, res = mods

        def explode():
            raise ConnectionRefusedError("scrape down")

        act = CountingActuator(2)
        controller = ctl.ScaleController(ctl.ScalePolicy(dry_run=False), explode, act,
                                         clock=res.ManualClock())
        return controller.tick(), controller.snapshot(), act.events

    assert _equal(run)[0] == "error"


def test_scale_policy_env_defaults(monkeypatch):
    monkeypatch.setenv("PIO_FLEET_MIN_REPLICAS", "2")
    monkeypatch.setenv("PIO_FLEET_PRESSURE_UP", "0.7")
    monkeypatch.setenv("PIO_FLEET_COOLDOWN_S", "junk")
    got = _equal(lambda mods: mods[0].ScalePolicy().__dict__)
    assert got["min_replicas"] == 2 and got["pressure_up"] == 0.7


# -- per-engine scale set under one arbiter ------------------------------------

def _fake_service(mods, names, labeled=True):
    ctl, _, _, reg, _ = mods

    class SLO:
        def __init__(self):
            self.burns: dict[str, float] = {}

        def max_burns(self):
            return dict(self.burns)

    class Group:
        def __init__(self):
            self.slo = SLO()

    class Gateway:
        def __init__(self):
            self._groups = {n: Group() for n in names}
            self.labeled = labeled

        def get(self, name):
            return self._groups.get(name)

    class Service:
        def __init__(self):
            self.gateway = Gateway()
            self.pressures: dict = {}

        def fleet_metrics_families(self):
            return [reg.Metric("pio_fleet_pressure", "gauge", "fixture", samples=[
                ({} if n is None else {"engine": n}, v) for n, v in self.pressures.items()])]

    return Service()


def _policy(ctl, **overrides):
    kw = dict(min_replicas=1, max_replicas=4, pressure_up=0.5, burn_up=14.4,
              pressure_down=0.1, up_sustain_s=10.0, down_sustain_s=1000.0,
              cooldown_s=0.0, interval_s=1.0)
    kw.update(overrides)
    return ctl.ScalePolicy(**kw)


#: (budget, {engine: (start, policy overrides)}, [(advance, pressures, burns)])
SCALE_SET_SCRIPTS = {
    "cooldown_is_per_engine": (0, {"a": (1, dict(cooldown_s=100.0)), "b": (1, {})},
                               [(0, {"a": 0.9, "b": 0.2}, {}),
                                (10, {"a": 0.9, "b": 0.9}, {}), (10, {"a": 0.9, "b": 0.9}, {}),
                                (10, {"a": 0.9, "b": 0.9}, {}), (10, {"a": 0.9, "b": 0.9}, {})]),
    "hot_vs_hot_is_a_deny": (2, {"a": (1, dict(up_sustain_s=0.0)),
                                 "b": (1, dict(up_sustain_s=0.0))},
                             [(0, {"a": 0.9, "b": 0.9}, {})]),
    "last_slot_to_the_hotter": (3, {"a": (1, dict(up_sustain_s=0.0)),
                                    "b": (1, dict(up_sustain_s=0.0))},
                                [(0, {"a": 0.6, "b": 0.9}, {})]),
    "preemption_drains_the_idle_first": (3, {"idle": (2, {}),
                                             "hot": (1, dict(up_sustain_s=0.0))},
                                         [(0, {"idle": 0.3, "hot": 0.9}, {})]),
    "victim_never_below_its_min": (2, {"idle": (1, {}), "hot": (1, dict(up_sustain_s=0.0))},
                                   [(0, {"idle": 0.0, "hot": 0.9}, {})]),
    "burn_outranks_pressure": (3, {"burning": (1, dict(up_sustain_s=0.0)),
                                   "queued": (1, dict(up_sustain_s=0.0))},
                               [(0, {"burning": 0.1, "queued": 0.9},
                                 {"burning": {"5m": 20.0, "1h": 20.0}})]),
}


@pytest.mark.parametrize("name", sorted(SCALE_SET_SCRIPTS))
def test_scale_set_script(name):
    budget, engines, script = SCALE_SET_SCRIPTS[name]

    def run(mods):
        ctl, _, exp, _, res = mods
        clock = res.ManualClock()
        service = _fake_service(mods, list(engines))
        scale_set = ctl.EngineScaleSet(service, ctl.CapacityArbiter(budget, clock=clock),
                                       clock=clock)
        events: list[str] = []
        actuators = {}
        for engine, (start, overrides) in engines.items():
            actuators[engine] = CountingActuator(start, engine, events)
            scale_set.add_engine(engine, _policy(ctl, **overrides), actuators[engine])
        trace = []
        for advance, pressures, burns in script:
            clock.advance(advance)
            service.pressures = dict(pressures)
            for engine, windows in burns.items():
                service.gateway.get(engine).slo.burns = dict(windows)
            order = scale_set.tick_all()
            trace.append((order, {e: a.n for e, a in actuators.items()}))
        return (trace, events, scale_set.snapshot(), scale_set.arbiter.snapshot(),
                exp.render_metrics(ctl.scale_set_collector(scale_set)()))

    trace, events, *_ = _equal(run)
    if name == "preemption_drains_the_idle_first":
        assert events == ["remove:idle:preempted_by_hot", "add:hot"]


def test_lone_default_engine_exports_the_single_controller_families():
    def run(mods):
        ctl, _, exp, _, res = mods
        clock = res.ManualClock()
        service = _fake_service(mods, ["default"], labeled=False)
        scale_set = ctl.EngineScaleSet(service, ctl.CapacityArbiter(0, clock=clock),
                                       clock=clock)
        controller = scale_set.add_engine(
            "default", _policy(ctl, up_sustain_s=0.0, dry_run=True), CountingActuator(1))
        service.pressures = {None: 0.9}
        scale_set.tick_all()
        return (exp.render_metrics(ctl.scale_set_collector(scale_set)()),
                exp.render_metrics(ctl.controller_collector(controller)()))

    text, single = _equal(run)
    assert text == single and 'engine="' not in text


def test_arbiter_priority_order():
    def run(mods):
        ctl, *_, res = mods
        arbiter = ctl.CapacityArbiter(budget=10, clock=res.ManualClock(100.0))
        arbiter.register("burning", _policy(ctl), CountingActuator(1))
        arbiter.register("queued", _policy(ctl), CountingActuator(1), last_action=lambda: None)
        arbiter.register("acted", _policy(ctl), CountingActuator(1), last_action=lambda: 95.0)
        arbiter.observe("burning", ctl.ScaleSignals(pressure=0.1, fast_burn=20.0))
        arbiter.observe("queued", ctl.ScaleSignals(pressure=0.9))
        arbiter.observe("acted", ctl.ScaleSignals(pressure=0.9))
        return [arbiter.priority(n) for n in ("burning", "queued", "acted")]

    got = _equal(run)
    assert got[0] > got[1] > got[2]


def test_crash_looped_replica_is_neither_capacity_nor_budget():
    def run(mods):
        ctl, sup, *_ = mods

        class LatchedSupervisor:
            def children(self):
                return [{"id": "replica:8001", "state": "running",
                         "address": "127.0.0.1:8001"},
                        {"id": "replica:8002", "state": sup.CRASH_LOOPED,
                         "address": "127.0.0.1:8002"}]

        actuator = ctl.SupervisedFleetActuator(LatchedSupervisor(), membership=None,
                                               make_spec=lambda i: None)
        actuator.adopt("replica:8001")
        actuator.adopt("replica:8002")
        arbiter = ctl.CapacityArbiter(budget=2)
        arbiter.register("latched", _policy(ctl), actuator)
        arbiter.register("healthy", _policy(ctl), CountingActuator(0))
        wrapped = ctl.ArbitratedActuator("latched", actuator, ctl.CapacityArbiter(budget=0))
        return (actuator.current(), arbiter.used(), arbiter.request_up("healthy"),
                actuator.add_replica(), wrapped.add_replica(), wrapped.last_refusal)

    assert _equal(run) == (1, 1, (True, "within_budget"), False, False, "actuator_refused")


def test_engine_scale_policy_precedence(monkeypatch):
    monkeypatch.setenv("PIO_FLEET_ENGINE_REC_V2_MIN_REPLICAS", "4")
    monkeypatch.setenv("PIO_FLEET_ENGINE_ECOM_MAX_REPLICAS", "lots")

    def run(mods):
        ctl = mods[0]
        return [ctl.engine_scale_policy("rec-v2", base={"min_replicas": 2,
                                                        "max_replicas": 9}).__dict__,
                ctl.engine_scale_policy("rec-v2", base={"min_replicas": 2},
                                        min_replicas=7).__dict__,
                ctl.engine_scale_policy("ecom", base={"max_replicas": 6}).__dict__,
                ctl.engine_scale_policy("ecom", dry_run=True).dry_run]

    got = _equal(run)
    assert (got[0]["min_replicas"], got[0]["max_replicas"], got[1]["min_replicas"],
            got[2]["max_replicas"], got[3]) == (4, 9, 7, 6, True)
