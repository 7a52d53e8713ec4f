"""The port's ``utils/resilience.py`` held against the JAX package's.

The same call and failure scripts run through both packages' retry
policy, circuit breaker and ``Resilience`` wrapper on a ``ManualClock``
with a seeded ``random.Random``: states, open counts, ``retry_after``,
attempt counts, backoff sequences, counters and the ``/metrics``
families the breakers feed must be equal.
"""

from __future__ import annotations

import random

import pytest

from predictionio_tpu.obs import registry as jregistry
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu_torch.obs import registry as pregistry
from predictionio_tpu_torch.utils import resilience as pres

BOTH = (jres, pres)


@pytest.fixture(autouse=True)
def _fresh_registries():
    for mod in BOTH:
        mod.reset_registry()
    yield
    for mod in BOTH:
        mod.reset_registry()


def _equal(fn):
    """``fn(module)`` in both packages; returns the port's result after
    holding it equal to JAX's."""
    want, got = fn(jres), fn(pres)
    assert got == want
    return got


# -- retry policy -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    {"base_delay": 0.1, "max_delay": 2.0, "multiplier": 2.0},
    {"base_delay": 1.0, "max_delay": 2.0, "jitter_floor": 0.5},
    {"base_delay": 0.1, "max_delay": 1.0, "jitter": False},
    {"base_delay": 0.02, "max_delay": 5.0, "multiplier": 3.0, "jitter_floor": 2.0},
])
def test_backoff_sequence_from_seeded_rng(kw):
    def run(mod):
        policy, rng = mod.RetryPolicy(**kw), random.Random(7)
        return [policy.backoff(i % 8, rng) for i in range(200)]

    seq = _equal(run)
    cap = kw.get("max_delay", 2.0)
    assert all(0.0 <= d <= cap for d in seq)


@pytest.mark.parametrize("props", [
    {},
    {"RETRY_MAX_ATTEMPTS": "7", "RETRY_BASE_DELAY_MS": "10",
     "RETRY_MAX_DELAY_MS": "500", "RETRY_JITTER": "false",
     "RETRY_DEADLINE_MS": "2500"},
    {"RETRY_MAX_ATTEMPTS": "0"},
    {"RETRY_DEADLINE_MS": "0", "RETRY_JITTER": "TRUE"},
])
def test_retry_policy_from_properties(props):
    _equal(lambda mod: mod.RetryPolicy.from_properties(props).__dict__)


def test_retry_policy_env_fallback(monkeypatch):
    monkeypatch.setenv("PIO_RESILIENCE_RETRY_MAX_ATTEMPTS", "9")
    monkeypatch.setenv("PIO_RESILIENCE_BREAKER_THRESHOLD", "4")
    got = _equal(lambda mod: (
        mod.RetryPolicy.from_properties({}).max_attempts,
        mod.RetryPolicy.from_properties({"RETRY_MAX_ATTEMPTS": "2"}).max_attempts,
        mod.CircuitBreaker.from_properties("x", {}).failure_threshold))
    assert got == (9, 2, 4)


@pytest.mark.parametrize("props", [
    {"BREAKER_THRESHOLD": "0"},
    {"BREAKER_THRESHOLD": "2", "BREAKER_RESET_S": "5"},
    {"BREAKER_THRESHOLD": "3", "BREAKER_SUCCESSES": "0"},
    {},
])
def test_breaker_from_properties(props):
    def run(mod):
        b = mod.CircuitBreaker.from_properties("x", props, clock=mod.ManualClock())
        if b is None:
            return None
        return (b.name, b.failure_threshold, b.reset_timeout, b.success_threshold)

    _equal(run)


# -- circuit breaker ----------------------------------------------------------

#: breaker scripts: ("call",) asks before_call (and records whether it was
#: admitted), ("ok",)/("fail",) record an outcome, ("release",) frees a
#: half-open probe slot, ("advance", s) moves the clock
BREAKER_SCRIPTS = {
    "transition_chain": (dict(failure_threshold=3, reset_timeout=30.0), [
        ("call",), ("fail",), ("call",), ("fail",), ("call",), ("fail",),
        ("call",), ("advance", 29.9), ("call",), ("advance", 0.2),
        ("call",), ("call",), ("ok",), ("call",)]),
    "half_open_failure_reopens": (dict(failure_threshold=1, reset_timeout=10.0), [
        ("call",), ("fail",), ("advance", 10.0), ("call",), ("fail",), ("call",),
        ("advance", 4.0), ("call",)]),
    "streak_broken_by_success": (dict(failure_threshold=2), [
        ("fail",), ("ok",), ("fail",), ("call",), ("fail",), ("call",)]),
    "two_successes_to_close": (dict(failure_threshold=1, reset_timeout=1.0,
                                    success_threshold=2), [
        ("fail",), ("advance", 1.0), ("call",), ("ok",), ("call",), ("ok",),
        ("call",), ("fail",), ("call",)]),
    "released_probe": (dict(failure_threshold=1, reset_timeout=5.0), [
        ("fail",), ("advance", 6.0), ("call",), ("call",), ("release",),
        ("call",), ("ok",), ("call",)]),
}


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_breaker_script(name):
    kw, script = BREAKER_SCRIPTS[name]

    def run(mod):
        clock = mod.ManualClock()
        b = mod.CircuitBreaker("t", clock=clock, **kw)
        trace = []
        for step in script:
            if step[0] == "call":
                try:
                    b.before_call()
                    trace.append(("admitted",))
                except mod.CircuitOpenError as exc:
                    trace.append(("open", round(exc.retry_after, 9)))
            elif step[0] == "ok":
                b.record_success()
            elif step[0] == "fail":
                b.record_failure()
            elif step[0] == "release":
                b.release_probe()
            else:
                clock.advance(step[1])
            trace.append((b.state, b.opens))
        return trace

    trace = _equal(run)
    assert any(state == "open" for state, *_ in trace)


# -- the composed wrapper -----------------------------------------------------

def _script_fn(mod, outcomes):
    """A callable whose n-th call does ``outcomes[n]`` (the last repeats)."""
    state = {"n": 0}
    errors = {"transient": mod.TransientError, "conn": ConnectionError,
              "timeout": TimeoutError, "value": ValueError,
              "interrupt": KeyboardInterrupt}

    def fn():
        state["n"] += 1
        outcome = outcomes[min(state["n"], len(outcomes)) - 1]
        if outcome == "ok":
            return state["n"]
        if outcome == "unavail":
            raise mod.StorageUnavailableError("inner", "down", retry_after=3.0)
        raise errors[outcome](f"boom {state['n']}")

    return fn


#: (policy, breaker, calls): each call is (outcomes, clock advance before it)
RESILIENCE_SCRIPTS = {
    "retries_then_succeeds": (
        dict(max_attempts=4, base_delay=0.01), None,
        [(["transient", "conn", "ok"], 0.0)]),
    "exhaustion_is_unavailable": (
        dict(max_attempts=3, base_delay=0.05), None,
        [(["timeout"], 0.0)]),
    "non_retryable_passes_through": (
        dict(max_attempts=4), None, [(["value"], 0.0)]),
    "breaker_short_circuits": (
        dict(max_attempts=2, base_delay=0.01),
        dict(failure_threshold=2, reset_timeout=5.0),
        [(["transient"], 0.0), (["ok"], 0.0), (["ok"], 5.0), (["ok"], 0.0)]),
    "policy_deadline": (
        dict(max_attempts=10, base_delay=0.4, max_delay=0.4, deadline=1.0), None,
        [(["transient"], 0.0)]),
    "nested_unavailable_is_terminal": (
        dict(max_attempts=5),
        dict(failure_threshold=1, reset_timeout=2.0),
        [(["unavail"], 0.0), (["ok"], 0.0), (["ok"], 2.0)]),
    "half_open_value_error_releases_probe": (
        dict(max_attempts=1),
        dict(failure_threshold=1, reset_timeout=1.0),
        [(["conn"], 0.0), (["value"], 1.0), (["ok"], 0.0)]),
    "half_open_interrupt_releases_probe": (
        dict(max_attempts=1),
        dict(failure_threshold=1, reset_timeout=1.0),
        [(["conn"], 0.0), (["interrupt"], 1.0), (["ok"], 0.0)]),
}


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("name", sorted(RESILIENCE_SCRIPTS))
def test_resilience_script(name, jitter):
    policy_kw, breaker_kw, calls = RESILIENCE_SCRIPTS[name]

    def run(mod):
        clock = mod.ManualClock()
        breaker = (mod.CircuitBreaker("s", clock=clock, **breaker_kw)
                   if breaker_kw else None)
        r = mod.Resilience("s", policy=mod.RetryPolicy(jitter=jitter, **policy_kw),
                           breaker=breaker, clock=clock, rng=random.Random(3))
        trace = []
        for outcomes, advance in calls:
            clock.advance(advance)
            try:
                trace.append(("ok", mod.resilient(r, _script_fn(mod, outcomes))))
            except BaseException as exc:  # noqa: BLE001 — the outcome is the datum
                trace.append((type(exc).__name__,
                              round(getattr(exc, "retry_after", -1.0), 9)))
            trace.append(r.snapshot())
        return trace, clock.slept, mod.registry_snapshot()

    _equal(run)


def test_ambient_deadline_stops_retry_sleeps():
    def run(mod):
        r = mod.Resilience("d", policy=mod.RetryPolicy(max_attempts=5, base_delay=0.5,
                                                       jitter=False),
                           clock=mod.ManualClock(), register=False)
        with mod.deadline_scope(0.2):
            with mod.deadline_scope(5.0):       # nested scopes only shrink it
                left = mod.remaining_deadline()
                with pytest.raises(mod.StorageUnavailableError):
                    r.call(_script_fn(mod, ["transient"]))
        return left <= 0.2, mod.remaining_deadline(), r.snapshot()

    assert _equal(run)[0]


# -- classification, hints, the fallback registry ------------------------------

def test_transient_http_status_table():
    _equal(lambda mod: [mod.is_transient_http_status(c) for c in range(100, 600)])


def test_storage_unavailable_error_classes():
    got = _equal(lambda mod: [c.__name__ for c in mod.STORAGE_UNAVAILABLE_ERRORS]
                 + [c.__name__ for c in mod.TRANSIENT_ERRORS])
    assert "CircuitOpenError" in got


@pytest.mark.parametrize("hint", [None, 0.0, 0.2, 4.5, "x"])
def test_retry_after_hint(hint):
    class E(Exception):
        retry_after = hint

    _equal(lambda mod: (mod.retry_after_hint(E()), mod.retry_after_hint(E(), 2.0)))


def test_record_fallback_and_get_resilience():
    def run(mod):
        for _ in range(3):
            mod.record_fallback("serving/query-batcher")
        r = mod.Resilience("backend", breaker=mod.CircuitBreaker("backend"))
        return (mod.get_resilience("backend") is r, mod.get_resilience("nope"),
                mod.registry_snapshot())

    _equal(run)


# -- the breaker families on /metrics ------------------------------------------

def test_breaker_families_equal_jax():
    """``pio_resilience_breaker_state`` and ``..._breaker_opens_total``
    carry the router's per-replica breakers in both packages."""

    def run(mod):
        reg = jregistry if mod is jres else pregistry
        clock = mod.ManualClock()
        for name, failures in (("router/a:1", 0), ("router/b:2", 2), ("router/c:3", 1)):
            r = mod.Resilience(name, policy=mod.RetryPolicy(max_attempts=1),
                               breaker=mod.CircuitBreaker(name, failure_threshold=2,
                                                          reset_timeout=1.0,
                                                          clock=clock),
                               clock=clock)
            for _ in range(failures):
                with pytest.raises(mod.StorageUnavailableError):
                    r.call(_script_fn(mod, ["conn"]))
        clock.advance(1.0)        # b's breaker reads half-open now
        return [(m.name, m.kind, sorted((tuple(sorted(lb.items())), v)
                                        for lb, v in m.samples))
                for m in reg.resilience_collector()()]

    got = dict((name, samples) for name, _, samples in _equal(run))
    states = dict((labels[0][1], v) for labels, v in got["pio_resilience_breaker_state"])
    assert states == {"router/a:1": 0.0, "router/b:2": 1.0, "router/c:3": 0.0}
    opens = dict((labels[0][1], v)
                 for labels, v in got["pio_resilience_breaker_opens_total"])
    assert opens["router/b:2"] == 1.0
