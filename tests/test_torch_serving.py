"""The port's serving hot path against the JAX package's, unit by unit
(lanes: tests/test_serving_perf.py, tests/test_query_batching.py):

- the wire codecs (``canonical_json``, ``encode_wire``,
  ``compile_wire_decoder``) byte-equal to JAX's on both templates'
  queries and predictions and on nested, optional and tuple dataclasses,
  camelCase and snake_case spellings alike;
- ``AdaptiveBatchPolicy`` / ``FixedBatchPolicy``: the same
  ``(wait, target)`` sequence as JAX's on the same arrival traces on a
  ``ManualClock`` (hypothesis-generated);
- ``ResultCache``: the same hits, values, evictions, expirations,
  generations and counters as JAX's on the same operation traces on
  virtual time (hypothesis-generated);
- ``QueryBatcher``'s contracts: coalescing, dedup, a poisoned query
  failing alone (and the retry counted), expiry at dequeue, a reload
  applying from the next batch, and close;
- ``ServerConfig``'s ``PIO_SERVING_*`` defaults.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from predictionio_tpu.api.stats import ServingStats as JaxServingStats
from predictionio_tpu.core import json_codec as jcodec
from predictionio_tpu.serving import batch_policy as jpolicy
from predictionio_tpu.serving.result_cache import ResultCache as JaxResultCache
from predictionio_tpu.templates import recommendation as jrec
from predictionio_tpu.templates import sessionrec as jsess
from predictionio_tpu.utils.resilience import ManualClock as JaxManualClock
from predictionio_tpu_torch.api.stats import ServingStats
from predictionio_tpu_torch.core import json_codec as codec
from predictionio_tpu_torch.core.wire import from_wire, to_wire
from predictionio_tpu_torch.ops.topk import BATCH_WIDTHS
from predictionio_tpu_torch.serving import batch_policy as policy
from predictionio_tpu_torch.serving.batcher import QueryBatcher, QueryDeadlineExceeded
from predictionio_tpu_torch.serving.result_cache import ResultCache
from predictionio_tpu_torch.templates import recommendation as prec
from predictionio_tpu_torch.templates import sessionrec as psess
from predictionio_tpu_torch.utils import resilience
from predictionio_tpu_torch.utils.resilience import ManualClock, deadline_scope
from predictionio_tpu_torch.workflow.deploy import ServerConfig


@dataclasses.dataclass(frozen=True)
class _Inner:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class _Query:
    user: str
    num: int = 10
    white_list: tuple | None = None
    items: tuple[_Inner, ...] = ()
    inner: "_Inner | None" = None
    names: "tuple[str, ...] | None" = None


#: (port class, JAX class, body): every key spelled camelCase or snake_case
QUERY_CASES = [
    (psess.Query, jsess.Query, {"user": "u1"}),
    (psess.Query, jsess.Query, {"user": "u1", "num": 3, "blackList": ["a", "b"]}),
    (psess.Query, jsess.Query, {"items": ["i3", "i4"], "num": 4, "black_list": ["i9"]}),
    (psess.Query, jsess.Query, {"num": 2, "items": [], "user": "ü"}),
    (prec.Query, jrec.Query, {"user": "u1", "num": 20}),
    (prec.Query, jrec.Query, {"user": "u1", "whiteList": ["a"], "blackList": []}),
    (prec.Query, jrec.Query, {"user": "u1", "white_list": ["a", "c"], "black_list": ["b"]}),
    (_Query, _Query, {"user": "u", "items": [{"item": "i", "score": 1.5}]}),
    (_Query, _Query, {"user": "u", "inner": {"item": "x", "score": 2}, "names": ["a"]}),
    (_Query, _Query, {"user": "u", "whiteList": None, "names": None}),
]


def _results(mod):
    return [mod.PredictedResult(),
            mod.PredictedResult((mod.ItemScore("i1", 0.5), mod.ItemScore("i2", -1.25)))]


class TestCodecsEqualJax:
    @pytest.mark.parametrize("pcls,jcls,body", QUERY_CASES)
    def test_decode_then_canonical_key(self, pcls, jcls, body):
        got = codec.compile_wire_decoder(pcls)(body)
        want = jcodec.compile_wire_decoder(jcls)(body)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got == from_wire(pcls, body)
        key = codec.canonical_json(codec.encode_wire(got))
        assert key.encode() == jcodec.canonical_json(jcodec.encode_wire(want)).encode()

    @pytest.mark.parametrize("pcls,jcls,body", QUERY_CASES[:7])
    def test_spellings_share_one_key(self, pcls, jcls, body):
        camel = {k: v for k, v in body.items()}
        snake = {k.replace("List", "_list"): v for k, v in body.items()}
        keys = {codec.canonical_json(codec.encode_wire(codec.compile_wire_decoder(pcls)(b)))
                for b in (camel, snake)}
        assert len(keys) == 1

    @pytest.mark.parametrize("template", ["sessionrec", "recommendation"])
    def test_predictions_encode_as_jax(self, template):
        pmod, jmod = {"sessionrec": (psess, jsess), "recommendation": (prec, jrec)}[template]
        for got, want in zip(_results(pmod), _results(jmod)):
            assert codec.compile_wire_encoder(type(got))(got) == to_wire(got)
            assert (codec.canonical_json(codec.encode_wire(got)).encode()
                    == jcodec.canonical_json(jcodec.encode_wire(want)).encode())

    @pytest.mark.parametrize("value", [
        _Query(user="u", items=(_Inner("i", 1.5),), inner=_Inner("j", 0.0)),
        {"k": (_Inner("y", 0.25),), 3: [1, "a", None]},
        [np.float32(1.25), np.int64(7), (1, 2)],
    ])
    def test_encoder_equals_jax_and_to_wire(self, value):
        assert codec.encode_wire(value) == jcodec.encode_wire(value) == to_wire(value)

    @pytest.mark.parametrize("body,match", [
        ({"user": "u", "bogus": 1}, "Unknown field"),
        ([1, 2], "expected JSON object"),
    ])
    def test_rejections_equal_jax(self, body, match):
        with pytest.raises(ValueError, match=match) as got:
            codec.compile_wire_decoder(_Query)(body)
        with pytest.raises(ValueError) as want:
            jcodec.compile_wire_decoder(_Query)(body)
        assert str(got.value) == str(want.value)

    def test_failed_compile_not_cached(self):
        @dataclasses.dataclass(frozen=True)
        class Broken:
            field: "NoSuchTypeAnywhere"  # noqa: F821

        for _ in range(2):
            with pytest.raises(NameError):
                codec.compile_wire_decoder(Broken)

    def test_canonical_json_normalizes_order(self):
        assert codec.canonical_json({"b": 1, "a": [1, 2]}) == '{"a":[1,2],"b":1}'
        assert codec.canonical_json({"é": 1}) == jcodec.canonical_json({"é": 1})


#: one arrival: (seconds since the last one, callers in flight or None)
_ARRIVALS = st.lists(st.tuples(st.floats(0.0, 0.05, allow_nan=False),
                               st.one_of(st.none(), st.integers(0, 80))),
                     min_size=1, max_size=60)


def _policy_pair(kind: str, batch_max: int, wait_ms: float, alpha: float):
    pc, jc = ManualClock(), JaxManualClock()
    if kind == "fixed":
        return (policy.FixedBatchPolicy(batch_max, wait_ms, clock=pc),
                jpolicy.FixedBatchPolicy(batch_max, wait_ms, clock=jc), pc, jc)
    return (policy.AdaptiveBatchPolicy(batch_max, wait_ms, clock=pc, ewma_alpha=alpha),
            jpolicy.AdaptiveBatchPolicy(batch_max, wait_ms, clock=jc, ewma_alpha=alpha),
            pc, jc)


class TestBatchPolicyEqualsJax:
    @settings(max_examples=60, deadline=None)
    @given(kind=st.sampled_from(["adaptive", "fixed"]),
           batch_max=st.sampled_from([1, 3, 8, 64, 100, 256, 1000]),
           wait_ms=st.sampled_from([0.0, 1.0, 5.0, 10.0, 60.0]),
           alpha=st.sampled_from([0.2, 0.5, 1.0]), arrivals=_ARRIVALS)
    def test_same_plans_on_the_same_trace(self, kind, batch_max, wait_ms, alpha, arrivals):
        p, j, pc, jc = _policy_pair(kind, batch_max, wait_ms, alpha)
        assert p.plan() == j.plan()                       # cold start
        for dt, inflight in arrivals:
            pc.advance(dt)
            jc.advance(dt)
            p.observe_arrival()
            j.observe_arrival()
            got, want = p.plan(inflight=inflight), j.plan(inflight=inflight)
            assert got == want
            assert got[1] in BATCH_WIDTHS or got[1] == p.batch_max
        assert p.snapshot() == j.snapshot()
        assert p.ewma_interarrival_s() == j.ewma_interarrival_s()

    def test_menu_snaps_and_factory(self):
        clock = ManualClock()
        p = policy.AdaptiveBatchPolicy(batch_max=64, max_wait_ms=10.0, clock=clock,
                                       ewma_alpha=1.0)
        p.observe_arrival()
        clock.advance(0.001)
        p.observe_arrival()
        assert p.plan(inflight=1) == (0.0, 1)             # a lone caller never waits
        wait, target = p.plan()
        assert target == 16 and 0.0 < wait <= 0.010       # ~11 expected, snapped up
        assert isinstance(policy.make_batch_policy("fixed", 8, 5.0), policy.FixedBatchPolicy)
        with pytest.raises(ValueError, match="batch_policy"):
            policy.make_batch_policy("nope", 8, 5.0)


_KEYS = ['{"user":"u1"}', '{"num":3,"user":"u1"}', '{"user":"u2"}', "plain", '{"user":3}']
_OPS = st.lists(st.one_of(
    st.tuples(st.just("lookup"), st.sampled_from(_KEYS)),
    st.tuples(st.just("put"), st.sampled_from(_KEYS), st.integers(0, 9),
              st.sampled_from(["none", "seen", "stale"])),
    st.tuples(st.just("advance"), st.floats(0.0, 20.0, allow_nan=False)),
    st.tuples(st.just("invalidate"), st.sampled_from([None, 0, 5])),
    st.tuples(st.just("match"), st.sampled_from(['"user":"u1"', '"user":"u2"', "num"])),
), min_size=1, max_size=50)


class TestResultCacheEqualsJax:
    @settings(max_examples=80, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(max_entries=st.integers(1, 4), ttl=st.sampled_from([0.0, 5.0, 30.0]), ops=_OPS)
    def test_same_outcomes_on_the_same_trace(self, max_entries, ttl, ops):
        pc, jc = ManualClock(), JaxManualClock()
        ps, js = ServingStats(), JaxServingStats()
        p = ResultCache(max_entries, ttl, stats=ps, clock=pc)
        j = JaxResultCache(max_entries, ttl, stats=js, clock=jc)
        seen = [0, 0]                              # generations last observed
        for op in ops:
            if op[0] == "lookup":
                got, want = p.lookup(op[1]), j.lookup(op[1])
                assert (got[0], got[2]) == (want[0], want[2])
                if got[0]:
                    assert got[1] == want[1]
                seen = [got[2], want[2]]
            elif op[0] == "put":
                _, key, value, gen = op
                pg, jg = {"none": (None, None), "seen": tuple(seen),
                          "stale": (seen[0] - 1, seen[1] - 1)}[gen]
                assert p.put(key, value, generation=pg) == j.put(key, value, generation=jg)
            elif op[0] == "advance":
                pc.advance(op[1])
                jc.advance(op[1])
            elif op[0] == "invalidate":
                p.invalidate(generation=op[1])
                j.invalidate(generation=op[1])
            else:
                assert p.invalidate_matching(op[1]) == j.invalidate_matching(op[1])
            assert len(p) == len(j) and p.generation == j.generation
        assert p.snapshot() == j.snapshot()
        want = js.snapshot()
        got = ps.snapshot()
        for k in got:
            assert got[k] == want[k], k

    def test_cached_none_is_a_hit_and_stale_put_refused(self):
        c = ResultCache()
        c.put("k", None)
        assert c.lookup("k")[:2] == (True, None)
        _, _, gen = c.lookup("a")
        c.invalidate()                             # a /reload lands mid-flight
        assert c.put("a", 1, generation=gen) is False and len(c) == 0


class _Stub:
    """A DeployedEngine stand-in recording its calls."""

    def __init__(self, tag="m1", poison=None):
        self.tag, self.poison = tag, poison
        self.batch_calls: list[list] = []
        self.single_calls: list = []
        self.served: list[float] = []
        self.lock = threading.Lock()

    def query_batch(self, queries):
        with self.lock:
            self.batch_calls.append(list(queries))
        if self.poison is not None and self.poison in queries:
            raise RuntimeError("poisoned batch")
        return [(self.tag, "batch", q) for q in queries]

    def query(self, q):
        with self.lock:
            self.single_calls.append(q)
        if q == self.poison:
            raise RuntimeError("poisoned query")
        return (self.tag, "single", q)

    def record_served(self, dt):
        with self.lock:
            self.served.append(dt)


def _fire(batcher, queries, keys=None, timeout=10.0):
    """Submit every query at once from its own thread; results in order
    (an exception where the query raised)."""
    out = [None] * len(queries)
    barrier = threading.Barrier(len(queries))

    def go(i):
        barrier.wait()
        try:
            out[i] = batcher.submit(queries[i], timeout=timeout,
                                    key=None if keys is None else keys[i])
        except Exception as e:                # noqa: BLE001
            out[i] = e

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return out


class TestBatcherContracts:
    @pytest.fixture(autouse=True)
    def _fresh_registry(self):
        resilience.reset_registry()
        yield
        resilience.reset_registry()

    def test_concurrent_queries_coalesce(self):
        stub, stats = _Stub(), ServingStats()
        b = QueryBatcher(lambda: stub, policy=policy.FixedBatchPolicy(32, 300.0), stats=stats)
        try:
            out = _fire(b, list(range(12)))
        finally:
            b.close()
        assert out == [("m1", "batch", i) for i in range(12)]
        assert 1 <= len(stub.batch_calls) < 12
        assert stats.count("batched_queries") == 12
        hist = stats.batch_histogram()
        assert sum(n * c for n, c in hist.items()) == 12
        assert sum(hist.values()) == stats.count("dispatches") == len(stub.batch_calls)
        snap = stats.snapshot()
        assert snap["queueWait"]["count"] == 12
        assert snap["deviceDispatch"]["count"] == len(stub.batch_calls)

    def test_identical_queries_dedup_to_one_slot(self):
        stub, stats = _Stub(), ServingStats()
        b = QueryBatcher(lambda: stub, policy=policy.FixedBatchPolicy(8, 300.0), stats=stats)
        keys = ["same"] * 4 + ["a", "b"]
        try:
            out = _fire(b, [{"k": k} for k in keys], keys=keys)
        finally:
            b.close()
        assert out[0] == out[1] == out[2] == out[3] and None not in out
        dispatched = sum(len(c) for c in stub.batch_calls)
        assert stats.count("deduped") >= 1
        assert dispatched + stats.count("deduped") == 6
        # deduplicated waiters count as served requests
        assert len(stub.served) == stats.count("deduped")

    def test_poisoned_query_fails_alone_and_the_retry_is_counted(self):
        stub, stats = _Stub(poison=13), ServingStats()
        b = QueryBatcher(lambda: stub, policy=policy.FixedBatchPolicy(32, 300.0), stats=stats)
        try:
            out = _fire(b, [11, 12, 13, 14])
        finally:
            b.close()
        assert isinstance(out[2], RuntimeError) and "poisoned" in str(out[2])
        # the others are answered: by the retry, or by a batch of their own
        assert [out[0][2], out[1][2], out[3][2]] == [11, 12, 14]
        fallbacks = resilience.registry_snapshot()["serving/query-batcher"]["fallbacks"]
        assert fallbacks == len([c for c in stub.batch_calls if 13 in c]) >= 1

    def test_expired_budget_fails_before_enqueue(self):
        stub, stats = _Stub(), ServingStats()
        b = QueryBatcher(lambda: stub, stats=stats)
        try:
            with deadline_scope(0.0), pytest.raises(QueryDeadlineExceeded):
                b.submit({"q": 1})
        finally:
            b.close()
        assert stub.batch_calls == [] and stats.count("expired") == 1

    def test_expired_at_dequeue_never_dispatches(self):
        stub, stats = _Stub(), ServingStats()
        b = QueryBatcher(lambda: stub, policy=policy.FixedBatchPolicy(4, 400.0), stats=stats)
        try:
            with deadline_scope(0.05), pytest.raises(QueryDeadlineExceeded):
                b.submit({"q": 1}, timeout=5.0)
            time.sleep(0.5)                      # the window closes
        finally:
            b.close()
        assert stub.batch_calls == [] and stats.count("expired") == 1

    def test_a_reload_applies_from_the_next_batch(self):
        current = {"d": _Stub("old")}
        b = QueryBatcher(lambda: current["d"], policy=policy.FixedBatchPolicy(4, 0.0))
        try:
            assert b.submit(1) == ("old", "batch", 1)
            current["d"] = _Stub("new")
            assert b.submit(2) == ("new", "batch", 2)
        finally:
            b.close()

    def test_close_fails_new_and_pending_submits(self):
        stub = _Stub()
        b = QueryBatcher(lambda: stub)
        b.close()
        with pytest.raises(RuntimeError, match="stopped"):
            b.submit(1)
        b._queue.put(None)                       # a drained queue stays drained
        b._fail_pending()


class TestServerConfigEnv:
    def test_env_overrides_apply_as_in_jax(self, monkeypatch):
        from predictionio_tpu.workflow.deploy import ServerConfig as JaxServerConfig

        env = {"BATCHING": "true", "BATCH_POLICY": "FIXED", "BATCH_MAX": "8",
               "BATCH_WAIT_MS": "2.5", "CACHE_ENABLED": "1", "CACHE_MAX_ENTRIES": "99",
               "CACHE_TTL_S": "5.5", "REQUEST_DEADLINE_MS": "250"}
        for k, v in env.items():
            monkeypatch.setenv(f"PIO_SERVING_{k}", v)
        got, want = ServerConfig(), JaxServerConfig()
        for name in ("batching", "batch_policy", "batch_max", "batch_wait_ms",
                     "cache_enabled", "cache_max_entries", "cache_ttl_s",
                     "request_deadline_ms"):
            assert getattr(got, name) == getattr(want, name), name
        assert ServerConfig(batch_max=32).batch_max == 32     # explicit beats env

    @pytest.mark.parametrize("key,raw,field,default", [
        ("BATCH_MAX", "lots", "batch_max", 64),
        ("BATCH_POLICY", "Adaptive-ish", "batch_policy", "adaptive"),
        ("CACHE_TTL_S", "soon", "cache_ttl_s", 30.0),
    ])
    def test_malformed_env_falls_back(self, monkeypatch, key, raw, field, default):
        monkeypatch.setenv(f"PIO_SERVING_{key}", raw)
        assert getattr(ServerConfig(), field) == default

    def test_no_import_time_config_freeze(self):
        import inspect

        from predictionio_tpu_torch.api.engine_server import (
            EngineServer,
            EngineService,
            create_engine_server,
        )
        from predictionio_tpu_torch.workflow.deploy import load_deployed_engine

        for fn in (create_engine_server, load_deployed_engine,
                   EngineService.__init__, EngineServer.__init__):
            assert inspect.signature(fn).parameters["config"].default is None, fn
