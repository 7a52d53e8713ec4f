"""The port's shared-memory result cache (``serving/shm_cache.py``) on the
CPU, held against the JAX package's: the same put / lookup / invalidate /
per-user invalidation sequences (hypothesis, on a manual clock) give the
same hits, misses, epoch tokens, generations and counters; two handles on
one segment share entries; a SIGKILLed attacher leaves the segment to its
owner; a worker whose model trails the pool's reload publishes nothing.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import signal
import uuid

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from predictionio_tpu.serving import shm_cache as jshm
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu_torch.cli import pio
from predictionio_tpu_torch.serving import shm_cache as pshm
from predictionio_tpu_torch.utils import resilience as pres

PKGS = {"port": (pshm, pres), "jax": (jshm, jres)}

KEYS = [json.dumps({"user": f"u{u}", "num": n}, separators=(",", ":"), sort_keys=True)
        for u in range(4) for n in (3, 5)] + ['{"items":["i1"],"num":2}']
VALUES = st.one_of(st.integers(), st.text(max_size=8),
                   st.lists(st.tuples(st.text(max_size=3), st.floats(allow_nan=False)),
                            max_size=4),
                   st.just("x" * 5000))        # outsizes a slot: never cached

op = st.one_of(
    st.tuples(st.just("put"), st.sampled_from(KEYS), VALUES, st.booleans()),
    st.tuples(st.just("lookup"), st.sampled_from(KEYS), st.none(), st.none()),
    st.tuples(st.just("invalidate"), st.none(), st.none(), st.booleans()),
    st.tuples(st.just("reload"), st.none(), st.integers(1, 4), st.none()),
    st.tuples(st.just("user"), st.sampled_from(["u0", "u1", "u3"]), st.none(), st.none()),
    st.tuples(st.just("tick"), st.none(), st.sampled_from([1.0, 20.0]), st.none()),
    st.tuples(st.just("sibling"), st.sampled_from(KEYS), st.none(), st.none()))


def _run(pkg: str, steps) -> list:
    """One owner and one attached sibling handle on a fresh segment; the
    observable result of every step."""
    shm_mod, res_mod = PKGS[pkg]
    clock = res_mod.ManualClock(100.0)
    name = f"pio-test-{uuid.uuid4().hex[:12]}"
    owner = shm_mod.ShmResultCache(name, nslots=8, slot_bytes=1024, ttl_s=30.0, clock=clock,
                                   create="create")
    sibling = shm_mod.ShmResultCache(name, ttl_s=30.0, clock=clock, create="attach")
    out = []
    token = None
    try:
        for kind, key, arg, flag in steps:
            if kind == "put":
                out.append(owner.put(key, arg, generation=token if flag else None))
            elif kind == "lookup":
                hit, value, token = owner.lookup(key)
                out.append((hit, value if hit else None, token))
            elif kind == "sibling":
                hit, value, _ = sibling.lookup(key)
                out.append(("sibling", hit, value if hit else None))
            elif kind == "invalidate":
                (owner if flag else sibling).invalidate()
            elif kind == "reload":
                owner.invalidate(generation=arg)
                sibling.invalidate(generation=arg)   # the sibling's re-apply: a no-op
            elif kind == "user":
                out.append(sibling.invalidate_matching(
                    json.dumps({"user": key})[1:-1].replace(" ", "")))
            else:
                clock.advance(arg)
            out.append((owner.generation, owner.last_reload, len(owner)))
        out.append(owner.stats.raw_counts())
        out.append({k: v for k, v in owner.snapshot().items() if k != "segment"})
    finally:
        sibling.close()
        owner.close()
    return out


@settings(max_examples=80, deadline=None)
@given(steps=st.lists(op, max_size=24))
def test_sequences_equal_jax(steps):
    got, want = _run("port", steps), _run("jax", steps)
    assert got[:-2] == want[:-2] and got[-1] == want[-1]
    # the counters the cache writes (each package's ServingStats has others too)
    common = got[-2].keys() & want[-2].keys()
    assert {k: got[-2][k] for k in common} == {k: want[-2][k] for k in common}


def test_a_sibling_handle_shares_entries_and_the_fence():
    name = f"pio-test-{uuid.uuid4().hex[:12]}"
    owner = pshm.ShmResultCache(name, nslots=64, create="create")
    sibling = pshm.ShmResultCache(name, create="attach")
    try:
        key = KEYS[0]
        _, _, token = owner.lookup(key)
        assert owner.put(key, {"itemScores": [1, 2]}, generation=token)
        assert sibling.lookup(key)[:2] == (True, {"itemScores": [1, 2]})
        # a sibling whose model trails the pool's reload publishes nothing
        owner.invalidate(generation=1)
        sibling.model_generation_fn = lambda: 0
        _, _, stale = sibling.lookup(KEYS[1])
        assert stale == -1 and not sibling.put(KEYS[1], "old model", generation=stale)
        sibling.model_generation_fn = lambda: 1
        _, _, fresh = sibling.lookup(KEYS[1])
        assert sibling.put(KEYS[1], "new model", generation=fresh)
        assert owner.lookup(KEYS[1])[:2] == (True, "new model")
        assert sibling.snapshot()["backend"] == "shm"
    finally:
        sibling.close()
        owner.close()
    assert not os.path.exists(f"/dev/shm/{name}")


def _attach_and_wait(name: str, ready) -> None:
    cache = pshm.ShmResultCache(name, create="attach")
    assert cache.lookup(KEYS[0])[0]
    ready.set()
    signal.pause()


def test_a_sigkilled_attacher_does_not_unlink_the_segment():
    """A pool worker killed -9 (from the pool's start method) leaves the
    segment to the deploy process that owns it: entries survive, and the
    owner still unlinks it at the end."""
    name = f"pio-test-{uuid.uuid4().hex[:12]}"
    owner = pshm.ShmResultCache(name, create="create")
    try:
        owner.put(KEYS[0], "warm")
        ctx = multiprocessing.get_context(pio.POOL_START_METHOD)
        ready = ctx.Event()
        child = ctx.Process(target=_attach_and_wait, args=(name, ready))
        child.start()
        assert ready.wait(60)
        os.kill(child.pid, signal.SIGKILL)
        child.join(30)
        assert child.exitcode == -signal.SIGKILL
        assert os.path.exists(f"/dev/shm/{name}")
        again = pshm.ShmResultCache(name, create="attach")
        assert again.lookup(KEYS[0])[:2] == (True, "warm")
        again.close()
    finally:
        owner.close()
    assert not os.path.exists(f"/dev/shm/{name}")


def test_open_shm_cache_degrades_to_none(caplog):
    class Config:
        shm_segment = "/not/a/valid/name"
        shm_slots = 8
        shm_slot_bytes = 1024
        cache_ttl_s = 1.0

    assert pshm.open_shm_cache(Config()) is None
    assert any("falling back" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_foreign_segment_is_refused(pkg):
    from multiprocessing import shared_memory

    name = f"pio-test-{uuid.uuid4().hex[:12]}"
    foreign = shared_memory.SharedMemory(name, create=True, size=8192)
    try:
        with pytest.raises(ValueError, match="not a pio shm cache"):
            PKGS[pkg][0].ShmResultCache(name, create="attach")
    finally:
        foreign.close()
        foreign.unlink()


def test_handles_hammering_one_segment_never_serve_a_torn_value():
    """Twelve threads, each with its own handle on one small segment (as
    the workers of a pool attach it), put and look up colliding keys with
    a short switch interval for two seconds: every hit returns the value
    its own key was stored with (a torn or foreign slot reads as a
    miss), and the counters add up."""
    import sys
    import threading
    import time

    name = f"pio-test-{uuid.uuid4().hex[:12]}"
    owner = pshm.ShmResultCache(name, nslots=8, slot_bytes=512, ttl_s=0, create="create")
    handles = [pshm.ShmResultCache(name, ttl_s=0, create="attach") for _ in range(12)]
    keys = [f'{{"user":"u{k}","num":3}}' for k in range(24)]
    wrong, lookups, lock = [], [0], threading.Lock()
    stop = time.monotonic() + 2.0
    interval = sys.getswitchinterval()

    def hammer(i: int, cache) -> None:
        n = 0
        while time.monotonic() < stop:
            key = keys[(i * 7 + n) % len(keys)]
            cache.put(key, {"key": key, "pad": "x" * (n % 200)})
            hit, value, _ = cache.lookup(keys[(i + n) % len(keys)])
            if hit and value["key"] != keys[(i + n) % len(keys)]:
                wrong.append(value)
            n += 1
        with lock:
            lookups[0] += n

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=hammer, args=(i, h)) for i, h in enumerate(handles)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        for h in handles:
            h.close()
    try:
        assert not wrong
        counts = [h.stats.raw_counts() for h in handles]
        assert sum(c["cache_hits"] + c["cache_misses"] for c in counts) == lookups[0] > 0
    finally:
        owner.close()
