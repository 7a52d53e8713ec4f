"""Public methods of the port's copies that callers outside the package
reach: ``serving/result_cache.ResultCache.get``,
``obs/registry.HistogramFamily.get`` and
``core/columns.EventColumns.event_times``. Each is called in both
packages on the same inputs, and the results must be equal.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu.core import columns as jcolumns
from predictionio_tpu.core import event as jevent
from predictionio_tpu.obs import registry as jregistry
from predictionio_tpu.serving import result_cache as jcache
from predictionio_tpu_torch.core import columns as pcolumns
from predictionio_tpu_torch.core import event as pevent
from predictionio_tpu_torch.obs import registry as pregistry
from predictionio_tpu_torch.serving import result_cache as pcache

PACKAGES = {
    "jax": (jcache, jregistry, jcolumns, jevent),
    "port": (pcache, pregistry, pcolumns, pevent),
}


def _both(fn):
    return {name: fn(*mods) for name, mods in PACKAGES.items()}


# ---------------------------------------------------------------------------
# ResultCache.get
# ---------------------------------------------------------------------------


def _cache_script(cache_mod, *_):
    """The values ``get`` returns over a script of puts, a reload and
    misses; the miss sentinel is recorded as the string "MISS"."""
    cache = cache_mod.ResultCache(max_entries=4, ttl_s=60.0)
    out = []

    def get(key):
        v = cache.get(key)
        out.append("MISS" if v is cache_mod._MISS else v)

    get("q1")                                    # cold miss
    cache.put("q1", {"itemScores": [1, 2]})
    get("q1")                                    # hit
    for i in range(2, 7):                        # evicts q1 (LRU, 4 entries)
        cache.put(f"q{i}", i)
    get("q1")
    get("q6")
    _, _, gen = cache.lookup("q7")
    cache.invalidate()                           # a reload: every entry goes
    get("q6")
    cache.put("q7", "stale", generation=gen)     # computed before the reload
    get("q7")
    return out


def test_result_cache_get_equals_jax():
    got = _both(_cache_script)
    assert got["port"] == got["jax"]
    assert got["port"] == ["MISS", {"itemScores": [1, 2]}, "MISS", 6, "MISS", "MISS"]


@pytest.mark.parametrize("name", ["jax", "port"])
def test_result_cache_get_is_lookup_value(name):
    cache_mod = PACKAGES[name][0]
    cache = cache_mod.ResultCache(max_entries=2, ttl_s=60.0)
    cache.put("k", 3)
    assert cache.get("k") == cache.lookup("k")[1] == 3
    assert cache.get("absent") is cache_mod._MISS


# ---------------------------------------------------------------------------
# HistogramFamily.get
# ---------------------------------------------------------------------------

LABELS = ("/queries.json", "/stats.json", "/")
OBSERVED = [("/queries.json", 0.004), ("/queries.json", 0.2), ("/stats.json", 0.0009),
            ("/nope", 1.5), ("/", 0.00002), ("/other-unknown", 0.03)]


def _family_snapshots(_, registry_mod, *__):
    fam = registry_mod.HistogramFamily("pio_http_request_seconds", "latency", "path", LABELS)
    for value, seconds in OBSERVED:
        fam.observe(value, seconds)
    return {value: tuple(fam.get(value).snapshot())
            for value in (*LABELS, "other", "/never-declared")}


def test_histogram_family_get_equals_jax():
    got = _both(_family_snapshots)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("name", ["jax", "port"])
def test_histogram_family_get_known_and_fallback(name):
    registry_mod = PACKAGES[name][1]
    fam = registry_mod.HistogramFamily("f", "h", "path", LABELS)
    assert fam.get("/queries.json") is fam.get("/queries.json")
    # an undeclared label falls into the fallback histogram
    assert fam.get("/never-declared") is fam.get(fam.FALLBACK)
    assert fam.get("/queries.json") is not fam.get(fam.FALLBACK)


# ---------------------------------------------------------------------------
# EventColumns.event_times
# ---------------------------------------------------------------------------


def _events(event_mod):
    rng = np.random.default_rng(7)
    base = datetime(2024, 3, 1, 12, 0, tzinfo=timezone.utc)
    offsets = np.sort(rng.integers(0, 10**12, size=9))
    return [event_mod.Event(event="view", entity_type="user", entity_id=f"u{i % 3}",
                            target_entity_type="item", target_entity_id=f"i{i}",
                            event_time=base + timedelta(microseconds=int(us)),
                            event_id=f"e{i}")
            for i, us in enumerate(offsets)]


def _event_times(_, __, columns_mod, event_mod):
    return columns_mod.EventColumns.from_events(_events(event_mod)).event_times()


def test_event_times_equals_jax():
    got = _both(_event_times)
    assert got["port"].dtype == got["jax"].dtype == np.int64
    np.testing.assert_array_equal(got["port"], got["jax"])


@pytest.mark.parametrize("name", ["jax", "port"])
def test_event_times_are_epoch_micros(name):
    _, _, columns_mod, event_mod = PACKAGES[name]
    events = _events(event_mod)
    times = columns_mod.EventColumns.from_events(events).event_times()
    want = [columns_mod.datetime_to_us(e.event_time) for e in events]
    assert times.tolist() == want
