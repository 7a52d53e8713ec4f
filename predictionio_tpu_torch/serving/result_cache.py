"""Result cache of the serving query path (a copy of the JAX package's
``serving/result_cache.py``).

An LRU + TTL map from the canonical query JSON (``core/json_codec.
canonical_json`` of the bound query's wire form: key order, whitespace
and camelCase/snake_case spellings normalized, so two clients spelling
the same query differently share an entry) to the served prediction.
A hit answers without touching the device; misses flow through the
batcher, whose per-batch dedup pass covers identical queries in flight
at once.

Invalidation is generational: ``invalidate()`` (called by a successful
``/reload`` after the model swap) clears the map AND bumps a generation
counter; ``put()`` carries the generation its caller observed before
computing, so a prediction computed against the old model can never be
cached into the new model's generation — the check and insert are one
atomic step under the cache lock. A failed reload calls nothing: the
last-known-good model keeps its warm cache.

Counters live in ``api/stats.ServingStats``
(hit/miss/eviction/expiration/invalidation) for ``GET /stats.json``.
The clock is injectable for TTL tests on virtual time.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Any

from predictionio_tpu_torch.api.stats import ServingStats
from predictionio_tpu_torch.core.json_codec import canonical_json
from predictionio_tpu_torch.utils.resilience import SYSTEM_CLOCK, Clock

#: sentinel distinguishing "miss" from a cached None prediction
_MISS = object()


def user_fragment_of(key: str) -> str | None:
    """The ``"user":...`` canonical fragment a cache key carries, or
    None for keys without a top-level user. Derived through
    ``canonical_json`` itself, so the index below and an invalidation
    fragment built the same way cannot drift apart."""
    try:
        doc = json.loads(key)
    except ValueError:
        return None
    if not isinstance(doc, dict) or "user" not in doc:
        return None
    return canonical_json({"user": doc["user"]})[1:-1]


class ResultCache:
    """Thread-safe LRU+TTL keyed by canonical query JSON."""

    def __init__(self, max_entries: int = 4096, ttl_s: float = 30.0,
                 stats: ServingStats | None = None,
                 clock: Clock = SYSTEM_CLOCK):
        self.max_entries = max(1, int(max_entries))
        self.ttl_s = ttl_s
        self.stats = stats or ServingStats()
        self._clock = clock
        self._lock = threading.Lock()
        #: key -> (inserted_at, value); insertion/access order = LRU
        self._entries: "OrderedDict[str, tuple[float, Any]]" = OrderedDict()
        self._generation = 0
        #: user fragment -> keys, so that ``invalidate_matching`` of one
        #: user costs that user's entries, not a scan of every key;
        #: ``_key_tag`` is the reverse map the deletion paths use
        self._tag_keys: dict[str, set[str]] = {}
        self._key_tag: dict[str, str] = {}

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def lookup(self, key: str) -> tuple[bool, Any, int]:
        """(hit, value_or_MISS, generation_observed) — callers thread the
        generation into :meth:`put` so a result computed before a reload
        cannot poison the post-reload cache."""
        now = self._clock.monotonic()
        with self._lock:
            gen = self._generation
            entry = self._entries.get(key)
            if entry is None:
                self.stats.bump("cache_misses")
                return False, _MISS, gen
            inserted, value = entry
            if self.ttl_s > 0 and now - inserted >= self.ttl_s:
                del self._entries[key]
                self._forget(key)
                self.stats.bump("cache_expirations")
                self.stats.bump("cache_misses")
                return False, _MISS, gen
            self._entries.move_to_end(key)
            self.stats.bump("cache_hits")
            return True, value, gen

    def put(self, key: str, value: Any, generation: int | None = None) -> bool:
        """Insert; returns False (and caches nothing) when ``generation``
        is stale — the computation started before an invalidation."""
        now = self._clock.monotonic()
        with self._lock:
            if generation is not None and generation != self._generation:
                return False
            self._entries[key] = (now, value)
            self._entries.move_to_end(key)
            if key not in self._key_tag:
                tag = user_fragment_of(key)
                if tag is not None:
                    self._key_tag[key] = tag
                    self._tag_keys.setdefault(tag, set()).add(key)
            while len(self._entries) > self.max_entries:
                evicted, _ = self._entries.popitem(last=False)
                self._forget(evicted)
                self.stats.bump("cache_evictions")
            return True

    def _forget(self, key: str) -> None:
        """Drop ``key`` from the user index (caller already removed the
        entry, under the cache lock)."""
        tag = self._key_tag.pop(key, None)
        if tag is not None:
            keys = self._tag_keys.get(tag)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._tag_keys[tag]

    def invalidate(self, generation: int | None = None) -> None:
        """Atomically drop everything and start a new generation.

        ``generation`` pins the new generation number; it only ever
        moves the counter forward (the stale-``put()`` guard depends on
        generations never repeating)."""
        with self._lock:
            self._entries.clear()
            self._tag_keys.clear()
            self._key_tag.clear()
            if generation is not None:
                self._generation = max(self._generation + 1, generation)
            else:
                self._generation += 1
            self.stats.bump("cache_invalidations")

    def invalidate_matching(self, fragment: str) -> int:
        """Drop only the entries whose canonical key contains
        ``fragment`` (a targeted invalidation: one user's predictions
        die, everyone else's stay warm). The generation still advances,
        so a query of that user already in flight cannot ``put()`` its
        older result back.

        A user fragment (``"user":...``) resolves through the put-time
        user index; any other fragment is a substring scan of every
        key."""
        with self._lock:
            if fragment.startswith('"user":'):
                doomed = list(self._tag_keys.get(fragment, ()))
            else:
                doomed = [k for k in self._entries if fragment in k]
            for k in doomed:
                del self._entries[k]
                self._forget(k)
            # unconditional: a query in flight has no entry to drop yet;
            # its put is what the bump fences
            self._generation += 1
            if doomed:
                self.stats.bump("cache_user_invalidations", len(doomed))
        return len(doomed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> dict:
        with self._lock:
            size, gen = len(self._entries), self._generation
        return {
            "size": size,
            "maxEntries": self.max_entries,
            "ttlS": self.ttl_s,
            "generation": gen,
        }
