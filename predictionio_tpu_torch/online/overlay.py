"""The online delta overlay: what the serving path reads per query (a copy
of the JAX package's ``online/overlay.py``).

A bounded LRU table of fold-in results, installed on the deployed ALS
model (``ALSModel.set_online_overlay``). Two kinds of delta:

- **user deltas**: a recomputed user vector plus the item indices the
  user touched since training (so a just-rated item is excluded at
  once); new users get one too: cold start to served;
- **item deltas**: vectors for items the base model has never seen
  (popularity prior, refined by the symmetric solve once raters exist).
  They stay out of the catalog tables and the IVF index: the serving
  path scores the small delta matrix on the host and merges it into the
  device top-k, so retrieval of unchanged items is unchanged.

**Generation fencing**: every write carries the base-model generation
it was computed against; a write whose generation is not the overlay's
current one is discarded (returns False), and ``/reload`` advances the
overlay's generation (clearing it) before the new model serves.

Bounded on purpose: evictions (counted) drop the least recently folded
user back to their base vector.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import numpy as np


@dataclasses.dataclass(frozen=True)
class UserDelta:
    """One folded user: the recomputed vector + post-training seen
    state (base-catalog indices and overlay item ids)."""

    vector: np.ndarray                    # (K,) float32
    extra_seen: tuple[int, ...] = ()      # base-catalog item indices
    delta_seen: tuple[str, ...] = ()      # overlay item ids touched
    folded_events: int = 0
    event_time_us: int = 0                # newest event folded in


@dataclasses.dataclass(frozen=True)
class ItemDelta:
    """One overlay item: a vector for an id outside the base catalog."""

    vector: np.ndarray                    # (K,) float32


class OnlineOverlay:
    """Thread-safe bounded delta table (module docstring). Readers are
    request-handler threads (one dict get under the lock per query);
    the writer is the fold-in loop."""

    def __init__(self, max_users: int = 4096, max_items: int = 1024,
                 generation: int = 0):
        self.max_users = max(1, int(max_users))
        self.max_items = max(1, int(max_items))
        self._lock = threading.Lock()
        self._users: "OrderedDict[str, UserDelta]" = OrderedDict()
        self._items: "OrderedDict[str, ItemDelta]" = OrderedDict()
        self._generation = int(generation)
        self._evictions = 0
        self._fenced = 0
        #: delta-matrix snapshot cache (rebuilt when items change)
        self._matrix: tuple[tuple[str, ...], np.ndarray] | None = None

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    # -- writes (the fold-in publisher) -----------------------------------
    def put_user(self, user_id: str, delta: UserDelta,
                 generation: int) -> bool:
        """Install/replace one user delta; False (nothing written) when
        ``generation`` is not the overlay's current one — the fencing
        contract (module docstring)."""
        with self._lock:
            if generation != self._generation:
                self._fenced += 1
                return False
            self._users[user_id] = delta
            self._users.move_to_end(user_id)
            while len(self._users) > self.max_users:
                self._users.popitem(last=False)
                self._evictions += 1
            return True

    def put_item(self, item_id: str, delta: ItemDelta,
                 generation: int) -> bool:
        with self._lock:
            if generation != self._generation:
                self._fenced += 1
                return False
            self._items[item_id] = delta
            self._items.move_to_end(item_id)
            while len(self._items) > self.max_items:
                self._items.popitem(last=False)
                self._evictions += 1
            self._matrix = None
            return True

    def advance_generation(self, generation: int) -> None:
        """``/reload`` landed: clear everything and fence out any fold
        still in flight against the old model. Forward-only, like the
        result cache's generations."""
        with self._lock:
            self._users.clear()
            self._items.clear()
            self._matrix = None
            self._generation = max(self._generation + 1, int(generation))

    def load_snapshot(self, users: dict, items: dict, generation: int) -> bool:
        """Replace the whole table from a published pool snapshot (a
        sibling worker's sync): refused (False) when ``generation`` is not
        this overlay's, the sibling half of the fencing."""
        with self._lock:
            if generation != self._generation:
                self._fenced += 1
                return False
            self._users = OrderedDict(users)
            self._items = OrderedDict(items)
            self._matrix = None
            return True

    # -- reads (the serving path) -----------------------------------------
    def user(self, user_id: str) -> UserDelta | None:
        with self._lock:
            return self._users.get(user_id)

    def item(self, item_id: str) -> ItemDelta | None:
        with self._lock:
            return self._items.get(item_id)

    def has_items(self) -> bool:
        with self._lock:
            return bool(self._items)

    def delta_matrix(self) -> tuple[tuple[str, ...], np.ndarray] | None:
        """``(item_ids, (m, K) matrix)`` of every overlay item, cached
        until the item set changes — the per-query read is one lock
        acquisition and (on the hit path) zero allocation."""
        with self._lock:
            if not self._items:
                return None
            if self._matrix is None:
                ids = tuple(self._items)
                self._matrix = (ids, np.stack(
                    [self._items[i].vector for i in ids]).astype(np.float32))
            return self._matrix

    def touched_users(self) -> list[str]:
        with self._lock:
            return list(self._users)

    def snapshot_entries(self) -> tuple[dict, dict]:
        """Shallow copies of both tables (the leader's pool snapshot)."""
        with self._lock:
            return dict(self._users), dict(self._items)

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._users) + len(self._items)

    def counters(self) -> dict:
        with self._lock:
            return {
                "users": len(self._users),
                "items": len(self._items),
                "evictions": self._evictions,
                "fenced": self._fenced,
                "generation": self._generation,
            }
