"""Immutable bidirectional maps and dense id indexing.

Parity with the reference BiMap / EntityIdIxMap
(reference: data/src/main/scala/.../data/storage/BiMap.scala:24-167,
EntityMap.scala:28-99) — the string-id → contiguous-dense-index primitive
every ALS template uses to turn entity ids into embedding-table rows.

Dense contiguous indices are what make embedding tables plain tensor
rows; this is the host-side boundary where ragged external ids become
static tensor coordinates. A copy of the JAX package's module, kept
here so the port imports nothing of that package.
"""

from __future__ import annotations

from typing import Generic, Hashable, Iterable, Iterator, Mapping, TypeVar

import numpy as np

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


class BiMap(Generic[K, V]):
    """Immutable bidirectional map; values must be unique.

    Parity: BiMap.scala:24-110 (apply/get/getOrElse/contains/inverse/take/toMap).
    """

    __slots__ = ("_forward", "_inverse_cache")

    def __init__(self, forward: Mapping[K, V]):
        self._forward: dict[K, V] = dict(forward)
        if len(set(self._forward.values())) != len(self._forward):
            raise ValueError("BiMap values must be unique")
        self._inverse_cache: "BiMap[V, K] | None" = None

    def __getitem__(self, key: K) -> V:
        return self._forward[key]

    def get(self, key: K) -> V | None:
        return self._forward.get(key)

    def get_or_else(self, key: K, default: V) -> V:
        return self._forward.get(key, default)

    def __contains__(self, key: object) -> bool:
        return key in self._forward

    def __len__(self) -> int:
        return len(self._forward)

    def __iter__(self) -> Iterator[K]:
        return iter(self._forward)

    @property
    def inverse(self) -> "BiMap[V, K]":
        """Swapped-direction view (BiMap.scala:45-50); cached like the
        reference's lazy ``inverse``."""
        if self._inverse_cache is None:
            inv = BiMap({v: k for k, v in self._forward.items()})
            inv._inverse_cache = self
            self._inverse_cache = inv
        return self._inverse_cache

    def take(self, n: int) -> "BiMap[K, V]":
        return BiMap(dict(list(self._forward.items())[:n]))

    def to_dict(self) -> dict[K, V]:
        return dict(self._forward)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, BiMap):
            return self._forward == other._forward
        return NotImplemented

    def __hash__(self) -> int:
        return hash(frozenset(self._forward.items()))

    def __repr__(self) -> str:
        return f"BiMap({self._forward!r})"

    # -- constructors (BiMap.scala:112-167) --------------------------------
    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Distinct keys -> contiguous [0, n) indices. Parity:
        BiMap.stringInt (BiMap.scala:125-133)."""
        return BiMap({k: i for i, k in enumerate(dict.fromkeys(keys))})

    # stringLong in the reference exists only because Scala distinguishes
    # Int/Long; Python ints are unbounded so string_long ≡ string_int.
    string_long = string_int


class EntityIdIxMap:
    """entityId <-> dense index with numpy-vectorized batch lookup.

    Parity: EntityIdIxMap (EntityMap.scala:28-58). ``to_index`` maps an
    array of string ids to int32 indices in one vectorized pass — the hot
    path when converting an event log into (user_ix, item_ix, rating)
    triples for the device.
    """

    def __init__(self, id_to_ix: BiMap[str, int]):
        self.id_to_ix = id_to_ix
        self._dict = id_to_ix.to_dict()  # cached once: to_index is a hot path

    @staticmethod
    def from_ids(ids: Iterable[str]) -> "EntityIdIxMap":
        return EntityIdIxMap(BiMap.string_int(ids))

    def __getitem__(self, entity_id: str) -> int:
        return self.id_to_ix[entity_id]

    def get(self, entity_id: str) -> int | None:
        return self.id_to_ix.get(entity_id)

    def __contains__(self, entity_id: str) -> bool:
        return entity_id in self.id_to_ix

    def __len__(self) -> int:
        return len(self.id_to_ix)

    @property
    def inverse(self) -> BiMap[int, str]:
        return self.id_to_ix.inverse

    def to_index(self, entity_ids: Iterable[str], missing: int = -1) -> np.ndarray:
        """Vectorized batch id -> index; unknown ids map to ``missing``."""
        d = self._dict
        return np.fromiter(
            (d.get(e, missing) for e in entity_ids), dtype=np.int32
        )

    def to_ids(self, indices: np.ndarray) -> list[str]:
        inv = self.inverse
        return [inv[int(i)] for i in indices]
