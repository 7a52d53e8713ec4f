"""Schemaless property bags attached to events and entities (a copy of
the JAX package's ``core/datamap.py``, which holds no device code; the
port keeps its own so that it imports nothing of that package).

Behavioral parity with the reference's DataMap / PropertyMap
(reference: data/src/main/scala/.../data/storage/DataMap.scala:45-245,
PropertyMap.scala:36-99): a JSON object with typed getters, merge (``++``)
and key-removal (``--``) operators, and dataclass extraction. PropertyMap
additionally carries first/last updated times — the result of folding
$set/$unset/$delete event streams (the JAX package's core/aggregation.py,
not ported yet).
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from typing import Any, Iterable, Iterator, Mapping, Type, TypeVar

T = TypeVar("T")

# JSON value types a DataMap field may hold.
JsonValue = None | bool | int | float | str | list | dict


class DataMapError(KeyError):
    """Raised when a required field is missing or has the wrong type."""


def _convert(value: Any, target: Type[T], field: str) -> T:
    """Coerce a JSON value to the requested Python type, strictly enough to
    mirror the reference's json4s extraction failures (DataMap.scala:96-112)."""
    if target is Any:
        return value
    if target is float and isinstance(value, int) and not isinstance(value, bool):
        return float(value)  # JSON has one number type; int -> float is lossless intent
    if target is datetime:
        if isinstance(value, datetime):
            return value
        if isinstance(value, str):
            return datetime.fromisoformat(value.replace("Z", "+00:00"))
        raise DataMapError(f"field {field!r} is not a datetime: {value!r}")
    if isinstance(target, type) and isinstance(value, target):
        if target is int and isinstance(value, bool):
            raise DataMapError(f"field {field!r} is bool, expected int")
        return value
    raise DataMapError(
        f"field {field!r} has type {type(value).__name__}, expected {getattr(target, '__name__', target)}"
    )


class DataMap(Mapping[str, JsonValue]):
    """Immutable, schemaless JSON property bag with typed getters.

    Parity: DataMap.scala:45-245. ``get`` on a missing/null field raises
    (the reference throws DataMapException); ``get_opt`` returns None.
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Mapping[str, JsonValue] | None = None):
        # Explicit JSON nulls are KEPT in the field map (key_set/len include
        # them; $unset events carry them as the keys to remove) but the typed
        # getters treat a null field as absent — same as the reference, where
        # json4s JNull stays in the JObject (DataMap.scala:96-129).
        self._fields: dict[str, JsonValue] = dict(fields or {})

    # -- Mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> JsonValue:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    # -- reference API ----------------------------------------------------
    @property
    def fields(self) -> dict[str, JsonValue]:
        return dict(self._fields)

    def require(self, name: str) -> None:
        """Parity: DataMap.require (DataMap.scala:58-63)."""
        if name not in self._fields or self._fields[name] is None:
            raise DataMapError(f"The field {name} is required.")

    def contains(self, name: str) -> bool:
        return name in self._fields and self._fields[name] is not None

    def get(self, name: str, as_type: Type[T] = object) -> T:  # type: ignore[assignment]
        """Typed getter; raises DataMapError if absent or null.

        Parity: DataMap.get[T] (DataMap.scala:96-112).
        """
        self.require(name)
        return _convert(self._fields[name], as_type, name)

    def get_opt(self, name: str, as_type: Type[T] = object) -> T | None:  # type: ignore[assignment]
        """Typed getter returning None when absent or null.

        Parity: DataMap.getOpt[T] (DataMap.scala:119-129).
        """
        if not self.contains(name):
            return None
        return _convert(self._fields[name], as_type, name)

    def get_or_else(self, name: str, default: T) -> T:
        v = self.get_opt(name, type(default))
        return default if v is None else v

    def get_list(self, name: str, element_type: Type[T] = object) -> list[T]:  # type: ignore[assignment]
        raw = self.get(name, list)
        return [_convert(v, element_type, f"{name}[{i}]") for i, v in enumerate(raw)]

    def get_list_opt(self, name: str, element_type: Type[T] = object) -> list[T] | None:  # type: ignore[assignment]
        if not self.contains(name):
            return None
        return self.get_list(name, element_type)

    def extract(self, dataclass_type: Type[T]) -> T:
        """Extract fields into a dataclass; Optional fields may be absent.

        Parity: DataMap.extract[A] via json4s (DataMap.scala:183-194).
        """
        if not dataclasses.is_dataclass(dataclass_type):
            raise TypeError(f"{dataclass_type} is not a dataclass")
        kwargs: dict[str, Any] = {}
        for f in dataclasses.fields(dataclass_type):
            has_default = (
                f.default is not dataclasses.MISSING
                or f.default_factory is not dataclasses.MISSING  # type: ignore[misc]
            )
            if self.contains(f.name):
                target = f.type
                # Resolve "X | None" annotations to X for conversion.
                origin = getattr(target, "__args__", None)
                if origin:
                    non_none = [a for a in origin if a is not type(None)]
                    if len(non_none) == 1:
                        target = non_none[0]
                    else:
                        target = object
                if isinstance(target, str):  # postponed annotation; best-effort
                    target = object
                kwargs[f.name] = _convert(self._fields[f.name], target, f.name)
            elif not has_default:
                raise DataMapError(f"The field {f.name} is required.")
        return dataclass_type(**kwargs)

    # -- operators ---------------------------------------------------------
    def merge(self, other: "DataMap | Mapping[str, JsonValue]") -> "DataMap":
        """Right-biased merge. Parity: DataMap.++ (DataMap.scala:205-210)."""
        merged = dict(self._fields)
        merged.update(other.fields if isinstance(other, DataMap) else dict(other))
        return type(self)._with_fields(self, merged)

    def remove(self, keys: Iterable[str]) -> "DataMap":
        """Remove keys. Parity: DataMap.-- (DataMap.scala:216-221)."""
        drop = set(keys)
        return type(self)._with_fields(
            self, {k: v for k, v in self._fields.items() if k not in drop}
        )

    def __add__(self, other: "DataMap | Mapping[str, JsonValue]") -> "DataMap":
        return self.merge(other)

    def __sub__(self, keys: Iterable[str]) -> "DataMap":
        return self.remove(keys)

    def _with_fields(self, fields: dict[str, JsonValue]) -> "DataMap":
        return DataMap(fields)

    def is_empty(self) -> bool:
        return not self._fields

    @property
    def key_set(self) -> set[str]:
        return set(self._fields)

    def to_json(self) -> dict[str, JsonValue]:
        return dict(self._fields)

    @classmethod
    def from_json(cls, obj: Mapping[str, JsonValue] | None) -> "DataMap":
        return cls(obj or {})

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        return NotImplemented

    def __hash__(self) -> int:
        # Key-only hash: weak but contract-safe — any two maps that compare
        # equal (including int==float values, or PropertyMap vs DataMap with
        # equal fields) hash identically.
        return hash(frozenset(self._fields))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"


class PropertyMap(DataMap):
    """A DataMap produced by aggregating $set/$unset/$delete events, plus the
    first/last times the entity's properties were updated.

    Parity: PropertyMap.scala:36-99.
    """

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Mapping[str, JsonValue] | None,
        first_updated: datetime,
        last_updated: datetime,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def _with_fields(self, fields: dict[str, JsonValue]) -> "PropertyMap":
        return PropertyMap(fields, self.first_updated, self.last_updated)

    def __eq__(self, other: object) -> bool:
        # Same cross-type equality shape as the reference (PropertyMap.equals,
        # PropertyMap.scala:58-66): PropertyMap==PropertyMap compares times
        # too, PropertyMap==DataMap compares fields only. Like the reference
        # this is knowingly non-transitive across the two types.
        if isinstance(other, PropertyMap):
            return (
                self._fields == other._fields
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        if isinstance(other, DataMap):
            return self._fields == other._fields
        return NotImplemented

    # Inherit DataMap's key-only hash so PropertyMap/DataMap pairs that
    # compare equal hash equally (eq/hash contract).
    __hash__ = DataMap.__hash__

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self._fields!r}, first_updated={self.first_updated}, "
            f"last_updated={self.last_updated})"
        )
