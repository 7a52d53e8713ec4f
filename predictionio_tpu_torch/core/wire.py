"""Wire-format JSON ↔ dataclass binding for queries and predictions.

The reference serialized Scala case classes (camelCase fields) with
json4s/Gson on the /queries.json path (CreateServer.scala:470-621,
JsonExtractor.scala:60-100). Our component types are snake_case Python
dataclasses; this codec keeps the HTTP wire format reference-compatible:

- output: dataclasses → JSON objects with camelCase keys, tuples → arrays;
- input: JSON objects bind to dataclass fields accepting camelCase or
  snake_case keys, recursing into nested dataclass / tuple-of-dataclass
  fields.

A copy of the JAX package's ``core/wire.py``: the port imports nothing
of that package.
"""

from __future__ import annotations

import dataclasses
import re
import types
import typing
from typing import Any, Type, TypeVar

T = TypeVar("T")

_CAMEL_RE = re.compile(r"([a-z0-9])([A-Z])")


def camel_to_snake(name: str) -> str:
    return _CAMEL_RE.sub(r"\1_\2", name).lower()


def snake_to_camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(w.capitalize() for w in rest)


def to_wire(obj: Any) -> Any:
    """Dataclass/tuple/list/dict → plain JSON value with camelCase keys."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            snake_to_camel(f.name): to_wire(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): to_wire(v) for k, v in obj.items()}
    if hasattr(obj, "item") and callable(getattr(obj, "item", None)) and hasattr(obj, "dtype"):
        return obj.item()  # numpy scalar or 0-d tensor
    return obj


def _unwrap_optional(tp: Any) -> Any:
    # both typing.Optional[X] and PEP-604 "X | None"
    if typing.get_origin(tp) in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def from_wire(cls: Type[T], obj: Any) -> T:
    """Bind a JSON value to ``cls``. Dataclass fields accept their
    camelCase or snake_case spelling; unknown keys are rejected (the
    json4s strict-extraction behavior the event API also follows)."""
    cls = _unwrap_optional(cls)
    if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)):
        # bare `tuple` annotations (no type params) still coerce JSON
        # lists — frozen Query dataclasses rely on tuple fields for
        # hashability
        if cls is tuple and isinstance(obj, list):
            return tuple(obj)
        origin = typing.get_origin(cls)
        if origin in (list, tuple) and isinstance(obj, list):
            args = typing.get_args(cls)
            elem = args[0] if args and args[0] is not Ellipsis else Any
            vals = [from_wire(elem, v) if elem is not Any else v for v in obj]
            return tuple(vals) if origin is tuple else vals
        return obj
    if not isinstance(obj, dict):
        raise ValueError(f"expected JSON object for {cls.__name__}, got {type(obj).__name__}")

    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    by_wire_name = {snake_to_camel(n): n for n in fields}
    kwargs: dict[str, Any] = {}
    unknown = []
    for key, value in obj.items():
        name = key if key in fields else by_wire_name.get(key) or camel_to_snake(key)
        if name not in fields:
            unknown.append(key)
            continue
        kwargs[name] = from_wire(hints.get(name, Any), value)
    if unknown:
        raise ValueError(
            f"Unknown field(s) {sorted(unknown)} for {cls.__name__} "
            f"(accepted: {sorted(by_wire_name)})"
        )
    return cls(**kwargs)
