"""Wire-format JSON codecs: the Event API contract that ``pio
import``/``pio export`` read and write, and the serving fast path of the
engine server (a copy of the JAX package's ``core/json_codec.py``).

Events: field names are camelCase, times are ISO8601 with milliseconds
and zone offset (the reference's json4s serializers), and reads apply
EventValidation.

Serving: :func:`compile_wire_decoder` / :func:`compile_wire_encoder`
hoist the reflection of ``core/wire.from_wire`` / ``to_wire`` (type
hints, field tables, accepted camelCase and snake_case spellings) to one
compile step per class, so a request costs a dict walk; the output is
identical to ``core/wire``'s. :func:`canonical_json` of the bound
query's wire form is the key the result cache and the batcher's dedup
pass share.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from datetime import datetime, timezone
from typing import Any, Callable, Mapping

from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event, EventValidation, EventValidationError
from predictionio_tpu_torch.core.wire import _unwrap_optional, camel_to_snake, snake_to_camel


def format_datetime(t: datetime) -> str:
    """ISO8601 with milliseconds, e.g. ``2004-12-13T21:39:45.618Z``
    (DateTimeJson4sSupport serializes via Utils.dateTimeToString)."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    if t.utcoffset() == timezone.utc.utcoffset(None):
        return t.strftime("%Y-%m-%dT%H:%M:%S.") + f"{t.microsecond // 1000:03d}Z"
    return t.isoformat(timespec="milliseconds")


def parse_datetime(s: str) -> datetime:
    """Accept ISO8601 with 'Z' or explicit offsets; naive times are UTC."""
    t = datetime.fromisoformat(s.replace("Z", "+00:00"))
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    return t


def event_to_json(e: Event) -> dict[str, Any]:
    """Event -> API JSON (EventJson4sSupport.writeToJValue parity)."""
    out: dict[str, Any] = {
        "eventId": e.event_id,
        "event": e.event,
        "entityType": e.entity_type,
        "entityId": e.entity_id,
        "targetEntityType": e.target_entity_type,
        "targetEntityId": e.target_entity_id,
        "properties": e.properties.to_json(),
        "eventTime": format_datetime(e.event_time),
        "tags": list(e.tags),
        "prId": e.pr_id,
        "creationTime": format_datetime(e.creation_time),
    }
    return {k: v for k, v in out.items() if v is not None}


def event_from_json(obj: Mapping[str, Any], validate: bool = True) -> Event:
    """API JSON -> Event (EventJson4sSupport.readFromJValue parity):
    required event/entityType/entityId; eventTime defaults to now;
    validation raises EventValidationError."""
    def _req(name: str) -> str:
        v = obj.get(name)
        if not isinstance(v, str):
            raise EventValidationError(f"field {name} is required and must be a string")
        return v

    def _opt_str(name: str) -> str | None:
        v = obj.get(name)
        if v is None:
            return None
        if not isinstance(v, str):
            raise EventValidationError(f"field {name} must be a string")
        return v

    props = obj.get("properties", {})
    if props is None:
        props = {}
    if not isinstance(props, Mapping):
        raise EventValidationError("field properties must be a JSON object")
    tags = obj.get("tags", [])
    if tags is None:
        tags = []
    if not isinstance(tags, list) or not all(isinstance(t, str) for t in tags):
        raise EventValidationError("field tags must be a list of strings")

    event_time_s = _opt_str("eventTime")
    creation_time_s = _opt_str("creationTime")
    try:
        event_time = parse_datetime(event_time_s) if event_time_s else datetime.now(timezone.utc)
        creation_time = (
            parse_datetime(creation_time_s) if creation_time_s else datetime.now(timezone.utc)
        )
    except ValueError as exc:
        raise EventValidationError(f"invalid time format: {exc}") from exc

    e = Event(
        event=_req("event"),
        entity_type=_req("entityType"),
        entity_id=_req("entityId"),
        target_entity_type=_opt_str("targetEntityType"),
        target_entity_id=_opt_str("targetEntityId"),
        properties=DataMap.from_json(props),
        event_time=event_time,
        tags=tags,
        pr_id=_opt_str("prId"),
        creation_time=creation_time,
        event_id=_opt_str("eventId"),
    )
    if validate:
        EventValidation.validate(e)
    return e


def canonical_json(obj: Any) -> str:
    """The canonical spelling of a JSON value: sorted keys, no
    whitespace. Two requests carrying the same query in different key
    orders give the same string: the result cache's key and the
    batcher's dedup key."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      ensure_ascii=False, default=str)


_DECODERS: dict[Any, Callable[[Any], Any]] = {}


def compile_wire_decoder(cls: Any) -> Callable[[Any], Any]:
    """A JSON → ``cls`` binder with the reflection hoisted out: type
    hints, field tables and accepted key spellings (camelCase and
    snake_case, ``core/wire.from_wire``'s contract, unknown keys
    rejected) are resolved once per class."""
    cls = _unwrap_optional(cls)
    try:
        cached = _DECODERS.get(cls)
        hashable = True
    except TypeError:        # an unhashable annotation: compile fresh
        cached, hashable = None, False
    if cached is not None:
        return cached
    decoder = _build_decoder(cls)
    if hashable:
        _DECODERS[cls] = decoder
    return decoder


def _build_decoder(cls: Any) -> Callable[[Any], Any]:
    if isinstance(cls, type) and dataclasses.is_dataclass(cls):
        return _build_dataclass_decoder(cls)
    if cls is tuple:
        # bare `tuple` annotations coerce JSON lists (frozen Query
        # dataclasses keep tuple fields for hashability)
        return lambda v: tuple(v) if isinstance(v, list) else v
    origin = typing.get_origin(cls)
    if origin in (list, tuple):
        args = typing.get_args(cls)
        elem = args[0] if args and args[0] is not Ellipsis else Any
        if elem is Any:
            if origin is tuple:
                return lambda v: tuple(v) if isinstance(v, list) else v
            return lambda v: v
        sub = compile_wire_decoder(elem)
        if origin is tuple:
            return lambda v: tuple(sub(x) for x in v) if isinstance(v, list) else v
        return lambda v: [sub(x) for x in v] if isinstance(v, list) else v
    return lambda v: v


def _build_dataclass_decoder(cls: type) -> Callable[[Any], Any]:
    # registered before its fields compile, so that a self-referential
    # field finds it; ``accept`` is filled in below
    accept: dict[str, tuple[str, Callable[[Any], Any]]] = {}
    wire_names: list[str] = []

    def decode(obj: Any) -> Any:
        if not isinstance(obj, dict):
            raise ValueError(
                f"expected JSON object for {cls.__name__}, got {type(obj).__name__}")
        kwargs: dict[str, Any] = {}
        unknown = []
        for key, value in obj.items():
            entry = accept.get(key) or accept.get(camel_to_snake(key))
            if entry is None:
                unknown.append(key)
                continue
            name, sub = entry
            kwargs[name] = sub(value)
        if unknown:
            raise ValueError(
                f"Unknown field(s) {sorted(unknown)} for {cls.__name__} "
                f"(accepted: {sorted(wire_names)})")
        return cls(**kwargs)

    _DECODERS[cls] = decode
    try:
        hints = typing.get_type_hints(cls)
        for f in dataclasses.fields(cls):
            sub = compile_wire_decoder(hints.get(f.name, Any))
            accept[f.name] = (f.name, sub)
            # an exact field name wins over a camelCase collision, as
            # in from_wire
            accept.setdefault(snake_to_camel(f.name), (f.name, sub))
            wire_names.append(snake_to_camel(f.name))
    except BaseException:
        # a failed compile must not leave a half-built decoder cached
        _DECODERS.pop(cls, None)
        raise
    return decode


#: per-dataclass (attribute, wire name) tables of the encoder
_ENCODER_FIELDS: dict[type, tuple[tuple[str, str], ...]] = {}

_SCALARS = (str, int, float, bool, type(None))


def encode_wire(obj: Any) -> Any:
    """``core/wire.to_wire`` with per-class field tables compiled once:
    the same output."""
    if isinstance(obj, _SCALARS):
        return obj
    t = type(obj)
    pairs = _ENCODER_FIELDS.get(t)
    if pairs is None and dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        pairs = tuple((f.name, snake_to_camel(f.name)) for f in dataclasses.fields(t))
        _ENCODER_FIELDS[t] = pairs
    if pairs is not None:
        return {wire: encode_wire(getattr(obj, name)) for name, wire in pairs}
    if isinstance(obj, (list, tuple)):
        return [encode_wire(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): encode_wire(v) for k, v in obj.items()}
    if hasattr(obj, "item") and callable(getattr(obj, "item", None)) and hasattr(obj, "dtype"):
        return obj.item()  # numpy scalar or 0-d tensor
    return obj


def compile_wire_encoder(cls: type) -> Callable[[Any], Any]:
    """Fill the encoder's table for ``cls`` ahead of the first request
    and return :func:`encode_wire`."""
    if isinstance(cls, type) and dataclasses.is_dataclass(cls):
        _ENCODER_FIELDS.setdefault(
            cls, tuple((f.name, snake_to_camel(f.name)) for f in dataclasses.fields(cls)))
    return encode_wire
