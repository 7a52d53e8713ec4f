"""Wire-format JSON codec for events: the Event API contract that
``pio import``/``pio export`` read and write (the event half of the JAX
package's ``core/json_codec.py``, copied; its serving codecs are the
port's ``core/wire.py``).

Field names are camelCase, times are ISO8601 with milliseconds and zone
offset (the reference's json4s serializers), and reads apply
EventValidation.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any, Mapping

from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event, EventValidation, EventValidationError


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
