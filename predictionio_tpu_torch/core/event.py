"""Canonical event record and validation rules (a copy of the JAX
package's ``core/event.py``, which holds no device code).

Behavioral parity with the reference Event model
(reference: data/src/main/scala/.../data/storage/Event.scala:41-170):
an event has an id, name, entity, optional target entity, a DataMap of
properties, event time, tags, an optional predicted-result id, and a
creation time. Reserved events $set/$unset/$delete mutate entity
properties; names with a ``$``/``pio_`` prefix are otherwise rejected.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timezone
from typing import Sequence

from predictionio_tpu_torch.core.datamap import DataMap


def utcnow() -> datetime:
    return datetime.now(timezone.utc)


@dataclasses.dataclass(frozen=True)
class Event:
    """One event in the Event Store. Parity: Event.scala:41-53."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: str | None = None
    target_entity_id: str | None = None
    properties: DataMap = dataclasses.field(default_factory=DataMap)
    event_time: datetime = dataclasses.field(default_factory=utcnow)
    tags: Sequence[str] = ()
    pr_id: str | None = None
    creation_time: datetime = dataclasses.field(default_factory=utcnow)
    event_id: str | None = None

    def __post_init__(self):
        # Normalize naive datetimes to UTC (reference default zone:
        # EventValidation.defaultTimeZone = UTC, Event.scala:73).
        for name in ("event_time", "creation_time"):
            t = getattr(self, name)
            if t.tzinfo is None:
                object.__setattr__(self, name, t.replace(tzinfo=timezone.utc))
        # Normalize tags to a tuple so Event stays hashable and round-trips
        # identically through every backend.
        if not isinstance(self.tags, tuple):
            object.__setattr__(self, "tags", tuple(self.tags))

    def with_event_id(self, event_id: str) -> "Event":
        return dataclasses.replace(self, event_id=event_id)

    def __str__(self) -> str:
        return (
            f"Event(id={self.event_id},event={self.event},"
            f"eType={self.entity_type},eId={self.entity_id},"
            f"tType={self.target_entity_type},tId={self.target_entity_id},"
            f"p={self.properties},t={self.event_time},tags={list(self.tags)},"
            f"pKey={self.pr_id},ct={self.creation_time})"
        )


class EventValidationError(ValueError):
    """An event violated the validation rules."""


class EventValidation:
    """Validation rules for events. Parity: Event.scala:66-170."""

    #: Reserved single-entity event names (Event.scala:83).
    SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})
    #: Built-in entity types allowed to use the reserved prefix (Event.scala:147).
    BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})
    #: Built-in property names allowed to use the reserved prefix (Event.scala:150).
    BUILTIN_PROPERTIES: frozenset[str] = frozenset()

    @classmethod
    def is_reserved_prefix(cls, name: str) -> bool:
        return name.startswith("$") or name.startswith("pio_")

    @classmethod
    def is_special_event(cls, name: str) -> bool:
        return name in cls.SPECIAL_EVENTS

    @classmethod
    def is_builtin_entity_type(cls, name: str) -> bool:
        return name in cls.BUILTIN_ENTITY_TYPES

    @classmethod
    def validate(cls, e: Event) -> None:
        """Raise EventValidationError on any rule violation.

        Rule list mirrors EventValidation.validate (Event.scala:113-143).
        """
        def require(cond: bool, msg: str) -> None:
            if not cond:
                raise EventValidationError(msg)

        require(bool(e.event), "event must not be empty.")
        require(bool(e.entity_type), "entityType must not be empty string.")
        require(bool(e.entity_id), "entityId must not be empty string.")
        require(
            e.target_entity_type is None or bool(e.target_entity_type),
            "targetEntityType must not be empty string",
        )
        require(
            e.target_entity_id is None or bool(e.target_entity_id),
            "targetEntityId must not be empty string.",
        )
        require(
            (e.target_entity_type is None) == (e.target_entity_id is None),
            "targetEntityType and targetEntityId must be specified together.",
        )
        require(
            not (e.event == "$unset" and e.properties.is_empty()),
            "properties cannot be empty for $unset event",
        )
        require(
            not cls.is_reserved_prefix(e.event) or cls.is_special_event(e.event),
            f"{e.event} is not a supported reserved event name.",
        )
        require(
            not cls.is_special_event(e.event)
            or (e.target_entity_type is None and e.target_entity_id is None),
            f"Reserved event {e.event} cannot have targetEntity",
        )
        require(
            not cls.is_reserved_prefix(e.entity_type)
            or cls.is_builtin_entity_type(e.entity_type),
            f"The entityType {e.entity_type} is not allowed. "
            "'pio_' is a reserved name prefix.",
        )
        require(
            e.target_entity_type is None
            or not cls.is_reserved_prefix(e.target_entity_type)
            or cls.is_builtin_entity_type(e.target_entity_type),
            f"The targetEntityType {e.target_entity_type} is not allowed. "
            "'pio_' is a reserved name prefix.",
        )
        cls.validate_properties(e)

    @classmethod
    def validate_properties(cls, e: Event) -> None:
        """Property names must not use the reserved prefix (Event.scala:158-169)."""
        for k in e.properties.key_set:
            if cls.is_reserved_prefix(k) and k not in cls.BUILTIN_PROPERTIES:
                raise EventValidationError(
                    f"The property {k} is not allowed. "
                    "'pio_' is a reserved name prefix."
                )
