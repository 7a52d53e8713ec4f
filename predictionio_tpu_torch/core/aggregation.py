"""Folding $set/$unset/$delete event streams into per-entity PropertyMaps
(a copy of the JAX package's ``core/aggregation.py``, which holds no
device code).

Two implementations with parity to the reference:

- ``aggregate_properties`` / ``aggregate_properties_single`` — the
  order-based fold used for local reads
  (reference: data/.../storage/LEventAggregator.scala:32-148).
- ``EventOp`` — an **associative monoid** carrying per-field timestamps so
  aggregation can run as a tree reduce over arbitrarily partitioned event
  shards (reference: data/.../storage/PEventAggregator.scala:30-212, where
  it backs Spark ``aggregateByKey``): the merge rule for a reduce over
  shards of a read.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from datetime import datetime
from typing import Iterable, Mapping

from predictionio_tpu_torch.core.datamap import DataMap, JsonValue, PropertyMap
from predictionio_tpu_torch.core.event import Event

#: Event names that control aggregation (LEventAggregator.scala:92).
AGGREGATION_EVENT_NAMES = ("$set", "$unset", "$delete")


# ---------------------------------------------------------------------------
# Order-based local fold (LEventAggregator parity)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Prop:
    dm: dict[str, JsonValue] | None = None
    first_updated: datetime | None = None
    last_updated: datetime | None = None


def _fold_one(p: _Prop, e: Event) -> _Prop:
    """Parity: LEventAggregator.propAggregator (LEventAggregator.scala:117-135)."""
    if e.event not in AGGREGATION_EVENT_NAMES:
        return p
    if e.event == "$set":
        dm = dict(e.properties.fields) if p.dm is None else {**p.dm, **e.properties.fields}
    elif e.event == "$unset":
        dm = None if p.dm is None else {
            k: v for k, v in p.dm.items() if k not in e.properties.key_set
        }
    else:  # $delete
        dm = None
    first = e.event_time if p.first_updated is None else min(p.first_updated, e.event_time)
    last = e.event_time if p.last_updated is None else max(p.last_updated, e.event_time)
    return _Prop(dm=dm, first_updated=first, last_updated=last)


def aggregate_properties_single(events: Iterable[Event]) -> PropertyMap | None:
    """Fold one entity's events (any order; sorted by event time here).

    Parity: LEventAggregator.aggregatePropertiesSingle (:69-89).
    """
    prop = _Prop()
    for e in sorted(events, key=lambda e: e.event_time):
        prop = _fold_one(prop, e)
    if prop.dm is None:
        return None
    assert prop.first_updated is not None and prop.last_updated is not None
    return PropertyMap(prop.dm, prop.first_updated, prop.last_updated)


def aggregate_properties(events: Iterable[Event]) -> dict[str, PropertyMap]:
    """Group by entityId, fold each group. Entities whose fold ends in a
    deleted/never-set state are omitted.

    Parity: LEventAggregator.aggregateProperties (:42-60).
    """
    by_entity: dict[str, list[Event]] = defaultdict(list)
    for e in events:
        by_entity[e.entity_id].append(e)
    out: dict[str, PropertyMap] = {}
    for entity_id, evs in by_entity.items():
        pm = aggregate_properties_single(evs)
        if pm is not None:
            out[entity_id] = pm
    return out


# ---------------------------------------------------------------------------
# Associative monoid (PEventAggregator parity) — safe for tree reduction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _PropTime:
    """A value with the time it was set (PEventAggregator.scala:29-30)."""
    value: JsonValue
    t: datetime


@dataclasses.dataclass(frozen=True)
class EventOp:
    """Partial aggregate of one entity's property events.

    ``EventOp(e1) + EventOp(e2) + ...`` is associative and commutative over
    event order because every field carries its own timestamp — the
    property that let the reference run it under Spark ``aggregateByKey``
    and lets us tree-reduce over shards (PEventAggregator.scala:89-152).
    """

    set_fields: Mapping[str, _PropTime] = dataclasses.field(default_factory=dict)
    set_t: datetime | None = None        # latest $set time (may have empty fields)
    unset_fields: Mapping[str, datetime] = dataclasses.field(default_factory=dict)
    delete_t: datetime | None = None     # latest $delete time
    first_updated: datetime | None = None
    last_updated: datetime | None = None

    @staticmethod
    def from_event(e: Event) -> "EventOp":
        """Parity: EventOp.apply (PEventAggregator.scala:155-189)."""
        t = e.event_time
        if e.event == "$set":
            return EventOp(
                set_fields={k: _PropTime(v, t) for k, v in e.properties.fields.items()},
                set_t=t, first_updated=t, last_updated=t,
            )
        if e.event == "$unset":
            return EventOp(
                unset_fields={k: t for k in e.properties.key_set},
                first_updated=t, last_updated=t,
            )
        if e.event == "$delete":
            return EventOp(delete_t=t, first_updated=t, last_updated=t)
        return EventOp()

    def __add__(self, other: "EventOp") -> "EventOp":
        """Parity: EventOp.++ (PEventAggregator.scala:96-111 and the SetProp/
        UnsetProp/DeleteEntity combiners above it)."""
        set_fields = dict(self.set_fields)
        for k, pt in other.set_fields.items():
            cur = set_fields.get(k)
            set_fields[k] = pt if cur is None or pt.t > cur.t else cur
        unset_fields = dict(self.unset_fields)
        for k, t in other.unset_fields.items():
            cur_t = unset_fields.get(k)
            unset_fields[k] = t if cur_t is None or t > cur_t else cur_t

        def _max(a, b):
            return b if a is None else (a if b is None else max(a, b))

        def _min(a, b):
            return b if a is None else (a if b is None else min(a, b))

        return EventOp(
            set_fields=set_fields,
            set_t=_max(self.set_t, other.set_t),
            unset_fields=unset_fields,
            delete_t=_max(self.delete_t, other.delete_t),
            first_updated=_min(self.first_updated, other.first_updated),
            last_updated=_max(self.last_updated, other.last_updated),
        )

    def to_property_map(self) -> PropertyMap | None:
        """Resolve the partial aggregate. Parity: EventOp.toPropertyMap
        (PEventAggregator.scala:115-152): a field survives if it was $set and
        neither a later-or-equal $unset of that field nor a later-or-equal
        $delete of the whole entity occurred."""
        if self.set_t is None:
            return None
        if self.delete_t is not None and self.delete_t >= self.set_t:
            return None
        fields: dict[str, JsonValue] = {}
        for k, pt in self.set_fields.items():
            unset_t = self.unset_fields.get(k)
            if unset_t is not None and unset_t >= pt.t:
                continue
            if self.delete_t is not None and self.delete_t >= pt.t:
                continue
            fields[k] = pt.value
        assert self.first_updated is not None and self.last_updated is not None
        return PropertyMap(fields, self.first_updated, self.last_updated)


def aggregate_properties_parallel(
    event_shards: Iterable[Iterable[Event]],
) -> dict[str, PropertyMap]:
    """Aggregate per-entity properties from arbitrarily partitioned shards
    via the EventOp monoid — the host-parallel analogue of
    PEventAggregator.aggregateProperties (:198-211)."""
    acc: dict[str, EventOp] = {}
    for shard in event_shards:
        for e in shard:
            op = EventOp.from_event(e)
            cur = acc.get(e.entity_id)
            acc[e.entity_id] = op if cur is None else cur + op
    out: dict[str, PropertyMap] = {}
    for entity_id, op in acc.items():
        pm = op.to_property_map()
        if pm is not None:
            out[entity_id] = pm
    return out


def aggregate_properties_by_type(
    events: Iterable[Event],
) -> dict[str, dict[str, PropertyMap]]:
    """entityType -> entityId -> PropertyMap, for multi-type aggregation."""
    by_type: dict[str, list[Event]] = defaultdict(list)
    for e in events:
        by_type[e.entity_type].append(e)
    return {t: aggregate_properties(evs) for t, evs in by_type.items()}
