"""The port's ``core/columns.py`` and ``core/json_codec.py`` (copies of the
JAX package's) on the CPU: the same events give the same columns, codes,
vocabularies and times in both packages, and each round trip (events →
columns → events, SQL rows → columns → events, events → wire JSON →
events) comes back equal.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu.core import columns as jcols
from predictionio_tpu.core import json_codec as jcodec
from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu_torch.core import columns as pcols
from predictionio_tpu_torch.core import json_codec as pcodec
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event, EventValidationError
from predictionio_tpu_torch.storage import sqlite as psqlite

T0 = datetime(2021, 3, 4, 5, 6, 7, 891234, tzinfo=timezone.utc)


def _specs(n: int = 40, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        target = rng.random() < 0.7
        out.append(dict(
            event=str(rng.choice(["rate", "buy", "view", "$set"])),
            entity_type=str(rng.choice(["user", "doc"])),
            entity_id=f"u{rng.integers(5)}",
            target_entity_type="item" if target else None,
            target_entity_id=f"i{rng.integers(7)}" if target else None,
            properties={"rating": float(rng.integers(1, 6))} if rng.random() < 0.5 else {},
            event_time=T0 + timedelta(microseconds=int(rng.integers(-10**12, 10**12))),
            tags=("t",) if rng.random() < 0.2 else (),
            pr_id="p" if rng.random() < 0.1 else None,
            creation_time=T0 + timedelta(seconds=j),
            event_id=f"e{j}"))
    return out


def _both(specs):
    port = [Event(**{**s, "properties": DataMap(s["properties"])}) for s in specs]
    jax = [JaxEvent(**{**s, "properties": JaxDataMap(s["properties"])}) for s in specs]
    return port, jax


def _columns(c) -> tuple:
    return (c.event_time_us.tolist(),
            [(col.codes.tolist(), col.vocab) for col in
             (c.event, c.entity_type, c.entity_id, c.target_entity_type, c.target_entity_id)],
            c.event_ids)


def _fields(e) -> tuple:
    return (e.event_id, e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, dict(e.properties.fields), e.event_time, tuple(e.tags),
            e.pr_id, e.creation_time)


class TestColumns:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_from_events_equals_jax_and_round_trips(self, seed):
        port, jax = _both(_specs(seed=seed))
        got, want = pcols.EventColumns.from_events(port), jcols.EventColumns.from_events(jax)
        assert _columns(got) == _columns(want)
        assert got.to_events() == port
        assert [got.properties_raw(i) for i in range(len(got))] == \
            [want.properties_raw(i) for i in range(len(want))]

    def test_sql_rows_round_trip_equal_jax(self):
        """Rows as the sqlite backend stores them → columns → events, in
        both packages."""
        port, _ = _both(_specs())
        rows = [psqlite._event_to_row(e.event_id, e) for e in port]
        from predictionio_tpu.storage import sqlite as jsqlite

        got, want = psqlite._rows_to_columns(rows), jsqlite._rows_to_columns(rows)
        assert _columns(got) == _columns(want)
        assert [_fields(e) for e in got.to_events()] == [_fields(e) for e in port]
        assert [_fields(e) for e in got.to_events()] == [_fields(e) for e in want.to_events()]

    @pytest.mark.parametrize("t", [
        datetime(1970, 1, 1, tzinfo=timezone.utc),
        datetime(1969, 12, 31, 23, 59, 59, 999999, tzinfo=timezone.utc),
        T0, datetime(2262, 4, 11, tzinfo=timezone.utc),
    ])
    def test_times_exact(self, t):
        us = pcols.datetime_to_us(t)
        assert us == jcols.datetime_to_us(t) and pcols.us_to_datetime(us) == t

    def test_encode_and_batches(self):
        values = ["b", None, "a", "b", None]
        col = pcols.encode_column(values)
        want = jcols.encode_column(values)
        assert (col.codes.tolist(), col.vocab) == (want.codes.tolist(), want.vocab)
        assert col.decode().tolist() == values and col[2] == "a" and col.code_of("z") is None
        port, _ = _both(_specs(n=10))
        batches = list(pcols.iter_batches(iter(port), 4))
        assert [len(b) for b in batches] == [4, 4, 2]
        assert [e for b in batches for e in b.to_events()] == port
        with pytest.raises(ValueError):
            pcols.iter_batches(iter(port), 0)


class TestJsonCodec:
    def test_wire_json_equals_jax_and_round_trips(self):
        port, jax = _both(_specs())
        for p, j in zip(port, jax):
            doc = pcodec.event_to_json(p)
            assert doc == jcodec.event_to_json(j)
            back = pcodec.event_from_json(doc, validate=False)
            assert back.event_time == p.event_time.replace(
                microsecond=p.event_time.microsecond // 1000 * 1000)
            assert _fields(back)[:7] == _fields(p)[:7]

    @pytest.mark.parametrize("doc", [
        {"entityType": "user", "entityId": "u"},
        {"event": "v", "entityType": "user", "entityId": "u", "properties": []},
        {"event": "v", "entityType": "user", "entityId": "u", "eventTime": "yesterday"},
        {"event": "$set", "entityType": "user", "entityId": "u", "targetEntityType": "item",
         "targetEntityId": "i"},
        {"event": "v", "entityType": "user", "entityId": "u", "tags": [1]},
    ])
    def test_rejects_as_jax(self, doc):
        with pytest.raises(Exception) as want:
            jcodec.event_from_json(doc)
        with pytest.raises(EventValidationError) as got:
            pcodec.event_from_json(doc)
        assert str(got.value) == str(want.value)
