"""The port's storage (``predictionio_tpu_torch/storage/``, ``core/aggregation.py``,
``tools/export_import.py``, ``data/store.py``) on the CPU, against the JAX
package's: the columnar/row conformance of tests/test_storage_conformance.py
(``TestColumnarRowEquivalence``: the batches, concatenated, equal ``find()``
exactly) on memory, sqlite ``:memory:``, a sqlite file, and the event-only
binevents (native and pure-Python codecs) and fileevents; one sqlite
file written by either package and read by the other; an export file of
either package imported by the other; ``aggregate_properties`` equal to
JAX's on the cases of tests/test_aggregation.py; and the registry: the
JAX default of sqlite + localfs, and every remote TYPE of the JAX
registry resolving to a client class of the same name (the remote
backends themselves are held in tests/test_torch_remote_storage.py).
"""

from __future__ import annotations

import dataclasses
import io
import itertools
from datetime import datetime, timedelta, timezone

import pytest

from predictionio_tpu.core import aggregation as jagg
from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.storage import base as jbase
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.tools import export_import as jexport
from predictionio_tpu_torch.core import aggregation as pagg
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    EventFilter,
    Model,
    StorageClientConfig,
)
from predictionio_tpu_torch.storage.binevents import BinEventsStorageClient
from predictionio_tpu_torch.storage.fileevents import FileEventsStorageClient
from predictionio_tpu_torch.storage.localfs import LocalFSStorageClient
from predictionio_tpu_torch.storage.memory import MemoryStorageClient
from predictionio_tpu_torch.storage.registry import Storage, StorageError
from predictionio_tpu_torch.storage.sqlite import SQLiteStorageClient
from predictionio_tpu_torch.tools import export_import as pexport

T0 = datetime(2020, 1, 1, tzinfo=timezone.utc)


def _ev(event_cls, datamap_cls, name="rate", entity="u1", minutes=0, target=None,
        props=None, **kw):
    return event_cls(event=name, entity_type=kw.pop("entity_type", "user"), entity_id=entity,
                     target_entity_type="item" if target else None, target_entity_id=target,
                     properties=datamap_cls(props or {}),
                     event_time=kw.pop("event_time", T0 + timedelta(minutes=minutes)), **kw)


def _seed_events(event_cls=Event, datamap_cls=DataMap):
    """tests/test_storage_conformance.py's columnar seed: targets present
    and absent, properties/tags/prId, an equal-time tie, sub-millisecond
    neighbours and two entity types. Fixed ids, so both packages order
    the tie alike."""
    e = lambda *a, **kw: _ev(event_cls, datamap_cls, *a, **kw)  # noqa: E731
    out = [
        e("rate", "u1", 0, target="i1", props={"rating": 4.5}),
        e("buy", "u2", 1, target="i2"),
        e("$set", "u1", 2, props={"a": 1, "nested": {"b": [1, 2]}}),
        e("rate", "u3", 2, target="i3", props={"rating": 1.0}),
        e("view", "u1", 3, target="i9"),
        e("note", "d1", entity_type="doc", props={"len": 7}, tags=("t1", "t2"),
          pr_id="pr-9", event_time=T0 + timedelta(minutes=4)),
        e("view", "u9", event_time=T0 + timedelta(minutes=5, microseconds=200)),
        e("view", "u9", event_time=T0 + timedelta(minutes=5, microseconds=900)),
    ]
    return [dataclasses.replace(x, event_id=f"e{n}") for n, x in enumerate(out)]


FILTERS = [
    EventFilter(),
    EventFilter(event_names=["rate", "buy"]),
    EventFilter(event_names=[]),
    EventFilter(entity_type="user"),
    EventFilter(entity_type="user", entity_id="u1"),
    EventFilter(target_entity_type=None),
    EventFilter(target_entity_type="item"),
    EventFilter(target_entity_id="i2"),
    EventFilter(start_time=T0 + timedelta(minutes=1), until_time=T0 + timedelta(minutes=4)),
    EventFilter(limit=3),
    EventFilter(limit=0),
    EventFilter(entity_type="user", entity_id="u1", reversed=True, limit=2),
    EventFilter(reversed=True),
]


def _jax_filter(f: EventFilter) -> jbase.EventFilter:
    return jbase.EventFilter(**{fl.name: getattr(f, fl.name)
                                for fl in dataclasses.fields(EventFilter)})


def _make_client(kind: str, tmp_path):
    if kind == "memory":
        return MemoryStorageClient()
    if kind == "sqlite":
        return SQLiteStorageClient(StorageClientConfig(test=True))
    if kind == "sqlite_file":
        return SQLiteStorageClient(StorageClientConfig(properties={
            "PATH": str(tmp_path / "pio.sqlite")}))
    if kind.startswith("binevents"):
        return BinEventsStorageClient(StorageClientConfig(properties={
            "PATH": str(tmp_path / "bin"), "NATIVE": str(kind == "binevents").lower()}))
    return FileEventsStorageClient(StorageClientConfig(properties={
        "PATH": str(tmp_path / "jsonl")}))


@pytest.fixture(params=["memory", "sqlite", "sqlite_file"])
def client(request, tmp_path):
    c = _make_client(request.param, tmp_path)
    yield c
    c.close()


#: the event-only stores join the event cases: ``binevents`` through the
#: native scanner, ``binevents_py`` through the pure-Python codec
@pytest.fixture(params=["memory", "sqlite", "sqlite_file", "binevents", "binevents_py",
                        "fileevents"])
def events_client(request, tmp_path):
    c = _make_client(request.param, tmp_path)
    if request.param == "binevents":
        assert c.events().native_active
    yield c
    c.close()


def _key(e) -> tuple:
    """An event's fields as plain values, to compare across packages."""
    return (e.event_id, e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, dict(e.properties.fields), e.event_time, tuple(e.tags),
            e.pr_id)


class TestColumnarRowEquivalence:
    """The port's copy of tests/test_storage_conformance.py's gate."""

    @pytest.mark.parametrize("batch_size", [1, 3, 100])
    def test_native_path_matches_rows(self, events_client, batch_size):
        events = events_client.events()
        events.init(1)
        events.insert_batch(_seed_events(), 1)
        for flt in FILTERS:
            rows = list(events.find(1, None, flt))
            got = []
            for batch in events.find_columnar(1, None, flt, batch_size=batch_size):
                assert 0 < len(batch) <= batch_size
                assert len(batch.event_time_us) == len(batch.event_ids)
                got.extend(batch.to_events())
            assert got == rows, f"filter {flt} diverged"

    def test_generic_fallback_matches_rows(self, events_client):
        events = events_client.events()
        events.insert_batch(_seed_events(), 1)
        for flt in FILTERS:
            got = [e for batch in base.Events.find_columnar(events, 1, None, flt, batch_size=2)
                   for e in batch.to_events()]
            assert got == list(events.find(1, None, flt)), f"fallback filter {flt} diverged"

    def test_empty_table_and_batch_size(self, events_client):
        events = events_client.events()
        events.init(1)
        assert list(events.find_columnar(1)) == []
        assert list(events.find_columnar(7)) == []       # no table at all
        with pytest.raises(ValueError):
            events.find_columnar(1, batch_size=0)

    def test_lazy_columns_match_rows(self, events_client):
        events = events_client.events()
        events.insert_batch(_seed_events(), 1)
        flt = EventFilter(event_names=["rate", "note"])
        rows = list(events.find(1, None, flt))
        (batch,) = list(events.find_columnar(1, None, flt, batch_size=100))
        for i, e in enumerate(rows):
            assert batch.properties(i).fields == e.properties.fields
            assert batch.properties_raw(i) == e.properties.fields
        assert list(batch.entity_id.decode()) == [e.entity_id for e in rows]
        assert batch.target_entity_id.code_of("nope") is None

    def test_find_equals_jax_backend(self, events_client, tmp_path):
        """The same events and filters through the JAX package's backend
        of the same kind give the same sequences."""
        from predictionio_tpu.storage.binevents import BinEventsStorageClient as JB
        from predictionio_tpu.storage.fileevents import FileEventsStorageClient as JF
        from predictionio_tpu.storage.memory import MemoryStorageClient as JM
        from predictionio_tpu.storage.sqlite import SQLiteStorageClient as JS

        jax_path = {"PATH": str(tmp_path / "jax")}
        jax_client = (
            JM() if isinstance(events_client, MemoryStorageClient)
            else JS(jbase.StorageClientConfig(test=True))
            if isinstance(events_client, SQLiteStorageClient)
            else JB(jbase.StorageClientConfig(properties=jax_path))
            if isinstance(events_client, BinEventsStorageClient)
            else JF(jbase.StorageClientConfig(properties=jax_path)))
        events_client.events().insert_batch(_seed_events(), 1)
        jax_client.events().insert_batch(_seed_events(JaxEvent, JaxDataMap), 1)
        for flt in FILTERS:
            assert [_key(e) for e in events_client.events().find(1, None, flt)] == \
                [_key(e) for e in jax_client.events().find(1, None, _jax_filter(flt))]


class TestDAOs:
    def test_events_crud_and_single_entity(self, events_client):
        events = events_client.events()
        eid = events.insert(_ev(Event, DataMap, props={"rating": 4.5, "note": "good"},
                                target="i1"), 1)
        assert events.get(eid, 1).properties.fields == {"rating": 4.5, "note": "good"}
        assert events.delete(eid, 1) is True and events.delete(eid, 1) is False
        events.insert_batch(_seed_events(), 1)
        latest = list(events.find_single_entity(1, "user", "u1", limit=2))
        assert [e.event_id for e in latest] == ["e4", "e2"]
        assert events.remove(1) and list(events.find(1)) == []

    def test_metadata_and_models(self, client):
        apps, keys, channels = client.apps(), client.access_keys(), client.channels()
        app_id = apps.insert(App(0, "A", "desc"))
        assert apps.insert(App(0, "A")) is None and apps.get(app_id).description == "desc"
        assert [a.name for a in apps.get_all()] == ["A"]
        key = keys.insert(AccessKey("", app_id, ("rate",)))
        assert len(key) == 64 and keys.get(key).events == ("rate",)
        assert keys.insert(AccessKey(key, app_id)) is None
        assert [k.key for k in keys.get_by_app_id(app_id)] == [key]
        ch = channels.insert(Channel(0, "web", app_id))
        assert channels.insert(Channel(0, "bad name!", app_id)) is None
        assert channels.get(ch).name == "web"
        instances = client.engine_instances()
        t = datetime(2026, 1, 1, tzinfo=timezone.utc)
        mk = lambda status, minutes: EngineInstance(  # noqa: E731
            "", status, t + timedelta(minutes=minutes), t, "e", "1", "v", "f")
        ids = [instances.insert(mk(s, m)) for s, m in
               (("COMPLETED", 0), ("COMPLETED", 2), ("FAILED", 3))]
        assert instances.get_latest_completed("e", "1", "v").id == ids[1]
        assert instances.get_latest_completed("e", "1", "other") is None
        client.models().insert(Model("m1", b"\x00blob"))
        assert client.models().get("m1").models == b"\x00blob"
        client.models().delete("m1")
        assert client.models().get("m1") is None

    def test_localfs_models(self, tmp_path):
        models = LocalFSStorageClient(StorageClientConfig(properties={
            "PATH": str(tmp_path / "m")})).models()
        models.insert(Model("../x/y", b"abc"))
        assert models.get("../x/y").models == b"abc"
        assert [p.name for p in (tmp_path / "m").iterdir()] == ["__x_y"]
        models.delete("../x/y")
        assert models.get("../x/y") is None


def _fill_sqlite(storage, app_cls, channel_cls, key_cls, events):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "Shared", "one file"))
    ch = storage.get_meta_data_channels().insert(channel_cls(0, "web", app_id))
    storage.get_meta_data_access_keys().insert(key_cls("k" * 64, app_id, ("rate",)))
    storage.get_events().insert_batch(events, app_id)
    storage.get_events().insert_batch(events[:3], app_id, ch)
    return app_id, ch


def _store_env(tmp_path) -> dict:
    return {"PIO_FS_BASEDIR": str(tmp_path)}


class TestCrossPackage:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_one_sqlite_file(self, tmp_path, writer):
        """Apps, channels, access keys, events (find and scan), engine
        and evaluation instances written by one package read back
        equal through the other, from the same PIO_FS_BASEDIR."""
        t = datetime(2026, 1, 1, tzinfo=timezone.utc)
        if writer == "jax":
            w = JaxStorage(_store_env(tmp_path))
            app_id, ch = _fill_sqlite(w, jbase.App, jbase.Channel, jbase.AccessKey,
                                      _seed_events(JaxEvent, JaxDataMap))
            w.get_meta_data_engine_instances().insert(jbase.EngineInstance(
                "ei1", "COMPLETED", t, t, "e", "1", "v", "f", algorithms_params="[]"))
            w.get_meta_data_evaluation_instances().insert(jbase.EvaluationInstance(
                "ev1", "EVALCOMPLETED", t, t, evaluator_results="0.5"))
            r = Storage(_store_env(tmp_path))
        else:
            w = Storage(_store_env(tmp_path))
            app_id, ch = _fill_sqlite(w, App, Channel, AccessKey, _seed_events())
            w.get_meta_data_engine_instances().insert(EngineInstance(
                "ei1", "COMPLETED", t, t, "e", "1", "v", "f", algorithms_params="[]"))
            w.get_meta_data_evaluation_instances().insert(EvaluationInstance(
                "ev1", "EVALCOMPLETED", t, t, evaluator_results="0.5"))
            r = JaxStorage(_store_env(tmp_path))
        w.close()
        assert (tmp_path / "pio.sqlite").exists()
        app = r.get_meta_data_apps().get_by_name("Shared")
        assert (app.id, app.description) == (app_id, "one file")
        assert [c.name for c in r.get_meta_data_channels().get_by_app_id(app_id)] == ["web"]
        assert r.get_meta_data_access_keys().get("k" * 64).events == ("rate",)
        want = [_key(e) for e in _seed_events()]
        assert [_key(e) for e in r.get_events().find(app_id)] == want
        assert [_key(e) for e in r.get_events().find(app_id, ch)] == want[:3]
        scanned = [_key(e) for cols in r.get_events().find_columnar(app_id, batch_size=3)
                   for e in cols.to_events()]
        assert scanned == want
        ei = r.get_meta_data_engine_instances().get("ei1")
        assert (ei.status, ei.start_time, ei.algorithms_params) == ("COMPLETED", t, "[]")
        assert r.get_meta_data_evaluation_instances().get("ev1").evaluator_results == "0.5"
        r.close()

    @pytest.mark.parametrize("exporter", ["jax", "port"])
    def test_export_file_imports_into_the_other(self, exporter):
        jax_client = JaxStorage({"PIO_STORAGE_SOURCES_M_TYPE": "memory",
                                 **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
                                    for r in ("METADATA", "EVENTDATA", "MODELDATA")}})
        port_client = Storage({"PIO_STORAGE_SOURCES_M_TYPE": "memory",
                               **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
                                  for r in ("METADATA", "EVENTDATA", "MODELDATA")}})
        buf = io.StringIO()
        if exporter == "jax":
            jax_client.get_events().insert_batch(_seed_events(JaxEvent, JaxDataMap), 1)
            assert jexport.export_events(jax_client, 1, buf) == 8
            assert pexport.import_events(port_client, 2, io.StringIO(buf.getvalue())) == 8
            src, dst = jax_client.get_events().find(1), port_client.get_events().find(2)
        else:
            port_client.get_events().insert_batch(_seed_events(), 1)
            assert pexport.export_events(port_client, 1, buf) == 8
            assert jexport.import_events(jax_client, 2, io.StringIO(buf.getvalue())) == 8
            src, dst = port_client.get_events().find(1), jax_client.get_events().find(2)
        # the wire format keeps milliseconds: the sub-millisecond pair
        # ties, and equal times order by id
        ms = lambda e: e.event_time.replace(microsecond=e.event_time.microsecond // 1000 * 1000)  # noqa: E731
        assert [(_key(e)[:7], ms(e)) for e in src] == [(_key(e)[:7], e.event_time) for e in dst]

    def test_import_reports_the_bad_line(self):
        storage = Storage({"PIO_STORAGE_SOURCES_M_TYPE": "memory",
                           **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
                              for r in ("METADATA", "EVENTDATA", "MODELDATA")}})
        lines = '{"event": "v", "entityType": "user", "entityId": "u"}\n\nnot json\n'
        with pytest.raises(pexport.ImportFormatError, match="line 3") as err:
            pexport.import_events(storage, 1, io.StringIO(lines))
        assert err.value.imported == 0
        with pytest.raises(jexport.ImportFormatError, match="line 3"):
            jexport.import_events(JaxStorage({"PIO_STORAGE_SOURCES_M_TYPE": "memory", **{
                f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
                for r in ("METADATA", "EVENTDATA", "MODELDATA")}}), 1, io.StringIO(lines))


# tests/test_aggregation.py's cases, as (name, entity, minutes, props)
AGG_CASES = {
    "set_merge_last_wins": [("$set", "u1", 0, {"a": 1, "b": 2}),
                            ("$set", "u1", 10, {"b": 20, "c": 30})],
    "unset_removes_fields": [("$set", "u1", 0, {"a": 1, "b": 2}),
                             ("$unset", "u1", 5, {"a": None})],
    "delete_then_nothing": [("$set", "u1", 0, {"a": 1}), ("$delete", "u1", 5, {})],
    "delete_then_set_again": [("$set", "u1", 0, {"a": 1}), ("$delete", "u1", 5, {}),
                              ("$set", "u1", 10, {"b": 2})],
    "non_special_events_ignored": [("$set", "u1", 0, {"a": 1}), ("view", "u1", 5, {"x": 9}),
                                   ("rate", "u1", 6, {"rating": 3})],
    "group_by_entity": [("$set", "u1", 0, {"a": 1}), ("$set", "u2", 1, {"b": 2}),
                        ("$set", "u3", 2, {"c": 3}), ("$delete", "u3", 3, {}),
                        ("$unset", "u2", 4, {"b": None}), ("$set", "u1", 5, {"a": 7})],
    "unset_without_set": [("$unset", "u1", 0, {"a": None})],
    "out_of_order": [("$set", "u1", 10, {"a": 2}), ("$set", "u1", 0, {"a": 1, "z": 0}),
                     ("$unset", "u1", 5, {"z": None})],
}


def _pm(pm):
    return None if pm is None else (pm.fields, pm.first_updated, pm.last_updated)


class TestAggregation:
    @pytest.mark.parametrize("case", sorted(AGG_CASES))
    def test_equals_jax(self, case):
        spec = AGG_CASES[case]
        port = [_ev(Event, DataMap, n, u, m, props=p) for n, u, m, p in spec]
        jax = [_ev(JaxEvent, JaxDataMap, n, u, m, props=p) for n, u, m, p in spec]
        want = {k: _pm(v) for k, v in jagg.aggregate_properties(jax).items()}
        assert {k: _pm(v) for k, v in pagg.aggregate_properties(port).items()} == want
        # the EventOp monoid, reduced per entity, gives the same maps
        ops: dict = {}
        for e in port:
            op = pagg.EventOp.from_event(e)
            ops[e.entity_id] = ops[e.entity_id] + op if e.entity_id in ops else op
        assert {k: _pm(pm) for k, op in ops.items()
                if (pm := op.to_property_map()) is not None} == want
        u1 = [e for e in port if e.entity_id == "u1"]
        assert _pm(pagg.aggregate_properties_single(u1)) == _pm(
            jagg.aggregate_properties_single([e for e in jax if e.entity_id == "u1"]))
        # the EventOp monoid agrees with the fold under every order
        for perm in itertools.permutations(u1):
            op = pagg.EventOp()
            for e in perm:
                op = op + pagg.EventOp.from_event(e)
            assert _pm(op.to_property_map()) == _pm(pagg.aggregate_properties_single(u1))

    def test_event_store_reads(self):
        storage = Storage({"PIO_STORAGE_SOURCES_M_TYPE": "memory",
                           **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
                              for r in ("METADATA", "EVENTDATA", "MODELDATA")}})
        app_id = storage.get_meta_data_apps().insert(App(0, "A"))
        storage.get_events().insert_batch(
            [_ev(Event, DataMap, n, u, m, props=p) for n, u, m, p in AGG_CASES["group_by_entity"]]
            + _seed_events(), app_id)
        store = EventStore(storage)
        props = store.aggregate_properties("A", "user")
        assert {k: v.fields for k, v in props.items()} == {
            "u1": {"a": 7, "nested": {"b": [1, 2]}}, "u2": {}}
        assert set(store.aggregate_properties("A", "user", required=["a"])) == {"u1"}
        latest = list(store.find_by_entity("A", "user", "u1", limit=2))
        assert [e.event_time.minute for e in latest] == [5, 3]
        assert latest == list(store.find("A", entity_type="user", entity_id="u1",
                                         reversed=True, limit=2))
        scanned = [e for cols in store.scan("A", entity_type="user", batch_size=4)
                   for e in cols.to_events()]
        assert scanned == list(store.find("A", entity_type="user"))


class TestRegistry:
    def test_default_is_sqlite_and_localfs_under_the_base_dir(self, tmp_path):
        storage = Storage(_store_env(tmp_path))
        storage.verify_all_data_objects()
        assert isinstance(storage.get_events(), type(SQLiteStorageClient(
            StorageClientConfig(test=True)).events()))
        storage.get_model_data_models().insert(Model("x", b"1"))
        assert (tmp_path / "pio.sqlite").exists() and (tmp_path / "models" / "x").exists()

    @pytest.mark.parametrize("type_name", [
        "postgres", "pg", "elasticsearch", "elasticsearch1", "s3", "hdfs", "chaos"])
    def test_remote_types_resolve_to_jax_client_classes(self, type_name, tmp_path):
        """Every TYPE the JAX registry registers resolves in the port, to
        a client class of the same name (building one opens no socket)."""
        props = {"postgres": {}, "pg": {}, "elasticsearch": {}, "elasticsearch1": {},
                 "s3": {"BUCKET_NAME": "b"}, "hdfs": {"PATH": str(tmp_path / "hdfs")},
                 "chaos": {"TARGET": "memory"}}[type_name]
        env = {"PIO_STORAGE_SOURCES_X_TYPE": type_name,
               **{f"PIO_STORAGE_SOURCES_X_{k}": v for k, v in props.items()},
               **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "X"
                  for r in ("METADATA", "EVENTDATA", "MODELDATA")}}
        port_client = Storage(env).client_for_source("X")
        jax_client = JaxStorage(env).client_for_source("X")
        assert type(port_client).__name__ == type(jax_client).__name__
        assert type(port_client).__module__ == \
            type(jax_client).__module__.replace("predictionio_tpu.", "predictionio_tpu_torch.")

    def test_jdbc_alias_partial_config_and_source_names(self, tmp_path):
        with pytest.raises(StorageError, match="MODELDATA"):
            Storage({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                     "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
                     "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB"})
        storage = Storage({
            "PIO_STORAGE_SOURCES_PIO_SQLITE_TYPE": "jdbc",
            "PIO_STORAGE_SOURCES_PIO_SQLITE_PATH": str(tmp_path / "j.sqlite"),
            "PIO_STORAGE_SOURCES_PIO_TYPE": "memory",
            **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "PIO_SQLITE"
               for r in ("METADATA", "EVENTDATA", "MODELDATA")}})
        storage.get_events().init(1)
        assert (tmp_path / "j.sqlite").exists()
        with pytest.raises(StorageError, match="not registered"):
            Storage({"PIO_STORAGE_SOURCES_X_TYPE": "nosuch", **{
                f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "X"
                for r in ("METADATA", "EVENTDATA", "MODELDATA")}}).get_events()
