"""The port's binevents and fileevents event stores beside the JAX
package's, on the CPU (lanes: tests/test_native_eventlog.py and the
binevents/fileevents cases of tests/test_storage_conformance.py).

- One byte format: a log written by any of the four writers (the JAX
  package's native library or pure-Python codec, the port's native
  library or pure-Python codec), puts and deletes included, reads
  through every one of the four readers with equal filtered scans.
- The native scanner is counted (``binevents.NATIVE_SCANS``), and its
  library builds under ``build/native/``, never next to the source.
- A torn tail is repaired by either write path; the JSON-lines files
  of fileevents read across the packages; the registry serves
  ``binevents``, ``hbase`` and ``fileevents``.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timedelta, timezone
from pathlib import Path

import pytest

from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.storage import base as jbase
from predictionio_tpu.storage import binevents as jbin
from predictionio_tpu.storage import fileevents as jfile
from predictionio_tpu_torch import native
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.storage import binevents as pbin
from predictionio_tpu_torch.storage import fileevents as pfile
from predictionio_tpu_torch.storage.base import EventFilter
from predictionio_tpu_torch.storage.registry import Storage

T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
REPO = Path(__file__).resolve().parent.parent


def _events(event_cls, datamap_cls):
    out = []
    for n in range(40):
        out.append(event_cls(
            event=("rate", "buy", "view", "$set")[n % 4], entity_type=("user", "doc")[n % 7 == 0],
            entity_id=f"u{n % 5}", target_entity_type=None if n % 4 == 3 else "item",
            target_entity_id=None if n % 4 == 3 else f"i{n % 6}",
            properties=datamap_cls({"n": n, "s": "é" * (n % 3), "nested": {"l": [n, None]}}),
            event_time=T0 + timedelta(seconds=n // 2, microseconds=(n * 137) % 1000),
            tags=("a", "b") if n % 5 == 0 else (), pr_id="pr" if n % 9 == 0 else None,
            creation_time=T0, event_id=f"e{n:03d}"))
    return out


FILTERS = [
    EventFilter(),
    EventFilter(event_names=["rate", "buy"]),
    EventFilter(event_names=[]),
    EventFilter(entity_type="user"),
    EventFilter(entity_type="user", entity_id="u1"),
    EventFilter(target_entity_type=None),
    EventFilter(target_entity_type="item", target_entity_id="i2"),
    EventFilter(start_time=T0 + timedelta(seconds=3), until_time=T0 + timedelta(seconds=11)),
    EventFilter(limit=7),
    EventFilter(entity_type="user", entity_id="u2", reversed=True, limit=3),
    EventFilter(reversed=True),
]


def _jax_filter(f: EventFilter) -> jbase.EventFilter:
    return jbase.EventFilter(**{fl.name: getattr(f, fl.name)
                                for fl in dataclasses.fields(EventFilter)})


def _key(e) -> tuple:
    return (e.event_id, e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, dict(e.properties.fields), e.event_time, tuple(e.tags),
            e.pr_id, e.creation_time)


#: name -> (make a store at a path, is the JAX package's)
STORES = {
    "jax_native": (lambda p: jbin.BinEvents(p, use_native=True), True),
    "jax_py": (lambda p: jbin.BinEvents(p, use_native=False), True),
    "port_native": (lambda p: pbin.BinEvents(p, use_native=True), False),
    "port_py": (lambda p: pbin.BinEvents(p, use_native=False), False),
}


def _write(name: str, path: str) -> None:
    make, is_jax = STORES[name]
    store = make(path)
    events = _events(JaxEvent, JaxDataMap) if is_jax else _events(Event, DataMap)
    store.init(1)
    store.insert_batch(events[:30], 1)
    for e in events[30:]:
        store.insert(e, 1)
    assert store.delete("e004", 1) and not store.delete("nope", 1)
    store.insert(dataclasses.replace(events[6], entity_id="u-overwritten"), 1)
    store.insert_batch(events[:2], 1, 5)            # a channel's own log
    store.close()


def _scan(name: str, path: str, channel=None) -> list[list[tuple]]:
    make, is_jax = STORES[name]
    store = make(path)
    try:
        return [[_key(e) for e in store.find(1, channel, _jax_filter(f) if is_jax else f)]
                for f in FILTERS]
    finally:
        store.close()


@pytest.mark.parametrize("writer", list(STORES))
def test_every_codec_reads_every_log(tmp_path, writer):
    path = str(tmp_path / "log")
    _write(writer, path)
    want = _scan("jax_py", path)
    assert want[0] and all(k[0] != "e004" for k in want[0])
    assert [k for k in want[0] if k[0] == "e006"][0][3] == "u-overwritten"
    for reader in STORES:
        assert _scan(reader, path) == want, reader
        assert len(_scan(reader, path, channel=5)[0]) == 2


def test_port_writers_produce_jax_bytes(tmp_path):
    for name in STORES:
        _write(name, str(tmp_path / name))
    blobs = {name: (tmp_path / name / "events_1.bin").read_bytes() for name in STORES}
    # the same events through any writer make the same file
    assert len(set(blobs.values())) == 1


def test_get_and_columnar_agree_with_jax(tmp_path):
    path = str(tmp_path / "log")
    _write("jax_native", path)
    for use_native in (True, False):
        store = pbin.BinEvents(path, use_native=use_native)
        jstore = jbin.BinEvents(path, use_native=use_native)
        assert _key(store.get("e010", 1)) == _key(jstore.get("e010", 1))
        assert store.get("e004", 1) is None and store.get("x", 9) is None
        for f in FILTERS:
            got = [_key(e) for b in store.find_columnar(1, None, f, batch_size=4)
                   for e in b.to_events()]
            assert got == [_key(e) for e in store.find(1, None, f)]
        store.close()
        jstore.close()


def test_native_scans_are_counted(tmp_path):
    path = str(tmp_path / "log")
    _write("port_py", path)
    before = pbin.NATIVE_SCANS
    list(pbin.BinEvents(path, use_native=False).find(1))
    assert pbin.NATIVE_SCANS == before
    store = pbin.BinEvents(path, use_native=True)
    assert store.native_active
    list(store.find(1))
    list(store.find(1, None, EventFilter(event_names=[])))   # answered without a scan
    assert pbin.NATIVE_SCANS == before + 1


def test_library_builds_under_build_dir():
    so = native.library_path()
    assert native.load_eventlog() is not None and so.exists()
    assert so.parent == REPO / "build" / "native"
    assert not list((REPO / "predictionio_tpu_torch" / "native").glob("*.so"))


@pytest.mark.parametrize("use_native", [True, False])
def test_torn_tail_repaired_on_write(tmp_path, use_native):
    path = tmp_path / "log"
    _write("jax_py", str(path))
    log = path / "events_1.bin"
    with open(log, "ab") as f:
        f.write(b"\x30\x00\x00\x00\xde\xad")            # half a frame
    store = pbin.BinEvents(str(path), use_native=use_native)
    store.insert(Event(event="late", entity_type="user", entity_id="z", event_time=T0,
                       event_id="late-1"), 1)
    store.close()
    ids = [e.event_id for e in jbin.BinEvents(str(path), use_native=False).find(1)]
    assert "late-1" in ids and len(ids) == 40


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fileevents_logs_read_across_packages(tmp_path, writer):
    w = (jfile.FileEvents if writer == "jax" else pfile.FileEvents)(str(tmp_path))
    events = _events(JaxEvent, JaxDataMap) if writer == "jax" else _events(Event, DataMap)
    w.insert_batch(events[:20], 1)
    w.insert(events[20], 1)
    w.delete("e003", 1)
    port, jax = pfile.FileEvents(str(tmp_path)), jfile.FileEvents(str(tmp_path))
    for f in FILTERS:
        assert [_key(e) for e in port.find(1, None, f)] == \
            [_key(e) for e in jax.find(1, None, _jax_filter(f))]
    assert port.get("e003", 1) is None and port.get("e020", 1).event_id == "e020"


@pytest.mark.parametrize("type_name", ["binevents", "hbase", "fileevents"])
def test_registry_serves_event_stores(tmp_path, type_name):
    storage = Storage({
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.sqlite"),
        "PIO_STORAGE_SOURCES_EV_TYPE": type_name,
        "PIO_STORAGE_SOURCES_EV_PATH": str(tmp_path / "events"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
    })
    events = storage.get_events()
    assert isinstance(events, pfile.FileEvents if type_name == "fileevents"
                      else pbin.BinEvents)
    events.insert(Event(event="v", entity_type="user", entity_id="u", event_id="x"), 1)
    assert [e.event_id for e in events.find(1)] == ["x"]
    with pytest.raises(NotImplementedError):
        storage.client_for_source("EV").apps()     # event data only
    storage.close()
