"""binevents backend — binary append-only event log with a native scanner
(a copy of the JAX package's ``storage/binevents.py``, same byte format:
a log written by either package reads through the other).

The high-throughput event store (the reference's HBase role): records
are framed (length + CRC32) with the filterable fixed fields (event
time, names, entity/target ids) stored in binary ahead of the JSON
payload, so the native library (``native/eventlog.cc``) can replay,
compact tombstones, and filter without JSON parsing — Python decodes
only the events that survive the filter, as HBase pushes time-range and
entity filters into region-server scans.

Where the library cannot be built the pure-Python codec below (same
byte format) takes over; ``NATIVE=false`` (the ``binevents_py`` mode of
the tests) asks for it. :data:`NATIVE_SCANS` counts the scans the native
library served in this process, so a caller can tell which path ran.
Writes go one event per library call, and the columnar read replays in
Python, as in the JAX package; batching them is ROADMAP.md queue 1
item 25.

Config: ``PIO_STORAGE_SOURCES_<NAME>_TYPE=binevents`` (alias
``hbase``), ``PIO_STORAGE_SOURCES_<NAME>_PATH=/dir``. Layout: one log
``events_<app>[_<ch>].bin`` per (app, channel), HBase's
table-per-app/channel naming.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import threading
import uuid
import zlib
from datetime import datetime, timezone
from typing import Iterator, Sequence

import numpy as np

from predictionio_tpu_torch import native
from predictionio_tpu_torch.core.columns import EventColumns, check_batch_size, encode_column
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.core.json_codec import event_from_json, event_to_json
from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import EventFilter, StorageClientConfig

#: scans served by the native library in this process
NATIVE_SCANS = 0

_MAGIC = b"PIOEVT1\n"
_ABSENT = 0xFFFF
_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)


def _to_us(t: datetime) -> int:
    """Exact microseconds since epoch (datetime resolution is µs)."""
    delta = t - _EPOCH
    return (delta.days * 86_400 + delta.seconds) * 1_000_000 + delta.microseconds


def _table_name(app_id: int, channel_id: int | None) -> str:
    suffix = f"_{channel_id}" if channel_id is not None else ""
    return f"events_{app_id}{suffix}.bin"


# ---------------------------------------------------------------------------
# Pure-Python codec (same byte format as eventlog.cc)
# ---------------------------------------------------------------------------

def _pack_str16(s: str | None) -> bytes:
    if s is None:
        return struct.pack("<H", _ABSENT)
    b = s.encode("utf-8")[: _ABSENT - 1]
    return struct.pack("<H", len(b)) + b


def _put_body(event: Event) -> bytes:
    payload = json.dumps(event_to_json(event)).encode("utf-8")
    return (
        b"\x00"
        + struct.pack("<q", _to_us(event.event_time))
        + _pack_str16(event.event_id)
        + _pack_str16(event.event)
        + _pack_str16(event.entity_type)
        + _pack_str16(event.entity_id)
        + _pack_str16(event.target_entity_type)
        + _pack_str16(event.target_entity_id)
        + struct.pack("<I", len(payload))
        + payload
    )


def _del_body(event_id: str) -> bytes:
    return b"\x01" + _pack_str16(event_id)


def _frame(body: bytes) -> bytes:
    return struct.pack("<II", len(body), zlib.crc32(body)) + body


def _py_replay(path: str) -> dict[str, tuple]:
    """id -> (t_us, name, etype, eid, tet, tei, json_bytes); last put wins,
    del removes; stops at a torn/corrupt tail like the native scanner."""
    live: dict[str, tuple] = {}
    try:
        data = open(path, "rb").read()
    except OSError:
        return live
    if len(data) < 8 or data[:8] != _MAGIC:
        return live
    off = 8
    while off + 8 <= len(data):
        body_len, crc = struct.unpack_from("<II", data, off)
        off += 8
        if body_len > (1 << 30) or off + body_len > len(data):
            break
        body = data[off : off + body_len]
        off += body_len
        if zlib.crc32(body) != crc:
            break
        op = body[0]
        pos = 1
        if op == 1:
            (idl,) = struct.unpack_from("<H", body, pos)
            pos += 2
            live.pop(body[pos : pos + idl].decode("utf-8"), None)
            continue
        (t_us,) = struct.unpack_from("<q", body, pos)
        pos += 8
        fields: list[str | None] = []
        for _ in range(6):  # id, name, etype, eid, tet, tei
            (n,) = struct.unpack_from("<H", body, pos)
            pos += 2
            if n == _ABSENT:
                fields.append(None)
            else:
                fields.append(body[pos : pos + n].decode("utf-8"))
                pos += n
        (jlen,) = struct.unpack_from("<I", body, pos)
        pos += 4
        payload = body[pos : pos + jlen]
        eid_key, name, etype, eid, tet, tei = fields
        live[eid_key or ""] = (t_us, name, etype, eid, tet, tei, payload)
    return live


def _py_valid_prefix(path: str) -> int:
    """Byte length of the valid record prefix; -1 on foreign header."""
    try:
        data = open(path, "rb").read()
    except OSError:
        return 0
    if len(data) == 0:
        return 0
    if len(data) < 8 or data[:8] != _MAGIC:
        return -1
    good = 8
    off = 8
    while off + 8 <= len(data):
        body_len, crc = struct.unpack_from("<II", data, off)
        if body_len > (1 << 30) or off + 8 + body_len > len(data):
            break
        body = data[off + 8 : off + 8 + body_len]
        if zlib.crc32(body) != crc:
            break
        off += 8 + body_len
        good = off
    return good


def _py_scan_records(path: str, flt: EventFilter) -> list[tuple]:
    """Live records surviving the filter, as the frame's decoded fields:
    ``(id, t_us, name, etype, eid, tet, tei, payload)``."""
    start_us = _to_us(flt.start_time) if flt.start_time is not None else None
    until_us = _to_us(flt.until_time) if flt.until_time is not None else None
    names = set(flt.event_names) if flt.event_names is not None else None
    out = []
    for rid, rec in _py_replay(path).items():
        t_us, name, etype, eid, tet, tei, payload = rec
        if start_us is not None and t_us < start_us:
            continue
        if until_us is not None and t_us >= until_us:
            continue
        if flt.entity_type is not None and etype != flt.entity_type:
            continue
        if flt.entity_id is not None and eid != flt.entity_id:
            continue
        if names is not None and name not in names:
            continue
        if flt.target_entity_type is not ... and tet != flt.target_entity_type:
            continue
        if flt.target_entity_id is not ... and tei != flt.target_entity_id:
            continue
        out.append((rid, *rec))
    return out


def _py_scan(path: str, flt: EventFilter) -> list[bytes]:
    return [rec[-1] for rec in _py_scan_records(path, flt)]


# ---------------------------------------------------------------------------
# Events DAO
# ---------------------------------------------------------------------------

class BinEvents(base.Events):
    #: find()/find_columnar order by the payload's ms-truncated eventTime
    #: (and the id), so the tail cursor compares at ms too
    CURSOR_TIME_RESOLUTION_US = 1000

    def __init__(self, path: str, use_native: bool = True):
        self._path = path
        self._lock = threading.RLock()
        self._lib = native.load_eventlog() if use_native else None
        self._handles: dict[tuple[int, int | None], int] = {}
        #: files already tail-repaired by this instance (Python write path)
        self._repaired: set[str] = set()
        os.makedirs(path, exist_ok=True)

    @property
    def native_active(self) -> bool:
        return self._lib is not None

    def _file(self, app_id: int, channel_id: int | None) -> str:
        return os.path.join(self._path, _table_name(app_id, channel_id))

    # -- write path ---------------------------------------------------------
    def _py_append(self, path: str, body: bytes) -> None:
        # First write per file: truncate any torn/corrupt tail (same crash
        # repair pio_open does) so new records stay readable.
        if path not in self._repaired:
            good = _py_valid_prefix(path)
            if good < 0:
                raise OSError(f"not an event log: {path}")
            if os.path.exists(path) and os.path.getsize(path) > good > 0:
                with open(path, "r+b") as f:
                    f.truncate(good)
            self._repaired.add(path)
        new = not os.path.exists(path) or os.path.getsize(path) == 0
        with open(path, "ab") as f:
            if new:
                f.write(_MAGIC)
            f.write(_frame(body))

    def _handle(self, app_id: int, channel_id: int | None):
        key = (app_id, channel_id)
        h = self._handles.get(key)
        if h is None:
            h = self._lib.pio_open(self._file(app_id, channel_id).encode())
            if not h:
                raise OSError(f"pio_open failed: {self._file(app_id, channel_id)}")
            self._handles[key] = h
        return h

    def _write_put(self, event: Event, app_id: int, channel_id: int | None) -> None:
        if self._lib is None:
            self._py_append(self._file(app_id, channel_id), _put_body(event))
            return
        payload = json.dumps(event_to_json(event)).encode("utf-8")
        enc = lambda s: None if s is None else s.encode("utf-8")
        rc = self._lib.pio_write_put(
            self._handle(app_id, channel_id),
            _to_us(event.event_time),
            event.event_id.encode("utf-8"),
            event.event.encode("utf-8"),
            event.entity_type.encode("utf-8"),
            event.entity_id.encode("utf-8"),
            enc(event.target_entity_type),
            enc(event.target_entity_id),
            payload,
            len(payload),
        )
        if rc != 0:
            raise OSError(f"pio_write_put rc={rc}")

    def _write_del(self, event_id: str, app_id: int, channel_id: int | None) -> None:
        if self._lib is None:
            self._py_append(self._file(app_id, channel_id), _del_body(event_id))
            return
        rc = self._lib.pio_write_del(
            self._handle(app_id, channel_id), event_id.encode("utf-8")
        )
        if rc != 0:
            raise OSError(f"pio_write_del rc={rc}")

    # -- read path ----------------------------------------------------------
    def _scan_payloads(self, app_id: int, channel_id: int | None,
                       flt: EventFilter) -> list[bytes]:
        path = self._file(app_id, channel_id)
        if not os.path.exists(path):
            return []
        # event_names=[] means "match nothing" (EventFilter.matches
        # semantics); the native scan treats an empty list as unfiltered,
        # so short-circuit here.
        if flt.event_names is not None and len(flt.event_names) == 0:
            return []
        if self._lib is None:
            return _py_scan(path, flt)
        names = None
        n_names = 0
        if flt.event_names is not None:
            arr = [n.encode("utf-8") for n in flt.event_names]
            names = (ctypes.c_char_p * len(arr))(*arr)
            n_names = len(arr)
        tet_mode, tet = 0, None
        if flt.target_entity_type is not ...:
            if flt.target_entity_type is None:
                tet_mode = 1
            else:
                tet_mode, tet = 2, flt.target_entity_type.encode("utf-8")
        tei_mode, tei = 0, None
        if flt.target_entity_id is not ...:
            if flt.target_entity_id is None:
                tei_mode = 1
            else:
                tei_mode, tei = 2, flt.target_entity_id.encode("utf-8")
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        rc = self._lib.pio_scan(
            path.encode(),
            1 if flt.start_time is not None else 0,
            _to_us(flt.start_time) if flt.start_time is not None else 0,
            1 if flt.until_time is not None else 0,
            _to_us(flt.until_time) if flt.until_time is not None else 0,
            flt.entity_type.encode("utf-8") if flt.entity_type is not None else None,
            flt.entity_id.encode("utf-8") if flt.entity_id is not None else None,
            names,
            n_names,
            tet_mode,
            tet,
            tei_mode,
            tei,
            ctypes.byref(out),
            ctypes.byref(out_len),
        )
        if rc != 0:
            raise OSError(f"pio_scan rc={rc}")
        global NATIVE_SCANS
        NATIVE_SCANS += 1
        try:
            raw = ctypes.string_at(out, out_len.value)
        finally:
            self._lib.pio_free(out)
        (count,) = struct.unpack_from("<I", raw, 0)
        payloads = []
        off = 4
        for _ in range(count):
            (n,) = struct.unpack_from("<I", raw, off)
            off += 4
            payloads.append(raw[off : off + n])
            off += n
        return payloads

    # -- Events DAO ---------------------------------------------------------
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            path = self._file(app_id, channel_id)
            if not os.path.exists(path):
                with open(path, "wb") as f:
                    f.write(_MAGIC)
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            key = (app_id, channel_id)
            if self._lib is not None and key in self._handles:
                self._lib.pio_close(self._handles.pop(key))
            path = self._file(app_id, channel_id)
            if os.path.exists(path):
                os.remove(path)
                return True
            return False

    def close(self) -> None:
        with self._lock:
            if self._lib is not None:
                for h in self._handles.values():
                    self._lib.pio_close(h)
                self._handles.clear()

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        event_id = event.event_id or uuid.uuid4().hex
        event = event.with_event_id(event_id)
        with self._lock:
            self._write_put(event, app_id, channel_id)
        return event_id

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        ids = []
        with self._lock:
            for event in events:
                ids.append(self.insert(event, app_id, channel_id))
        return ids

    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        with self._lock:
            path = self._file(app_id, channel_id)
            if not os.path.exists(path):
                return None
            if self._lib is None:
                rec = _py_replay(path).get(event_id)
                if rec is None:
                    return None
                return event_from_json(json.loads(rec[6]), validate=False)
            out = ctypes.POINTER(ctypes.c_uint8)()
            out_len = ctypes.c_uint64()
            rc = self._lib.pio_get(
                path.encode(), event_id.encode("utf-8"),
                ctypes.byref(out), ctypes.byref(out_len),
            )
            if rc == 1:
                return None
            if rc != 0:
                raise OSError(f"pio_get rc={rc}")
            try:
                raw = ctypes.string_at(out, out_len.value)
            finally:
                self._lib.pio_free(out)
            return event_from_json(json.loads(raw), validate=False)

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            if self.get(event_id, app_id, channel_id) is None:
                return False
            self._write_del(event_id, app_id, channel_id)
            return True

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter = EventFilter(),
    ) -> Iterator[Event]:
        with self._lock:
            payloads = self._scan_payloads(app_id, channel_id, filter)
        events = [event_from_json(json.loads(p), validate=False) for p in payloads]
        # event_id tiebreaker: equal-timestamp order (and who survives a
        # limit cut) must not depend on which codec produced the scan
        events.sort(key=lambda e: (e.event_time, e.event_id or ""),
                    reverse=filter.reversed)
        if filter.limit is not None and filter.limit >= 0:
            events = events[: filter.limit]
        return iter(events)

    def find_columnar(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter = EventFilter(),
        batch_size: int = base.Events.COLUMNAR_BATCH_SIZE,
    ):
        """The binary log's frame headers decode straight into arrays —
        time/name/entity/target live in fixed binary fields ahead of the
        JSON payload, so no Event object and no JSON parse happens for
        the hot columns (the payload rides along as the lazy cold
        column). Same (event_time, event_id) ordering and limit cut as
        ``find``. The per-record fflush in the native writer
        (native/eventlog.cc pio_write_put) is what makes reading the
        file directly safe while a native handle is open."""
        check_batch_size(batch_size)
        return self._find_columnar(app_id, channel_id, filter, batch_size)

    def _find_columnar(self, app_id, channel_id, filter, batch_size):
        with self._lock:
            path = self._file(app_id, channel_id)
            if not os.path.exists(path):
                return
            if filter.event_names is not None and len(filter.event_names) == 0:
                return
            records = _py_scan_records(path, filter)
        # same total order as find(): find sorts by the PAYLOAD's
        # event_time (wire JSON, millisecond-truncated) with event_id
        # tiebreak, so the columnar sort key truncates t_us to ms —
        # sorting by raw µs could order sub-millisecond neighbors
        # differently from the row path; ids are unique so
        # ascending-sort + reverse equals a descending sort
        records.sort(key=lambda r: (r[1] // 1000, r[0]),
                     reverse=filter.reversed)
        if filter.limit is not None and filter.limit >= 0:
            records = records[: filter.limit]
        for at in range(0, len(records), batch_size):
            chunk = records[at:at + batch_size]
            ids, t_us, names, etypes, eids, tets, teis, payloads = zip(*chunk)
            yield EventColumns.from_event_json(
                times_us=np.asarray(t_us, dtype=np.int64),
                event=encode_column(names),
                entity_type=encode_column(etypes),
                entity_id=encode_column(eids),
                target_entity_type=encode_column(tets),
                target_entity_id=encode_column(teis),
                event_ids=ids,
                payloads=payloads,
            )


class BinEventsStorageClient(base.BaseStorageClient):
    """Events-only client (HBase role), native scan when available."""

    def __init__(self, config: StorageClientConfig = StorageClientConfig()):
        super().__init__(config)
        path = config.properties.get(
            "PATH",
            os.path.join(
                os.environ.get("PIO_FS_BASEDIR",
                               os.path.join(os.path.expanduser("~"), ".pio_store")),
                "binevents",
            ),
        )
        use_native = config.properties.get("NATIVE", "true").lower() != "false"
        self._events = BinEvents(path, use_native=use_native)

    def events(self) -> BinEvents:
        return self._events
