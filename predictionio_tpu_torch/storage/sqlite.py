"""Embedded SQL storage backend (sqlite3) — the "jdbc" analogue.

Mirrors the reference's JDBC backend design
(reference: storage/jdbc/src/main/scala/.../jdbc/{StorageClient,JDBCLEvents,
JDBCPEvents,JDBCUtils,JDBCApps,JDBCAccessKeys,JDBCChannels,
JDBCEngineInstances,JDBCEvaluationInstances,JDBCModels}.scala): one event
table per (app, channel) named ``pio_event_<app>[_<channel>]``
(JDBCUtils.eventTableName), metadata tables ``pio_meta_*``, model blobs in
``pio_model_data``. Implemented on Python's stdlib sqlite3 with WAL mode;
serves as the embedded default store.

A copy of the JAX package's ``storage/sqlite.py`` with the same schema
and table names, so one database file is read and written by either
package. The PostgreSQL adapter that reuses these DAOs in the JAX
package is ROADMAP.md queue 1 item 23.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import sqlite3
import threading
import uuid
from contextlib import contextmanager
from datetime import datetime, timezone
from typing import Iterator

import numpy as np

from predictionio_tpu_torch.core.columns import (
    EventColumns,
    check_batch_size,
    datetime_to_us,
    encode_column,
)
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.core.json_codec import parse_datetime
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


def event_table_name(app_id: int, channel_id: int | None) -> str:
    """Parity: JDBCUtils.eventTableName."""
    suffix = f"_{channel_id}" if channel_id is not None else ""
    return f"pio_event_{app_id}{suffix}"


class _Connection:
    """A bounded connection pool over one sqlite database.

    Per-request threads (ThreadingHTTPServer spawns one per request) borrow
    a pooled connection instead of opening their own, so connection count
    is bounded regardless of thread churn. ``:memory:`` databases use a
    single shared connection (a second connection would see a different,
    empty database).

    The pool belongs to the process that made it. A forked child (the
    parallel evaluation grid's eval workers) starts a pool of its own at
    its first borrow, because sqlite forbids using a connection across
    ``fork``; the parent's connections are kept, unused and open, so
    that closing them cannot touch the parent's locks.
    """

    POOL_SIZE = 8

    def __init__(self, path: str):
        self.path = path
        self._closed = False
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._pool: "queue.Queue[sqlite3.Connection]" = queue.Queue()
        self._created = 0
        self._created_lock = threading.Lock()
        self._max = 1 if path == ":memory:" else self.POOL_SIZE
        self._pid = os.getpid()
        self._inherited: list = []

    def _new_conn(self) -> sqlite3.Connection:
        # check_same_thread=False: connections move between borrowing
        # threads, but only one thread uses a connection at a time.
        conn = sqlite3.connect(self.path, timeout=30.0, check_same_thread=False)
        if self.path != ":memory:":
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    def _after_fork(self) -> None:
        with self._created_lock:
            if self._pid == os.getpid():
                return
            self._pid = os.getpid()
            if self.path == ":memory:":
                return  # the child's copy of the in-process database
            self._inherited.append(self._pool)
            self._pool = queue.Queue()
            self._created = 0

    @contextmanager
    def _borrow(self):
        if self._closed:
            raise sqlite3.ProgrammingError("storage connection is closed")
        if self._pid != os.getpid():
            self._after_fork()
        conn: sqlite3.Connection | None = None
        try:
            conn = self._pool.get_nowait()
        except queue.Empty:
            with self._created_lock:
                below_cap = self._created < self._max
                if below_cap:
                    self._created += 1
            if below_cap:
                try:
                    conn = self._new_conn()
                except Exception:
                    with self._created_lock:
                        self._created -= 1  # free the slot for a retry
                    raise
            else:
                conn = self._pool.get(timeout=60)
        returnable = True
        try:
            yield conn
        except BaseException:
            # never return a connection with a half-applied transaction
            try:
                conn.rollback()
            except sqlite3.Error:
                returnable = False
            raise
        finally:
            if self._closed or not returnable:
                conn.close()
                if not returnable:
                    with self._created_lock:
                        self._created -= 1
            else:
                self._pool.put(conn)

    def execute(self, sql: str, params: tuple = ()) -> list[tuple]:
        with self._borrow() as conn:
            cur = conn.execute(sql, params)
            rows = cur.fetchall()
            conn.commit()
            return rows

    def executemany(self, sql: str, seq: list[tuple]) -> None:
        with self._borrow() as conn:
            conn.executemany(sql, seq)
            conn.commit()

    @property
    def can_stream(self) -> bool:
        """Streaming holds a pooled connection across the consumer's
        whole scan loop; on a single-connection pool (``:memory:``)
        any nested DAO call from inside that loop would starve waiting
        for the one connection — such pools must take the buffered
        read path instead."""
        return self._max > 1

    def execute_stream(self, sql: str, params: tuple = (),
                       arraysize: int = 1024):
        """One query, rows yielded in ``fetchmany``-sized chunks while
        the borrowed connection is held — the columnar scan's streaming
        read (a full ``fetchall`` would hold every row of a training
        scan in Python lists at once). The generator must be exhausted
        or closed for the connection to return to the pool; closing it
        early (consumer break) releases via GeneratorExit. Callers must
        honor :attr:`can_stream` (see there for the pool hazard)."""
        with self._borrow() as conn:
            cur = conn.execute(sql, params)
            while True:
                rows = cur.fetchmany(arraysize)
                if not rows:
                    break
                yield rows
            conn.commit()

    def close(self) -> None:
        self._closed = True
        while True:
            try:
                self._pool.get_nowait().close()
            except queue.Empty:
                break


def _is_no_table(err: sqlite3.OperationalError) -> bool:
    return "no such table" in str(err)


_EVENT_COLUMNS = (
    "id, event, entityType, entityId, targetEntityType, targetEntityId, "
    "properties, eventTime, tags, prId, creationTime"
)


def _fmt_utc(t: datetime) -> str:
    """Storage time format: UTC, fixed-width microseconds — lexicographic
    order equals instant order, and no precision is lost (the millisecond
    wire format in json_codec is only for the REST API)."""
    return t.astimezone(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def _event_to_row(event_id: str, e: Event) -> tuple:
    return (
        event_id,
        e.event,
        e.entity_type,
        e.entity_id,
        e.target_entity_type,
        e.target_entity_id,
        json.dumps(e.properties.to_json()),
        _fmt_utc(e.event_time),
        json.dumps(list(e.tags)),
        e.pr_id,
        _fmt_utc(e.creation_time),
    )


def _row_to_event(row: tuple) -> Event:
    return Event(
        event_id=row[0],
        event=row[1],
        entity_type=row[2],
        entity_id=row[3],
        target_entity_type=row[4],
        target_entity_id=row[5],
        properties=DataMap.from_json(json.loads(row[6])),
        event_time=parse_datetime(row[7]),
        tags=tuple(json.loads(row[8])),
        pr_id=row[9],
        creation_time=parse_datetime(row[10]),
    )


def _times_to_us(raw: list[str]) -> np.ndarray:
    """Vectorized fixed-width-UTC text -> int64 epoch-micros. The
    storage format (``_fmt_utc``) is always ``...%fZ``; anything else
    (hand-written rows) falls back to per-row ISO parsing. The Z check
    must come FIRST: blindly stripping the last char of a non-Z string
    can still parse (dropping a fractional digit) and return a silently
    wrong instant instead of a ValueError."""
    arr = np.asarray(raw)
    if bool(np.all(np.char.endswith(arr, "Z"))):
        try:
            return (np.char.rstrip(arr, "Z")
                    .astype("datetime64[us]").astype(np.int64))
        except ValueError:
            pass
    return np.asarray([datetime_to_us(parse_datetime(s)) for s in raw],
                      dtype=np.int64)


def _rows_to_columns(rows: list[tuple]):
    """One fetchmany chunk -> EventColumns, no Event materialization:
    ``zip(*rows)`` transposes at C speed, the dictionary encoding is the
    C-level ``encode_column``, and properties/tags stay the row's JSON
    text (the lazy column)."""
    (ids, ev_names, etypes, eids, tets, teis, props, times, tags, pr_ids,
     ctimes) = zip(*rows)
    return EventColumns.from_sql_columns(
        times_us=_times_to_us(times),
        event=encode_column(ev_names),
        entity_type=encode_column(etypes),
        entity_id=encode_column(eids),
        target_entity_type=encode_column(tets),
        target_entity_id=encode_column(teis),
        event_ids=ids,
        props_json=props,
        tags_json=tags,
        pr_ids=pr_ids,
        creation_raw=ctimes,
    )


class SQLiteEvents(base.Events):
    """Event DAO on sqlite. Parity: JDBCLEvents.scala:37-289."""

    def __init__(self, conn: _Connection):
        self._conn = conn

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        t = event_table_name(app_id, channel_id)
        self._conn.execute(
            f"""CREATE TABLE IF NOT EXISTS {t} (
                id TEXT NOT NULL PRIMARY KEY,
                event TEXT NOT NULL,
                entityType TEXT NOT NULL,
                entityId TEXT NOT NULL,
                targetEntityType TEXT,
                targetEntityId TEXT,
                properties TEXT,
                eventTime TEXT NOT NULL,
                tags TEXT,
                prId TEXT,
                creationTime TEXT NOT NULL)"""
        )
        # entity-clustered time-ordered access path, the role the HBase
        # backend gives its rowkey design (HBEventsUtil.scala:84-131).
        # Both indexes end in (eventTime, id) because the scan SQL
        # orders by exactly that pair (the plan-independent tie order,
        # _scan_sql): with id in the index, ordered+limited reads walk
        # the index and skip the temp B-tree sort. Pre-existing tables
        # keep their narrower indexes (IF NOT EXISTS) and simply pay
        # the sort.
        self._conn.execute(
            f"CREATE INDEX IF NOT EXISTS {t}_entity ON {t} "
            "(entityType, entityId, eventTime, id)"
        )
        self._conn.execute(
            f"CREATE INDEX IF NOT EXISTS {t}_time ON {t} (eventTime, id)"
        )
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        self._conn.execute(f"DROP TABLE IF EXISTS {event_table_name(app_id, channel_id)}")
        return True

    def close(self) -> None:
        self._conn.close()

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        event_id = event.event_id or uuid.uuid4().hex
        t = event_table_name(app_id, channel_id)
        sql = (
            f"INSERT OR REPLACE INTO {t} ({_EVENT_COLUMNS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?)"
        )
        row = _event_to_row(event_id, event)
        try:
            self._conn.execute(sql, row)
        except sqlite3.OperationalError as err:
            if not _is_no_table(err):
                raise
            # auto-init on first insert: same contract as the memory backend
            self.init(app_id, channel_id)
            self._conn.execute(sql, row)
        return event_id

    def insert_batch(
        self, events, app_id: int, channel_id: int | None = None
    ) -> list[str]:
        ids = [e.event_id or uuid.uuid4().hex for e in events]
        t = event_table_name(app_id, channel_id)
        sql = (
            f"INSERT OR REPLACE INTO {t} ({_EVENT_COLUMNS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?)"
        )
        rows = [_event_to_row(i, e) for i, e in zip(ids, events)]
        try:
            self._conn.executemany(sql, rows)
        except sqlite3.OperationalError as err:
            if not _is_no_table(err):
                raise
            self.init(app_id, channel_id)
            self._conn.executemany(sql, rows)
        return ids

    def get(self, event_id: str, app_id: int, channel_id: int | None = None) -> Event | None:
        t = event_table_name(app_id, channel_id)
        try:
            rows = self._conn.execute(
                f"SELECT {_EVENT_COLUMNS} FROM {t} WHERE id = ?", (event_id,)
            )
        except sqlite3.OperationalError as err:
            if _is_no_table(err):
                return None
            raise
        return _row_to_event(rows[0]) if rows else None

    def delete(self, event_id: str, app_id: int, channel_id: int | None = None) -> bool:
        t = event_table_name(app_id, channel_id)
        try:
            existed = bool(
                self._conn.execute(f"SELECT 1 FROM {t} WHERE id = ?", (event_id,))
            )
            self._conn.execute(f"DELETE FROM {t} WHERE id = ?", (event_id,))
        except sqlite3.OperationalError as err:
            if _is_no_table(err):
                return False
            raise
        return existed

    @staticmethod
    def _scan_sql(app_id: int, channel_id: int | None,
                  filter: EventFilter) -> tuple[str, tuple]:
        """WHERE-clause assembly parity: JDBCPEvents.find:33-120. Shared
        by the row iterator and the columnar scan so both read the SAME
        sequence (order, ties, limit) from the database."""
        t = event_table_name(app_id, channel_id)
        clauses, params = [], []
        f = filter
        if f.start_time is not None:
            clauses.append("eventTime >= ?")
            params.append(_fmt_utc(f.start_time))
        if f.until_time is not None:
            clauses.append("eventTime < ?")
            params.append(_fmt_utc(f.until_time))
        if f.entity_type is not None:
            clauses.append("entityType = ?")
            params.append(f.entity_type)
        if f.entity_id is not None:
            clauses.append("entityId = ?")
            params.append(f.entity_id)
        if f.event_names is not None:
            placeholders = ",".join("?" * len(f.event_names))
            clauses.append(f"event IN ({placeholders})")
            params.extend(f.event_names)
        if f.target_entity_type is not ...:
            if f.target_entity_type is None:
                clauses.append("targetEntityType IS NULL")
            else:
                clauses.append("targetEntityType = ?")
                params.append(f.target_entity_type)
        if f.target_entity_id is not ...:
            if f.target_entity_id is None:
                clauses.append("targetEntityId IS NULL")
            else:
                clauses.append("targetEntityId = ?")
                params.append(f.target_entity_id)
        where = f" WHERE {' AND '.join(clauses)}" if clauses else ""
        # id tiebreak: equal-timestamp order must not depend on which
        # query plan ran the scan (the planner picks different index
        # strategies for find vs the hinted columnar scan, and SQL
        # gives ties no order at all without this — measured divergence
        # on reversed entity-filtered scans)
        order = (" ORDER BY eventTime DESC, id DESC" if f.reversed
                 else " ORDER BY eventTime, id")
        limit = (
            f" LIMIT {int(f.limit)}" if f.limit is not None and f.limit >= 0 else ""
        )
        return (f"SELECT {_EVENT_COLUMNS} FROM {t}{where}{order}{limit}",
                tuple(params))

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter = EventFilter(),
    ) -> Iterator[Event]:
        sql, params = self._scan_sql(app_id, channel_id, filter)
        try:
            rows = self._conn.execute(sql, params)
        except sqlite3.OperationalError as err:
            if _is_no_table(err):
                return iter(())
            raise
        return (_row_to_event(r) for r in rows)

    def find_columnar(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter = EventFilter(),
        batch_size: int = base.Events.COLUMNAR_BATCH_SIZE,
    ):
        """Native path: ONE SQL scan streamed ``fetchmany`` -> columns.
        Rows become arrays without ``_row_to_event`` — no Event object,
        no properties/tags JSON parse (they stay the row's JSON text in
        the lazy column), and the two timestamps parse vectorized (the
        storage format is fixed-width UTC, ``_fmt_utc``). A
        single-connection pool (``:memory:``, see ``can_stream``) takes
        one ``execute`` chunked in Python — same rows, same columns."""
        check_batch_size(batch_size)
        return self._find_columnar(app_id, channel_id, filter, batch_size)

    def _find_columnar(self, app_id, channel_id, filter, batch_size):
        sql, params = self._scan_sql(app_id, channel_id, filter)
        if not self._conn.can_stream:
            try:
                rows = self._conn.execute(sql, params)
            except sqlite3.OperationalError as err:
                if _is_no_table(err):
                    return
                raise
            for at in range(0, len(rows), batch_size):
                yield _rows_to_columns(rows[at:at + batch_size])
            return
        # bulk-scan plan hint: for a whole-table training read the planner
        # still picks the entity index off an entityType predicate and
        # pays a random rowid lookup per row plus a temp B-tree sort
        # (measured ~3x the sequential scan at 50k rows); NOT INDEXED
        # forces the table scan. Applied when nothing marks the scan
        # selective — no entity_id, no time bounds, no limit.
        # entity_type alone deliberately does NOT disable the hint:
        # a training scan always carries one (every event of a
        # recommendation app is entityType='user', which is precisely
        # the unselective predicate that baited the planner), at the
        # accepted cost that a scan over a genuinely rare entity type
        # also table-scans. Anything else keeps the planner's choice
        # (the extended (…, eventTime, id) indexes serve time ranges
        # and single-entity reads in index order, measured µs-to-ms).
        if (filter.entity_id is None and filter.start_time is None
                and filter.until_time is None and filter.limit is None):
            t = event_table_name(app_id, channel_id)
            sql = sql.replace(f"FROM {t} ", f"FROM {t} NOT INDEXED ", 1)
        try:
            for rows in self._conn.execute_stream(sql, params, arraysize=batch_size):
                yield _rows_to_columns(rows)
        except sqlite3.OperationalError as err:
            if _is_no_table(err):
                return
            raise


class SQLiteApps(base.Apps):
    def __init__(self, conn: _Connection):
        self._conn = conn
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS pio_meta_apps (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                name TEXT NOT NULL UNIQUE,
                description TEXT)"""
        )

    def insert(self, app: App) -> int | None:
        try:
            if app.id > 0:
                self._conn.execute(
                    "INSERT INTO pio_meta_apps (id, name, description) VALUES (?,?,?)",
                    (app.id, app.name, app.description),
                )
                return app.id
            self._conn.execute(
                "INSERT INTO pio_meta_apps (name, description) VALUES (?,?)",
                (app.name, app.description),
            )
            rows = self._conn.execute(
                "SELECT id FROM pio_meta_apps WHERE name = ?", (app.name,)
            )
            return int(rows[0][0])
        except sqlite3.IntegrityError:
            return None

    def get(self, app_id: int) -> App | None:
        rows = self._conn.execute(
            "SELECT id, name, description FROM pio_meta_apps WHERE id = ?", (app_id,)
        )
        return App(*rows[0]) if rows else None

    def get_by_name(self, name: str) -> App | None:
        rows = self._conn.execute(
            "SELECT id, name, description FROM pio_meta_apps WHERE name = ?", (name,)
        )
        return App(*rows[0]) if rows else None

    def get_all(self) -> list[App]:
        return [
            App(*r)
            for r in self._conn.execute(
                "SELECT id, name, description FROM pio_meta_apps ORDER BY id"
            )
        ]

    def update(self, app: App) -> None:
        self._conn.execute(
            "UPDATE pio_meta_apps SET name = ?, description = ? WHERE id = ?",
            (app.name, app.description, app.id),
        )

    def delete(self, app_id: int) -> None:
        self._conn.execute("DELETE FROM pio_meta_apps WHERE id = ?", (app_id,))


class SQLiteAccessKeys(base.AccessKeys):
    def __init__(self, conn: _Connection):
        self._conn = conn
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS pio_meta_accesskeys (
                accesskey TEXT NOT NULL PRIMARY KEY,
                appid INTEGER NOT NULL,
                events TEXT)"""
        )

    def insert(self, access_key: AccessKey) -> str | None:
        key = access_key.key or self.generate_key()
        try:
            self._conn.execute(
                "INSERT INTO pio_meta_accesskeys (accesskey, appid, events) VALUES (?,?,?)",
                (key, access_key.appid, json.dumps(list(access_key.events))),
            )
            return key
        except sqlite3.IntegrityError:
            return None

    def _row(self, r: tuple) -> AccessKey:
        return AccessKey(r[0], r[1], tuple(json.loads(r[2] or "[]")))

    def get(self, key: str) -> AccessKey | None:
        rows = self._conn.execute(
            "SELECT accesskey, appid, events FROM pio_meta_accesskeys WHERE accesskey = ?",
            (key,),
        )
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[AccessKey]:
        return [
            self._row(r)
            for r in self._conn.execute(
                "SELECT accesskey, appid, events FROM pio_meta_accesskeys"
            )
        ]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [
            self._row(r)
            for r in self._conn.execute(
                "SELECT accesskey, appid, events FROM pio_meta_accesskeys WHERE appid = ?",
                (app_id,),
            )
        ]

    def update(self, access_key: AccessKey) -> None:
        self._conn.execute(
            "UPDATE pio_meta_accesskeys SET appid = ?, events = ? WHERE accesskey = ?",
            (access_key.appid, json.dumps(list(access_key.events)), access_key.key),
        )

    def delete(self, key: str) -> None:
        self._conn.execute(
            "DELETE FROM pio_meta_accesskeys WHERE accesskey = ?", (key,)
        )


class SQLiteChannels(base.Channels):
    def __init__(self, conn: _Connection):
        self._conn = conn
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS pio_meta_channels (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                name TEXT NOT NULL,
                appid INTEGER NOT NULL)"""
        )

    def insert(self, channel: Channel) -> int | None:
        if not Channel.is_valid_name(channel.name):
            return None
        try:
            if channel.id > 0:
                self._conn.execute(
                    "INSERT INTO pio_meta_channels (id, name, appid) VALUES (?,?,?)",
                    (channel.id, channel.name, channel.appid),
                )
                return channel.id
            # RETURNING keeps the id fetch on the SAME pooled connection
            # as the insert — a separate `SELECT last_insert_rowid()`
            # call can borrow a different connection and return a stale
            # or zero id
            rows = self._conn.execute(
                "INSERT INTO pio_meta_channels (name, appid) VALUES (?,?) "
                "RETURNING id",
                (channel.name, channel.appid),
            )
        except sqlite3.IntegrityError:
            return None
        return int(rows[0][0])

    def get(self, channel_id: int) -> Channel | None:
        rows = self._conn.execute(
            "SELECT id, name, appid FROM pio_meta_channels WHERE id = ?", (channel_id,)
        )
        return Channel(*rows[0]) if rows else None

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [
            Channel(*r)
            for r in self._conn.execute(
                "SELECT id, name, appid FROM pio_meta_channels WHERE appid = ?",
                (app_id,),
            )
        ]

    def delete(self, channel_id: int) -> None:
        self._conn.execute("DELETE FROM pio_meta_channels WHERE id = ?", (channel_id,))


class SQLiteEngineInstances(base.EngineInstances):
    def __init__(self, conn: _Connection):
        self._conn = conn
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS pio_meta_engineinstances (
                id TEXT NOT NULL PRIMARY KEY,
                status TEXT NOT NULL,
                startTime TEXT NOT NULL,
                completionTime TEXT NOT NULL,
                engineId TEXT NOT NULL,
                engineVersion TEXT NOT NULL,
                engineVariant TEXT NOT NULL,
                engineFactory TEXT NOT NULL,
                batch TEXT,
                env TEXT,
                meshConf TEXT,
                dataSourceParams TEXT,
                preparatorParams TEXT,
                algorithmsParams TEXT,
                servingParams TEXT)"""
        )

    _COLS = (
        "id, status, startTime, completionTime, engineId, engineVersion, "
        "engineVariant, engineFactory, batch, env, meshConf, dataSourceParams, "
        "preparatorParams, algorithmsParams, servingParams"
    )

    def _to_row(self, i: EngineInstance) -> tuple:
        return (
            i.id,
            i.status,
            _fmt_utc(i.start_time),
            _fmt_utc(i.completion_time),
            i.engine_id,
            i.engine_version,
            i.engine_variant,
            i.engine_factory,
            i.batch,
            json.dumps(i.env),
            json.dumps(i.mesh_conf),
            i.data_source_params,
            i.preparator_params,
            i.algorithms_params,
            i.serving_params,
        )

    def _from_row(self, r: tuple) -> EngineInstance:
        return EngineInstance(
            id=r[0],
            status=r[1],
            start_time=parse_datetime(r[2]),
            completion_time=parse_datetime(r[3]),
            engine_id=r[4],
            engine_version=r[5],
            engine_variant=r[6],
            engine_factory=r[7],
            batch=r[8] or "",
            env=json.loads(r[9] or "{}"),
            mesh_conf=json.loads(r[10] or "{}"),
            data_source_params=r[11] or "",
            preparator_params=r[12] or "",
            algorithms_params=r[13] or "",
            serving_params=r[14] or "",
        )

    def insert(self, instance: EngineInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        if not instance.id:
            instance = dataclasses.replace(instance, id=instance_id)
        self._conn.execute(
            f"INSERT OR REPLACE INTO pio_meta_engineinstances ({self._COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            self._to_row(instance),
        )
        return instance_id

    def get(self, instance_id: str) -> EngineInstance | None:
        rows = self._conn.execute(
            f"SELECT {self._COLS} FROM pio_meta_engineinstances WHERE id = ?",
            (instance_id,),
        )
        return self._from_row(rows[0]) if rows else None

    def get_all(self) -> list[EngineInstance]:
        return [
            self._from_row(r)
            for r in self._conn.execute(
                f"SELECT {self._COLS} FROM pio_meta_engineinstances"
            )
        ]

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        return [
            self._from_row(r)
            for r in self._conn.execute(
                f"SELECT {self._COLS} FROM pio_meta_engineinstances "
                "WHERE status = 'COMPLETED' AND engineId = ? AND "
                "engineVersion = ? AND engineVariant = ? ORDER BY startTime DESC",
                (engine_id, engine_version, engine_variant),
            )
        ]

    def update(self, instance: EngineInstance) -> None:
        self.insert(instance)

    def delete(self, instance_id: str) -> None:
        self._conn.execute(
            "DELETE FROM pio_meta_engineinstances WHERE id = ?", (instance_id,)
        )


class SQLiteEvaluationInstances(base.EvaluationInstances):
    def __init__(self, conn: _Connection):
        self._conn = conn
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS pio_meta_evaluationinstances (
                id TEXT NOT NULL PRIMARY KEY,
                status TEXT NOT NULL,
                startTime TEXT NOT NULL,
                completionTime TEXT NOT NULL,
                evaluationClass TEXT,
                engineParamsGeneratorClass TEXT,
                batch TEXT,
                env TEXT,
                meshConf TEXT,
                evaluatorResults TEXT,
                evaluatorResultsHTML TEXT,
                evaluatorResultsJSON TEXT)"""
        )

    _COLS = (
        "id, status, startTime, completionTime, evaluationClass, "
        "engineParamsGeneratorClass, batch, env, meshConf, evaluatorResults, "
        "evaluatorResultsHTML, evaluatorResultsJSON"
    )

    def _to_row(self, i: EvaluationInstance) -> tuple:
        return (
            i.id,
            i.status,
            _fmt_utc(i.start_time),
            _fmt_utc(i.completion_time),
            i.evaluation_class,
            i.engine_params_generator_class,
            i.batch,
            json.dumps(i.env),
            json.dumps(i.mesh_conf),
            i.evaluator_results,
            i.evaluator_results_html,
            i.evaluator_results_json,
        )

    def _from_row(self, r: tuple) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0],
            status=r[1],
            start_time=parse_datetime(r[2]),
            completion_time=parse_datetime(r[3]),
            evaluation_class=r[4] or "",
            engine_params_generator_class=r[5] or "",
            batch=r[6] or "",
            env=json.loads(r[7] or "{}"),
            mesh_conf=json.loads(r[8] or "{}"),
            evaluator_results=r[9] or "",
            evaluator_results_html=r[10] or "",
            evaluator_results_json=r[11] or "",
        )

    def insert(self, instance: EvaluationInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        if not instance.id:
            instance = dataclasses.replace(instance, id=instance_id)
        self._conn.execute(
            f"INSERT OR REPLACE INTO pio_meta_evaluationinstances ({self._COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
            self._to_row(instance),
        )
        return instance_id

    def get(self, instance_id: str) -> EvaluationInstance | None:
        rows = self._conn.execute(
            f"SELECT {self._COLS} FROM pio_meta_evaluationinstances WHERE id = ?",
            (instance_id,),
        )
        return self._from_row(rows[0]) if rows else None

    def get_all(self) -> list[EvaluationInstance]:
        return [
            self._from_row(r)
            for r in self._conn.execute(
                f"SELECT {self._COLS} FROM pio_meta_evaluationinstances"
            )
        ]

    def get_completed(self) -> list[EvaluationInstance]:
        return [
            self._from_row(r)
            for r in self._conn.execute(
                f"SELECT {self._COLS} FROM pio_meta_evaluationinstances "
                "WHERE status = 'EVALCOMPLETED' ORDER BY startTime DESC"
            )
        ]

    def update(self, instance: EvaluationInstance) -> None:
        self.insert(instance)

    def delete(self, instance_id: str) -> None:
        self._conn.execute(
            "DELETE FROM pio_meta_evaluationinstances WHERE id = ?", (instance_id,)
        )


class SQLiteModels(base.Models):
    """Model blobs in SQL. Parity: JDBCModels.scala."""

    def __init__(self, conn: _Connection):
        self._conn = conn
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS pio_model_data (
                id TEXT NOT NULL PRIMARY KEY,
                models BLOB NOT NULL)"""
        )

    def insert(self, model: Model) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO pio_model_data (id, models) VALUES (?,?)",
            (model.id, model.models),
        )

    def get(self, model_id: str) -> Model | None:
        rows = self._conn.execute(
            "SELECT id, models FROM pio_model_data WHERE id = ?", (model_id,)
        )
        return Model(rows[0][0], bytes(rows[0][1])) if rows else None

    def delete(self, model_id: str) -> None:
        self._conn.execute("DELETE FROM pio_model_data WHERE id = ?", (model_id,))


class SQLiteStorageClient(base.BaseStorageClient):
    """All three repositories on one sqlite database file.

    Config properties: PATH (db file; default pio.sqlite in cwd, or
    ":memory:" for tests). Parity role: storage/jdbc StorageClient.scala.
    """

    prefix = "SQLite"

    def __init__(self, config: StorageClientConfig = StorageClientConfig()):
        super().__init__(config)
        path = config.properties.get("PATH", "pio.sqlite")
        if config.test and "PATH" not in config.properties:
            path = ":memory:"
        self._conn = _Connection(path)
        self._lock = threading.RLock()
        self._cache: dict[str, object] = {}

    def _cached(self, key: str, factory):
        with self._lock:
            if key not in self._cache:
                self._cache[key] = factory(self._conn)
            return self._cache[key]

    def events(self) -> SQLiteEvents:
        return self._cached("events", SQLiteEvents)

    def apps(self) -> SQLiteApps:
        return self._cached("apps", SQLiteApps)

    def access_keys(self) -> SQLiteAccessKeys:
        return self._cached("access_keys", SQLiteAccessKeys)

    def channels(self) -> SQLiteChannels:
        return self._cached("channels", SQLiteChannels)

    def engine_instances(self) -> SQLiteEngineInstances:
        return self._cached("engine_instances", SQLiteEngineInstances)

    def evaluation_instances(self) -> SQLiteEvaluationInstances:
        return self._cached("evaluation_instances", SQLiteEvaluationInstances)

    def models(self) -> SQLiteModels:
        return self._cached("models", SQLiteModels)

    def close(self) -> None:
        self._conn.close()
