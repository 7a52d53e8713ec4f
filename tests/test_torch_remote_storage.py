"""The port's remote storage backends (``storage/{pgwire,postgres,
elasticsearch,s3,hdfs,chaos}.py``) on the CPU, against the JAX package's.

- The port's conformance classes of tests/test_torch_storage.py run
  again here, against ``postgres`` over tests/pg_emulator.py, against
  ``elasticsearch`` on an in-process fake ES (with its models in ``s3``
  on a fake object store, or in ``hdfs``), and against ``chaos`` over
  ``memory`` and ``sqlite`` at 0.3 faults.
- A store written by one package is read by the other, and the same
  writes land as the same tables and rows (PostgreSQL), the same indices
  and ``_source`` documents (ES), the same object keys and bytes (S3)
  and the same files (hdfs).
- The pure functions (``sign_v4_headers`` on a fixed clock,
  ``quote_literal``, ``bind_placeholders``, ``translate_sql``,
  ``saslprep``) give equal results, or the same error, on the same
  inputs; ``PGConnection`` authenticates by MD5 and SCRAM-SHA-256 and
  refuses a tampered server signature.

The fakes are copied from tests/test_remote_backends.py rather than
imported: that module re-exports the JAX package's conformance classes,
which would be collected a second time here.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.storage import base as jbase
from predictionio_tpu.storage import pgwire as jpgwire
from predictionio_tpu.storage import postgres as jpostgres
from predictionio_tpu.storage import s3 as js3
from predictionio_tpu.storage.elasticsearch import ESStorageClient as JaxES
from predictionio_tpu.storage.hdfs import HDFSStorageClient as JaxHDFS
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu_torch.storage import base as pbase
from predictionio_tpu_torch.storage import pgwire, postgres, s3
from predictionio_tpu_torch.storage.base import Model, StorageClientConfig
from predictionio_tpu_torch.storage.chaos import ChaosStorageClient
from predictionio_tpu_torch.storage.elasticsearch import ESStorageClient
from predictionio_tpu_torch.storage.hdfs import HDFSStorageClient
from predictionio_tpu_torch.storage.memory import MemoryStorageClient
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.storage.sqlite import SQLiteStorageClient

from pg_emulator import PGEmulator
from test_torch_storage import (  # noqa: F401  (collected here against the remote stores)
    TestColumnarRowEquivalence,
    TestDAOs,
    _fill_sqlite,
    _key,
    _seed_events,
)

SEED = 20260803
PG_PASSWORD = "s3cret"


# ---------------------------------------------------------------------------
# fake Elasticsearch (doc CRUD + match_all search + versions)
# ---------------------------------------------------------------------------

class _FakeES:
    def __init__(self):
        self.lock = threading.Lock()
        #: index -> type -> id -> (source, version)
        self.docs: dict[str, dict[str, dict[str, tuple[dict, int]]]] = {}


class _FakeESHandler(BaseHTTPRequestHandler):
    store: _FakeES = None

    def log_message(self, *args):
        pass

    def _json(self, code: int, body: dict) -> None:
        payload = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n)) if n else {}

    def _parts(self):
        return [p for p in self.path.split("?")[0].split("/") if p]

    def do_PUT(self):
        parts = self._parts()
        if len(parts) != 3:
            return self._json(400, {"error": "bad path"})
        index, type_, doc_id = parts
        doc = self._body()
        with self.store.lock:
            tp = self.store.docs.setdefault(index, {}).setdefault(type_, {})
            version = tp[doc_id][1] + 1 if doc_id in tp else 1
            tp[doc_id] = (doc, version)
        self._json(200 if version > 1 else 201,
                   {"_id": doc_id, "_version": version, "result": "created"})

    def do_GET(self):
        parts = self._parts()
        if len(parts) != 3:
            return self._json(400, {"error": "bad path"})
        index, type_, doc_id = parts
        with self.store.lock:
            hit = self.store.docs.get(index, {}).get(type_, {}).get(doc_id)
        if hit is None:
            return self._json(404, {"found": False})
        self._json(200, {"found": True, "_id": doc_id, "_source": hit[0],
                         "_version": hit[1]})

    def do_DELETE(self):
        parts = self._parts()
        with self.store.lock:
            if len(parts) == 1:
                if parts[0] not in self.store.docs:
                    return self._json(404, {"error": "index_not_found"})
                del self.store.docs[parts[0]]
                return self._json(200, {"acknowledged": True})
            if len(parts) == 3:
                index, type_, doc_id = parts
                tp = self.store.docs.get(index, {}).get(type_, {})
                if doc_id not in tp:
                    return self._json(404, {"found": False})
                del tp[doc_id]
                return self._json(200, {"found": True})
        self._json(400, {"error": "bad path"})

    def do_POST(self):
        parts = self._parts()
        if len(parts) == 3 and parts[2] == "_search":
            index, type_ = parts[0], parts[1]
            body = self._body()
            start = int(body.get("from", 0))
            size = int(body.get("size", 10))
            with self.store.lock:
                items = sorted(self.store.docs.get(index, {}).get(type_, {}).items())
            hits = [{"_id": doc_id, "_source": src}
                    for doc_id, (src, _v) in items[start:start + size]]
            return self._json(200, {"hits": {"total": len(items), "hits": hits}})
        self._json(400, {"error": "bad path"})


# ---------------------------------------------------------------------------
# fake S3 (path-style objects; a request without SigV4 headers gets 403)
# ---------------------------------------------------------------------------

class _FakeS3Handler(BaseHTTPRequestHandler):
    objects: dict = None

    def log_message(self, *args):
        pass

    def _check_auth(self) -> bool:
        auth = self.headers.get("Authorization", "")
        ok = (auth.startswith("AWS4-HMAC-SHA256 Credential=") and "Signature=" in auth
              and self.headers.get("x-amz-content-sha256") and self.headers.get("x-amz-date"))
        if not ok:
            self.send_response(403)
            self.send_header("Content-Length", "0")
            self.end_headers()
        return bool(ok)

    def _empty(self, code: int) -> None:
        self.send_response(code)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_PUT(self):
        if self._check_auth():
            n = int(self.headers.get("Content-Length", 0))
            self.objects[self.path] = self.rfile.read(n)
            self._empty(200)

    def do_GET(self):
        if not self._check_auth():
            return
        blob = self.objects.get(self.path)
        if blob is None:
            return self._empty(404)
        self.send_response(200)
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def do_DELETE(self):
        if self._check_auth():
            existed = self.objects.pop(self.path, None) is not None
            self._empty(204 if existed else 404)


def _serve(handler_cls, **attrs):
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 type("Handler", (handler_cls,), attrs))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture(scope="module")
def emulator():
    with PGEmulator(password=PG_PASSWORD) as emu:
        yield emu


@pytest.fixture(scope="module")
def es_server():
    store = _FakeES()
    server = _serve(_FakeESHandler, store=store)
    yield server.server_address[1], store
    server.shutdown()


@pytest.fixture
def es_store(es_server):
    port, store = es_server
    with store.lock:
        store.docs.clear()
    return port, store


@pytest.fixture
def s3_server():
    objects: dict = {}
    server = _serve(_FakeS3Handler, objects=objects)
    yield server.server_address[1], objects
    server.shutdown()


def _pg_props(emu, database=None) -> dict:
    return {"HOST": "127.0.0.1", "PORT": str(emu.port), "USERNAME": "pio",
            "PASSWORD": PG_PASSWORD, "DATABASE": database or f"db_{uuid.uuid4().hex[:12]}"}


def _es_props(port: int) -> dict:
    return {"HOSTS": "127.0.0.1", "PORTS": str(port), "INDEX": "pio"}


def _s3_props(port: int) -> dict:
    return {"BUCKET_NAME": "pio-models", "BASE_PATH": "prod/models",
            "ENDPOINT": f"http://127.0.0.1:{port}", "ACCESS_KEY_ID": "AKIDEXAMPLE",
            "SECRET_ACCESS_KEY": "secretkey"}


class _ESWithModels(ESStorageClient):
    """ES for metadata and events, beside a model repository: the ES
    backend has none, as in the reference."""

    def __init__(self, config, models):
        super().__init__(config)
        self._models = models

    def models(self):
        return self._models


def _remote_client(kind: str, request, tmp_path):
    if kind == "postgres":
        return postgres.PGStorageClient(StorageClientConfig(
            properties=_pg_props(request.getfixturevalue("emulator"))))
    if kind.startswith("elasticsearch"):
        port, _ = request.getfixturevalue("es_store")
        config = StorageClientConfig(properties=_es_props(port))
        if kind == "elasticsearch+s3":
            s3_port, _ = request.getfixturevalue("s3_server")
            models = s3.S3StorageClient(StorageClientConfig(
                properties=_s3_props(s3_port))).models()
            return _ESWithModels(config, models)
        if kind == "elasticsearch+hdfs":
            return _ESWithModels(config, HDFSStorageClient(StorageClientConfig(
                properties={"PATH": str(tmp_path / "hdfs")})).models())
        return ESStorageClient(config)
    inner = (MemoryStorageClient() if kind == "chaos_memory" else SQLiteStorageClient(
        StorageClientConfig(properties={"PATH": str(tmp_path / "pio.sqlite")})))
    return ChaosStorageClient.wrap(inner, fault_rate=0.3, seed=SEED)


def _jax_twin(events_client, request, tmp_path):
    """The JAX package's backend of the same kind as ``events_client``,
    on a store of its own."""
    from predictionio_tpu.storage.chaos import ChaosStorageClient as JaxChaos
    from predictionio_tpu.storage.memory import MemoryStorageClient as JaxMemory
    from predictionio_tpu.storage.sqlite import SQLiteStorageClient as JaxSQLite

    if isinstance(events_client, postgres.PGStorageClient):
        return jpostgres.PGStorageClient(jbase.StorageClientConfig(
            properties=_pg_props(request.getfixturevalue("emulator"))))
    if isinstance(events_client, ESStorageClient):
        server = _serve(_FakeESHandler, store=_FakeES())
        request.addfinalizer(server.shutdown)
        return JaxES(jbase.StorageClientConfig(properties=_es_props(server.server_address[1])))
    inner = (JaxMemory() if isinstance(events_client.inner, MemoryStorageClient)
             else JaxSQLite(jbase.StorageClientConfig(
                 properties={"PATH": str(tmp_path / "jax.sqlite")})))
    return JaxChaos.wrap(inner, fault_rate=0.3, seed=SEED)


class TestColumnarRowEquivalence(TestColumnarRowEquivalence):  # noqa: F811
    def test_find_equals_jax_backend(self, events_client, request, tmp_path):
        """The same events and filters through the JAX package's backend
        of the same kind give the same sequences."""
        from test_torch_storage import FILTERS, _jax_filter

        jax_client = _jax_twin(events_client, request, tmp_path)
        events_client.events().insert_batch(_events("port"), 1)
        jax_client.events().insert_batch(_events("jax"), 1)
        for flt in FILTERS:
            assert [_key(e) for e in events_client.events().find(1, None, flt)] == \
                [_key(e) for e in jax_client.events().find(1, None, _jax_filter(flt))]
        jax_client.close()


# fixture overrides: the imported conformance classes run on these
@pytest.fixture(params=["postgres", "elasticsearch+s3", "elasticsearch+hdfs",
                        "chaos_memory", "chaos_sqlite"])
def client(request, tmp_path):
    c = _remote_client(request.param, request, tmp_path)
    yield c
    c.close()


@pytest.fixture(params=["postgres", "elasticsearch", "chaos_memory", "chaos_sqlite"])
def events_client(request, tmp_path):
    c = _remote_client(request.param, request, tmp_path)
    yield c
    c.close()


def _repos(source: str) -> dict:
    return {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": source
            for r in ("METADATA", "EVENTDATA", "MODELDATA")}


def _instances(storage, engine_cls, evaluation_cls) -> None:
    t = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)
    storage.get_meta_data_engine_instances().insert(engine_cls(
        "ei1", "COMPLETED", t, t, "e", "1", "v", "f", algorithms_params="[]"))
    storage.get_meta_data_evaluation_instances().insert(evaluation_cls(
        "ev1", "EVALCOMPLETED", t, t, evaluator_results="0.5"))


CREATED = datetime.datetime(2026, 1, 2, tzinfo=datetime.timezone.utc)


def _events(package: str) -> list:
    """The conformance seed with a fixed creation time, so that the two
    packages' writes are equal byte for byte."""
    seed = _seed_events(JaxEvent, JaxDataMap) if package == "jax" else _seed_events()
    return [dataclasses.replace(e, creation_time=CREATED) for e in seed]


def _write(storage, package: str):
    """One script of writes, in either package's classes."""
    b = jbase if package == "jax" else pbase
    app_id, ch = _fill_sqlite(storage, b.App, b.Channel, b.AccessKey, _events(package))
    _instances(storage, b.EngineInstance, b.EvaluationInstance)
    return app_id, ch


def _read_back(storage, writer_storage, app_id: int, ch: int) -> None:
    """The reader sees what the writer's own package reads back from the
    same store (ES keeps event times to the millisecond in both)."""
    t = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)
    app = storage.get_meta_data_apps().get_by_name("Shared")
    assert (app.id, app.description) == (app_id, "one file")
    assert [c.name for c in storage.get_meta_data_channels().get_by_app_id(app_id)] == ["web"]
    assert storage.get_meta_data_access_keys().get("k" * 64).events == ("rate",)
    for channel in (None, ch):
        want = [_key(e) for e in writer_storage.get_events().find(app_id, channel)]
        assert len(want) == (8 if channel is None else 3)
        assert [_key(e) for e in storage.get_events().find(app_id, channel)] == want
    ei = storage.get_meta_data_engine_instances().get("ei1")
    assert (ei.status, ei.start_time, ei.algorithms_params) == ("COMPLETED", t, "[]")
    assert storage.get_meta_data_evaluation_instances().get("ev1").evaluator_results == "0.5"


def _tables(emu, database: str) -> dict[str, list]:
    conn, lock, _ = emu.databases.get(database)
    with lock:
        names = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table' "
            "AND name NOT LIKE 'sqlite_%' ORDER BY name")]
        return {n: sorted(map(repr, conn.execute(f"SELECT * FROM {n}").fetchall()))
                for n in names}


class TestCrossPackagePostgres:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_one_database_read_by_the_other(self, emulator, writer):
        env = {"PIO_STORAGE_SOURCES_PG_TYPE": "postgres", **_repos("PG"),
               **{f"PIO_STORAGE_SOURCES_PG_{k}": v for k, v in _pg_props(emulator).items()}}
        w = (JaxStorage if writer == "jax" else Storage)(env)
        app_id, ch = _write(w, writer)
        r = (Storage if writer == "jax" else JaxStorage)(env)
        _read_back(r, w, app_id, ch)
        assert [_key(e) for e in r.get_events().find(app_id)] == \
            [_key(e) for e in _events("port")]
        r.close()
        w.close()

    def test_same_writes_make_the_same_tables_and_rows(self, emulator):
        dbs = {}
        for package, storage_cls in (("jax", JaxStorage), ("port", Storage)):
            props = _pg_props(emulator)
            dbs[package] = props["DATABASE"]
            env = {"PIO_STORAGE_SOURCES_PG_TYPE": "pg", **_repos("PG"),
                   **{f"PIO_STORAGE_SOURCES_PG_{k}": v for k, v in props.items()}}
            s = storage_cls(env)
            _write(s, package)
            s.get_model_data_models().insert(
                (jbase.Model if package == "jax" else Model)("m1", bytes(range(256))))
            s.close()
        jax_rows, port_rows = _tables(emulator, dbs["jax"]), _tables(emulator, dbs["port"])
        assert "pio_model_data" in port_rows and len(port_rows) >= 7
        assert jax_rows == port_rows


def _es_docs(store: _FakeES) -> dict:
    with store.lock:
        return {index: {t: {i: src for i, (src, _v) in docs.items()}
                        for t, docs in types.items()}
                for index, types in store.docs.items()}


class TestCrossPackageES:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_one_es_read_by_the_other(self, es_store, writer):
        port, _ = es_store
        env = {"PIO_STORAGE_SOURCES_ES_TYPE": "elasticsearch",
               "PIO_STORAGE_SOURCES_ES_HOSTS": "127.0.0.1",
               "PIO_STORAGE_SOURCES_ES_PORTS": str(port),
               "PIO_STORAGE_SOURCES_M_TYPE": "memory",
               "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "ES",
               "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "ES",
               "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"}
        w = (JaxStorage if writer == "jax" else Storage)(env)
        app_id, ch = _write(w, writer)
        r = (Storage if writer == "jax" else JaxStorage)(env)
        _read_back(r, w, app_id, ch)

    def test_same_writes_make_the_same_indices_and_sources(self):
        docs = {}
        for package, client_cls in (("jax", JaxES), ("port", ESStorageClient)):
            store = _FakeES()
            server = _serve(_FakeESHandler, store=store)
            b = jbase if package == "jax" else pbase
            client = client_cls(b.StorageClientConfig(
                properties=_es_props(server.server_address[1])))
            app_id = client.apps().insert(b.App(0, "Shared", "one file"))
            client.channels().insert(b.Channel(0, "web", app_id))
            client.access_keys().insert(b.AccessKey("k" * 64, app_id, ("rate",)))
            client.events().insert_batch(_events(package), app_id)
            t = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)
            client.engine_instances().insert(b.EngineInstance(
                "ei1", "COMPLETED", t, t, "e", "1", "v", "f", algorithms_params="[]"))
            docs[package] = _es_docs(store)
            server.shutdown()
        assert set(docs["port"]) == {"pio_meta", "pio_events_1"}
        assert docs["jax"] == docs["port"]


class TestCrossPackageModels:
    def test_s3_same_keys_and_bytes_and_read_across(self, s3_server):
        port, objects = s3_server
        blob = np.random.default_rng(SEED).bytes(4099)
        jax_models = js3.S3StorageClient(jbase.StorageClientConfig(
            properties=_s3_props(port))).models()
        port_models = s3.S3StorageClient(StorageClientConfig(
            properties=_s3_props(port))).models()
        jax_models.insert(jbase.Model("inst/a b", blob))
        after_jax = dict(objects)
        assert port_models.get("inst/a b").models == blob
        objects.clear()
        port_models.insert(Model("inst/a b", blob))
        assert objects == after_jax == {"/pio-models/prod/models/inst%2Fa%20b": blob}
        assert jax_models.get("inst/a b").models == blob
        port_models.delete("inst/a b")
        assert objects == {} and jax_models.get("inst/a b") is None
        assert port_models.get("missing") is None

    def test_s3_unsigned_request_is_refused(self, s3_server):
        port, _ = s3_server
        props = {k: v for k, v in _s3_props(port).items() if "KEY" not in k}
        unsigned = s3.S3Models(bucket="pio-models", endpoint=props["ENDPOINT"],
                               access_key="", secret_key="")
        unsigned._access_key = ""
        with pytest.raises(s3.S3Error, match="403"):
            unsigned.get("x")

    def test_hdfs_same_files_and_read_across(self, tmp_path):
        blob = np.random.default_rng(SEED + 1).bytes(1031)
        dirs = {}
        for package, client_cls, cfg_cls, model_cls in (
                ("jax", JaxHDFS, jbase.StorageClientConfig, jbase.Model),
                ("port", HDFSStorageClient, StorageClientConfig, Model)):
            d = tmp_path / package
            models = client_cls(cfg_cls(properties={"PATH": str(d), "PREFIX": "pio_"})).models()
            models.insert(model_cls("../inst/1", blob))
            models.insert(model_cls("inst-2", blob[:7]))
            dirs[package] = {p.name: p.read_bytes() for p in d.iterdir()}
        assert dirs["jax"] == dirs["port"] == {"pio___inst_1": blob, "pio_inst-2": blob[:7]}
        port_reads_jax = HDFSStorageClient(StorageClientConfig(
            properties={"PATH": str(tmp_path / "jax"), "PREFIX": "pio_"})).models()
        assert port_reads_jax.get("../inst/1").models == blob
        jax_reads_port = JaxHDFS(jbase.StorageClientConfig(
            properties={"PATH": str(tmp_path / "port"), "PREFIX": "pio_"})).models()
        assert jax_reads_port.get("inst-2").models == blob[:7]
        port_reads_jax.delete("../inst/1")
        assert port_reads_jax.get("../inst/1") is None
        assert sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["pio_inst-2"]


def _both(fn_jax, fn_port, arg):
    """Each package's result on ``arg``, or its error's class name and text."""
    out = []
    for fn in (fn_jax, fn_port):
        try:
            out.append(("ok", fn(*arg) if isinstance(arg, tuple) else fn(arg)))
        except Exception as exc:  # the same error in both is the parity
            out.append(("err", type(exc).__name__, str(exc)))
    return out


LITERALS = [None, True, False, 0, -7, 2 ** 63, 2.5, -0.0, 1e-300, float("nan"),
            float("inf"), float("-inf"), "", "o'brien", "back\\slash", "é ü 東京",
            "a\x00b", b"", b"\x00\xff", bytearray(b"ab"), memoryview(b"xy"),
            ["not", "scalar"], {"a": 1}]


class TestPureFunctions:
    @pytest.mark.parametrize("value", LITERALS,
                             ids=[f"{type(v).__name__}-{i}" for i, v in enumerate(LITERALS)])
    def test_quote_literal(self, value):
        jax_out, port_out = _both(jpgwire.quote_literal, pgwire.quote_literal, (value,))
        assert jax_out == port_out

    @pytest.mark.parametrize("sql, params", [
        ("SELECT ?", (1,)),
        ("SELECT * FROM t WHERE a = '?' AND b = ?", ("x",)),
        ("INSERT INTO t (a, b, c) VALUES (?, ?, ?)", (None, b"\x01", "it's")),
        ("SELECT 'it''s ?' , ?", (3.25,)),
        ("SELECT ?", ()),
        ("SELECT 1", ("extra",)),
        ("SELECT ?, ?", (1,)),
        ("SELECT 'unterminated ?", ()),
    ])
    def test_bind_placeholders(self, sql, params):
        jax_out, port_out = _both(jpgwire.bind_placeholders, pgwire.bind_placeholders,
                                  (sql, params))
        assert jax_out == port_out

    @pytest.mark.parametrize("sql", [
        "CREATE TABLE t (id INTEGER PRIMARY KEY AUTOINCREMENT, b BLOB NOT NULL)",
        "INSERT OR REPLACE INTO m (id, models) VALUES (?,?)",
        "INSERT OR REPLACE INTO k (key) VALUES (?)",
        "insert or replace into pio_meta_apps (id, name, description) values (?, ?, ?)",
        "SELECT id, name FROM pio_meta_apps WHERE id = ?",
        "SELECT blobby FROM t",
    ])
    def test_translate_sql(self, sql):
        assert postgres.translate_sql(sql) == jpostgres.translate_sql(sql)

    @pytest.mark.parametrize("value", [
        "plain", "p ss​word", "ﬁx", "pass\x00word", "ا1",
        "اب", "", "Ⅳ", "a　b", "퟿",
    ])
    def test_saslprep(self, value):
        jax_out, port_out = _both(jpgwire.saslprep, pgwire.saslprep, (value,))
        assert jax_out == port_out

    @pytest.mark.parametrize("method, url, payload", [
        ("PUT", "https://s3.us-east-1.amazonaws.com/bucket/models/a%20b", b"blob"),
        ("GET", "http://127.0.0.1:9000/pio-models/prod/models/x", b""),
        ("DELETE", "http://minio:9000/b/k?versionId=3", b""),
    ])
    def test_sign_v4_headers(self, method, url, payload):
        now = datetime.datetime(2026, 10, 17, 20, 38, 25, tzinfo=datetime.timezone.utc)
        args = (method, url, "eu-west-1", "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG", payload)
        got = s3.sign_v4_headers(*args, now=now)
        assert got == js3.sign_v4_headers(*args, now=now)
        assert got["Authorization"].startswith(
            "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20261017/eu-west-1/s3/aws4_request")

    def test_decode_value(self):
        cases = [(20, b"42"), (701, b"2.5"), (16, b"t"), (16, b"f"), (17, b"\\x00ff"),
                 (25, "é".encode()), (1700, b"1e3"), (23, None)]
        for oid, raw in cases:
            assert pgwire._decode_value(oid, raw) == jpgwire._decode_value(oid, raw)
        with pytest.raises(pgwire.PGProtocolError, match="hex"):
            pgwire._decode_value(17, b"escaped")


class TestWireSessions:
    def test_md5_session_and_typed_decode(self, emulator):
        conn = pgwire.PGConnection("127.0.0.1", emulator.port, user="pio",
                                   database=f"w_{uuid.uuid4().hex[:8]}", password=PG_PASSWORD)
        try:
            rows = conn.execute(
                "CREATE TABLE w (i INTEGER, f REAL, s TEXT, b BYTEA);"
                "INSERT INTO w VALUES (?, ?, ?, ?);"
                "SELECT i, f, s, b FROM w", (42, 2.5, "it's", b"\x01\x02"))
            assert rows == [(42, 2.5, "it's", b"\x01\x02")]
            with pytest.raises(pgwire.PGError) as err:
                conn.execute("SELECT * FROM missing_table")
            assert err.value.code == "42P01"
            assert conn.execute("SELECT 40 + 2") == [(42,)]   # the session recovers
        finally:
            conn.close()

    def test_md5_wrong_password(self, emulator):
        with pytest.raises(pgwire.PGError) as err:
            pgwire.PGConnection("127.0.0.1", emulator.port, user="pio",
                                database="x", password="wrong")
        assert err.value.code == "28P01"

    def test_scram_session_and_storage(self):
        raw = "p ss​word"          # SASLprep maps both characters
        with PGEmulator(password=raw, auth="scram") as emu:
            conn = pgwire.PGConnection("127.0.0.1", emu.port, user="pio",
                                       database="scram_ok", password=raw)
            try:
                assert conn.execute("SELECT 1") == [(1,)]
            finally:
                conn.close()
            props = {**_pg_props(emu, "scram_store"), "PASSWORD": raw}
            c = postgres.PGStorageClient(StorageClientConfig(properties=props))
            try:
                from predictionio_tpu_torch.storage.base import App

                app_id = c.apps().insert(App(0, "ScramApp"))
                assert c.apps().get(app_id).name == "ScramApp"
            finally:
                c.close()
            with pytest.raises(pgwire.PGError) as err:
                pgwire.PGConnection("127.0.0.1", emu.port, user="pio",
                                    database="x", password="wrong")
            assert err.value.code == "28P01"

    def test_tampered_server_signature_is_refused(self):
        with PGEmulator(password="pw", auth="scram", tamper_signature=b"\x00" * 32) as emu:
            for conn_cls, error in ((pgwire.PGConnection, pgwire.PGProtocolError),
                                    (jpgwire.PGConnection, jpgwire.PGProtocolError)):
                with pytest.raises(error, match="server signature verification failed"):
                    conn_cls("127.0.0.1", emu.port, user="pio", database="x", password="pw")

    def test_standard_conforming_strings_off_is_refused(self):
        with PGEmulator(password="pw", standard_conforming_strings="off") as emu:
            with pytest.raises(pgwire.PGProtocolError, match="standard_conforming_strings"):
                pgwire.PGConnection("127.0.0.1", emu.port, user="pio", database="x",
                                    password="pw")

    def test_pool_maps_errors_and_resyncs_serials(self, emulator):
        from predictionio_tpu_torch.storage.base import App, Channel

        c = postgres.PGStorageClient(StorageClientConfig(properties=_pg_props(emulator)))
        try:
            assert c.apps().insert(App(5, "explicit")) == 5
            assert c.apps().insert(App(0, "auto")) == 6          # no collision with 5
            ch = c.channels().insert(Channel(0, "web", 5))
            assert c.channels().get(ch).name == "web"
            assert c._conn.can_stream is False
            with pytest.raises(Exception, match="no such table"):
                c._conn.execute("SELECT * FROM nothing_here")
        finally:
            c.close()

    def test_unreachable_server_raises_after_retries(self):
        from predictionio_tpu_torch.utils.resilience import StorageUnavailableError

        c = postgres.PGStorageClient(StorageClientConfig(properties={
            "HOST": "127.0.0.1", "PORT": "1", "RETRY_MAX_ATTEMPTS": "2",
            "RETRY_BASE_DELAY_MS": "1"}))
        with pytest.raises((StorageUnavailableError, OSError)):
            c.apps().get_all()
