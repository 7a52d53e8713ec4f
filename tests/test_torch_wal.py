"""The port's write-ahead event journal (``predictionio_tpu_torch/data/wal.py``)
beside the JAX package's, on the CPU (lanes: tests/test_wal.py and
tests/test_wal_durability.py).

- The record codec and the frames are byte-identical: a journal written
  by either package's ``WriteAheadLog`` replays through the other's
  ``WalDrainer`` into equal storage, cursor and dead letters included.
- Recovery and accounting equal JAX's on the same damaged directory: a
  torn tail, a CRC-corrupt record, an insane length, rotation, the disk
  budget's ``WalFullError`` and its hysteresis, the dead-letter series
  and its requeue, ``scan_status``.
- ``kill -9`` of the port's own ``pio eventserver --wal-dir`` under
  write-through: every acknowledged 202 is read back after a restart.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone
from pathlib import Path

import pytest

from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.data import wal as jwal
from predictionio_tpu.utils.resilience import StorageUnavailableError as JaxUnavailable
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.data import wal as pwal
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.utils.resilience import StorageUnavailableError

pytestmark = pytest.mark.wal

REPO = Path(__file__).resolve().parent.parent
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
PKGS = {"jax": (jwal, JaxEvent, JaxDataMap, JaxUnavailable),
        "port": (pwal, Event, DataMap, StorageUnavailableError)}


def make_events(pkg: str, n: int, start: int = 0):
    _, event_cls, datamap_cls, _ = PKGS[pkg]
    return [event_cls(event="rate", entity_type="user", entity_id=f"u{i}",
                      target_entity_type="item", target_entity_id=f"i{i}",
                      properties=datamap_cls({"rating": i % 5, "nested": {"k": [i]}}),
                      tags=("t",) if i % 3 == 0 else (),
                      event_time=T0 + timedelta(seconds=i, microseconds=i),
                      creation_time=T0, event_id=f"id-{i:04d}")
            for i in range(start, start + n)]


def fill(pkg: str, wal, n: int, app_id: int = 1, channel_id=None, start: int = 0):
    mod = PKGS[pkg][0]
    events = make_events(pkg, n, start)
    for e in events:
        wal.append(mod.encode_record(e, app_id, channel_id))
    return events


class Sink:
    """insert_batch into a list, with a scriptable failure."""

    def __init__(self):
        self.rows: list[tuple] = []
        self.calls = 0
        self.fail = None

    def insert_batch(self, events, app_id, channel_id=None):
        self.calls += 1
        if self.fail is not None:
            exc = self.fail(events) if callable(self.fail) else self.fail
            if exc is not None:
                raise exc
        for e in events:
            self.rows.append((app_id, channel_id, e.event_id, e.event, e.entity_id,
                              e.target_entity_id, dict(e.properties.fields), tuple(e.tags),
                              e.event_time, e.creation_time))
        return [e.event_id for e in events]


def drain_all(mod, wal, sink, **kw) -> None:
    drainer = mod.WalDrainer(wal, sink.insert_batch, **kw)
    for _ in range(200):
        if drainer.drain_once() == mod.EMPTY:
            return
    raise AssertionError("drain did not finish")


# -- one format --------------------------------------------------------------

@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_journal_replays_through_the_other_package(tmp_path, writer, reader):
    wmod = PKGS[writer][0]
    wal = wmod.WriteAheadLog(str(tmp_path / "w"), fsync="off", segment_max_bytes=2048)
    fill(writer, wal, 30, app_id=1)
    fill(writer, wal, 5, app_id=2, channel_id=7, start=30)
    wal.close()
    shutil.copytree(tmp_path / "w", tmp_path / "copy")
    out = {}
    for pkg, d in ((writer, tmp_path / "w"), (reader, tmp_path / "copy")):
        mod = PKGS[pkg][0]
        journal = mod.WriteAheadLog(str(d), fsync="off")
        assert journal.pending_records() == 35
        sink = Sink()
        drain_all(mod, journal, sink)
        out[pkg] = (sink.rows, sink.calls, journal.counters(),
                    {**mod.scan_status(str(d)), "dir": None})
        journal.close()
    assert out[reader] == out[writer]
    rows, calls, _, _ = out[reader]
    assert len(rows) == 35 and [r[0:2] for r in rows[-5:]] == [(2, 7)] * 5
    assert calls == 2          # one insert_batch per (app, channel) run


def test_record_codec_is_byte_identical():
    for j, p in zip(make_events("jax", 6), make_events("port", 6)):
        assert jwal.encode_record(j, 3, None) == pwal.encode_record(p, 3, None)
        assert jwal.encode_record(j, 3, 9) == pwal.encode_record(p, 3, 9)
        event, app, ch = pwal.decode_record(jwal.encode_record(j, 3, 9))
        assert (event.event_id, event.event_time, app, ch) == (j.event_id, j.event_time, 3, 9)
    with pytest.raises(ValueError, match="pre-assigned"):
        pwal.encode_record(Event(event="a", entity_type="u", entity_id="1"), 1, None)


# -- recovery and accounting, side by side -----------------------------------

def _both(tmp_path, build):
    """Build one damaged journal directory per package with ``build(pkg,
    dir)``; return each package's recovered (counters, scan_status)."""
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        build(pkg, d)
        mod = PKGS[pkg][0]
        status = mod.scan_status(str(d))
        wal = mod.WriteAheadLog(str(d), fsync="off")
        sink = Sink()
        drain_all(mod, wal, sink)
        out[pkg] = ({**status, "dir": None}, wal.counters(), [r[2] for r in sink.rows])
        wal.close()
    assert out["port"] == out["jax"]
    return out["port"]


def test_torn_tail(tmp_path):
    def build(pkg, d):
        wal = PKGS[pkg][0].WriteAheadLog(str(d), fsync="off")
        fill(pkg, wal, 4)
        wal.close()
        seg = d / "wal-00000001.seg"
        with open(seg, "ab") as f:
            f.write(b"\x40\x00\x00\x00\x01\x02")      # a header and half a payload
    status, counters, ids = _both(tmp_path, build)
    assert status["tornTail"] and counters["tornBytesTruncated"] == 6 and len(ids) == 4


def test_crc_corrupt_record_is_skipped_and_counted(tmp_path):
    def build(pkg, d):
        wal = PKGS[pkg][0].WriteAheadLog(str(d), fsync="off")
        fill(pkg, wal, 5)
        wal.close()
        seg = d / "wal-00000001.seg"
        data = bytearray(seg.read_bytes())
        data[12] ^= 0xFF                               # a payload byte of record 0
        seg.write_bytes(bytes(data))
    status, counters, ids = _both(tmp_path, build)
    assert status["corruptRecords"] == counters["corruptRecords"] == 1
    assert ids == [f"id-{i:04d}" for i in range(1, 5)]


def test_insane_length_is_a_torn_tail(tmp_path):
    def build(pkg, d):
        wal = PKGS[pkg][0].WriteAheadLog(str(d), fsync="off")
        fill(pkg, wal, 2)
        wal.close()
        with open(d / "wal-00000001.seg", "ab") as f:
            f.write(b"\xff\xff\xff\x7f" + b"\x00" * 12)
    status, counters, ids = _both(tmp_path, build)
    assert status["tornTail"] and counters["tornBytesTruncated"] == 16 and len(ids) == 2


def test_rotation_and_reaping(tmp_path):
    def build(pkg, d):
        wal = PKGS[pkg][0].WriteAheadLog(str(d), fsync="off", segment_max_bytes=1024)
        fill(pkg, wal, 40)
        wal.close()
    for pkg in PKGS:
        d = tmp_path / f"r-{pkg}"
        build(pkg, d)
        assert len(list(d.glob("wal-*.seg"))) > 3
    status, counters, ids = _both(tmp_path, build)
    assert status["segments"] > 3 and counters["depth"] == 0 and len(ids) == 40
    for pkg in PKGS:
        # every consumed segment but the active one is gone
        assert len(list((tmp_path / pkg).glob("wal-*.seg"))) == 1


def test_rotation_under_concurrent_append(tmp_path):
    wal = pwal.WriteAheadLog(str(tmp_path / "w"), fsync="off", segment_max_bytes=4096)

    def writer(t):
        for e in make_events("port", 50, start=t * 50):
            wal.append(pwal.encode_record(e, 1, None))

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wal.close()
    sink = Sink()
    drain_all(jwal, jwal.WriteAheadLog(str(tmp_path / "w"), fsync="off"), sink)
    assert sorted(r[2] for r in sink.rows) == [f"id-{i:04d}" for i in range(200)]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_budget_raises_and_recovers(tmp_path, pkg):
    mod = PKGS[pkg][0]
    wal = mod.WriteAheadLog(str(tmp_path / "w"), fsync="off", max_bytes=1500)
    with pytest.raises(mod.WalFullError) as info:
        fill(pkg, wal, 20)
    assert info.value.max_bytes == 1500 and wal.is_full()
    pending = wal.pending_records()
    sink = Sink()
    drain_all(mod, wal, sink)
    assert len(sink.rows) == pending and not wal.is_full()
    fill(pkg, wal, 1, start=900)
    hint = mod.make_storage_unavailable(info.value, None)
    assert hint.retry_after == 1.0 and "disk budget" in str(hint)
    wal.close()


def test_budget_counts_equal_jax(tmp_path):
    counts = {}
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        wal = mod.WriteAheadLog(str(tmp_path / pkg), fsync="off", max_bytes=1500)
        try:
            fill(pkg, wal, 20)
        except mod.WalFullError as exc:
            counts[pkg] = (wal.counters(), str(exc))
        wal.close()
    assert counts["port"] == counts["jax"]


def test_dead_letter_and_requeue(tmp_path):
    """A record failing application-level replay is quarantined after
    ``max_replay_attempts``; the dead letters read alike by both
    packages, and a requeue replays them."""
    results = {}
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        d = str(tmp_path / pkg)
        wal = mod.WriteAheadLog(d, fsync="off")
        fill(pkg, wal, 3)
        wal.append(b"{not json")                        # undecodable
        fill(pkg, wal, 2, start=3)
        sink = Sink()
        sink.fail = lambda evs: (ValueError("poison") if any(
            e.event_id == "id-0001" for e in evs) else None)
        drainer = mod.WalDrainer(wal, sink.insert_batch, max_replay_attempts=2)
        verdicts = [drainer.drain_once() for _ in range(6)]
        results[pkg] = (verdicts, [r[2] for r in sink.rows], list(wal.dead_letters()),
                        wal.counters())
        wal.close()
    assert results["port"] == results["jax"]
    verdicts, ids, dead, counters = results["port"]
    assert ids == ["id-0000", "id-0002", "id-0003", "id-0004"]
    assert [d.get("attempts") for d in dead] == [2, 1]
    assert counters["deadLetterTotal"] == 2
    # the port requeues what JAX quarantined, and JAX reads the result
    wal = pwal.WriteAheadLog(str(tmp_path / "jax"), fsync="off")
    assert wal.requeue_dead_letters() == (1, 1)
    wal.close()
    sink = Sink()
    drain_all(jwal, jwal.WriteAheadLog(str(tmp_path / "jax"), fsync="off"), sink)
    assert [r[2] for r in sink.rows] == ["id-0001"]
    assert len(list(jwal.WriteAheadLog(str(tmp_path / "jax"),
                                       fsync="off").dead_letters())) == 1


def test_outage_keeps_order_and_the_cursor(tmp_path):
    wal = pwal.WriteAheadLog(str(tmp_path / "w"), fsync="off")
    fill("port", wal, 5)
    sink = Sink()
    sink.fail = StorageUnavailableError("spy", "down")
    drainer = pwal.WalDrainer(wal, sink.insert_batch)
    assert drainer.drain_once() == pwal.UNAVAILABLE and wal.pending_records() == 5
    sink.fail = None
    assert drainer.drain_once() == pwal.PROGRESS
    assert [r[2] for r in sink.rows] == [f"id-{i:04d}" for i in range(5)]
    assert drainer.mode() == 0 and drainer.snapshot()["mode"] == "idle"
    wal.close()


def test_pio_wal_status_replay_and_dead_letter(tmp_path, capsys):
    from predictionio_tpu_torch.cli import pio

    d = str(tmp_path / "w")
    wal = jwal.WriteAheadLog(d, fsync="off")
    fill("jax", wal, 3)
    wal.close()
    assert pio.main(["wal", "status", "--wal-dir", d, "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["depth"] == 3
    env = {"PIO_FS_BASEDIR": str(tmp_path / "store")}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        storage = Storage()
        storage.get_meta_data_apps()
        assert pio.main(["wal", "replay", "--wal-dir", d]) == 0
        assert "replay complete: 3 replayed lifetime" in capsys.readouterr().out
        assert [e.event_id for e in Storage().get_events().find(1)] == [
            f"id-{i:04d}" for i in range(3)]
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert pio.main(["wal", "dead-letter", "--wal-dir", d]) == 0
    assert "no dead-letter records" in capsys.readouterr().out
    assert pio.main(["wal", "status", "--wal-dir", str(tmp_path / "none")]) == 1


# -- kill -9 of the port's own event server ----------------------------------

def _start_server(tmp_path, env, log_name):
    log = open(tmp_path / log_name, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.pio", "eventserver",
         "--ip", "127.0.0.1", "--port", "0", "--wal-dir", str(tmp_path / "wal"),
         "--wal-policy", "write-through", "--wal-fsync", "always"],
        cwd=tmp_path, env=env, stdout=log, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        text = (tmp_path / log_name).read_text()
        found = [line for line in text.splitlines() if "listening on" in line]
        if found:
            return proc, int(found[0].rsplit(":", 1)[1])
        if proc.poll() is not None:
            raise AssertionError(text)
        time.sleep(0.05)
    proc.kill()
    raise AssertionError("event server did not start")


def _post(port, key, event):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/events.json?accessKey={key}",
        data=json.dumps(event).encode(), headers={"Content-Type": "application/json"},
        method="POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def test_kill_9_loses_no_acknowledged_event(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_") and k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), PIO_FS_BASEDIR=str(tmp_path / "store"))
    key = "killkey"
    out = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.cli.pio", "app", "new",
                          "K", "--access-key", key], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    proc, port = _start_server(tmp_path, env, "es1.log")
    acked: list[str] = []
    stop = threading.Event()

    def writer():
        n = 0
        while not stop.is_set():
            try:
                status, body = _post(port, key, {"event": "view", "entityType": "user",
                                                 "entityId": f"u{n}"})
            except (urllib.error.URLError, OSError):
                return
            assert status == 202
            acked.append(body["eventId"])
            n += 1

    t = threading.Thread(target=writer)
    t.start()
    deadline = time.monotonic() + 30
    while len(acked) < 60 and time.monotonic() < deadline:
        time.sleep(0.01)
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=10)
    stop.set()
    t.join(timeout=30)
    assert len(acked) >= 60
    proc, port = _start_server(tmp_path, env, "es2.log")
    try:
        storage = Storage({"PIO_FS_BASEDIR": str(tmp_path / "store")})
        deadline = time.monotonic() + 30
        stored: set[str] = set()
        while time.monotonic() < deadline:
            stored = {e.event_id for e in storage.get_events().find(1)}
            if stored >= set(acked):
                break
            time.sleep(0.1)
        assert set(acked) <= stored
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
