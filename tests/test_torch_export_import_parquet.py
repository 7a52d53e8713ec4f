"""The port's Parquet event export/import (``predictionio_tpu_torch/tools/
export_import.py``, ``pio export|import --format parquet``) against the
JAX package's on the CPU: one schema, files that cross between the two
packages in both directions, and `pio`'s messages and exit codes, with
pyarrow and without it. Skipped where pyarrow is not installed, as the
JAX package's Parquet tests are.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from datetime import datetime, timedelta, timezone
from pathlib import Path

import pytest

from predictionio_tpu.cli import pio as jpio
from predictionio_tpu.core.datamap import DataMap as JaxDataMap
from predictionio_tpu.core.event import Event as JaxEvent
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.tools import export_import as jexport
from predictionio_tpu_torch.cli import pio
from predictionio_tpu_torch.core.datamap import DataMap
from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.core.json_codec import event_to_json
from predictionio_tpu_torch.storage.registry import Storage
from predictionio_tpu_torch.tools import export_import as pexport

REPO = Path(__file__).resolve().parent.parent
T0 = datetime(2024, 3, 1, tzinfo=timezone.utc)
MEMORY = {"PIO_STORAGE_SOURCES_M_TYPE": "memory",
          **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "M"
             for r in ("METADATA", "EVENTDATA", "MODELDATA")}}


@pytest.fixture
def pyarrow():
    return pytest.importorskip("pyarrow", reason="pyarrow not installed (optional extra: "
                                                 "predictionio-tpu[parquet])")


def _events(event_cls, datamap_cls, n=1203):
    """Past two batches of 500: rates with properties, buys without,
    `$set`s with nested properties and no target, tags, prIds, fixed ids
    and creation times, sub-millisecond event times."""
    out = []
    for i in range(n):
        kind = ("rate", "buy", "$set")[i % 3]
        out.append(event_cls(
            event=kind, entity_type="user", entity_id=f"u{i % 37}",
            target_entity_type=None if kind == "$set" else "item",
            target_entity_id=None if kind == "$set" else f"i{i % 101}",
            properties=datamap_cls({"rating": float(i % 5) + 0.5} if kind == "rate" else
                                   {"n": i, "nested": {"a": [i, "x"]}} if kind == "$set" else {}),
            event_time=T0 + timedelta(seconds=i, microseconds=i % 1000),
            tags=("a", f"t{i % 4}") if i % 7 == 0 else (),
            pr_id=f"pr{i}" if i % 11 == 0 else None,
            event_id=f"ev{i:05d}", creation_time=T0 + timedelta(days=1, seconds=i)))
    return out


def _wire(events) -> list[str]:
    """The events as sorted API JSON lines (the wire keeps milliseconds)."""
    return sorted(json.dumps(event_to_json(e), sort_keys=True) for e in events)


@pytest.mark.parametrize("exporter", ["jax", "port"])
def test_file_imports_into_the_other_package(pyarrow, tmp_path, exporter):
    """A file one package exports, the other imports to events equal on
    the wire, field for field (ids, tags, prIds, JSON properties, times)."""
    jax_store, port_store = JaxStorage(MEMORY), Storage(MEMORY)
    path = str(tmp_path / "events.parquet")
    if exporter == "jax":
        jax_store.get_events().insert_batch(_events(JaxEvent, JaxDataMap), 1)
        assert jexport.export_events_parquet(jax_store, 1, path) == 1203
        assert pexport.import_events_parquet(port_store, 2, path) == 1203
        src = jax_store.get_events().find(1)
        dst = port_store.get_events().find(2)
    else:
        port_store.get_events().insert_batch(_events(Event, DataMap), 1)
        assert pexport.export_events_parquet(port_store, 1, path) == 1203
        assert jexport.import_events_parquet(jax_store, 2, path) == 1203
        src = port_store.get_events().find(1)
        dst = jax_store.get_events().find(2)
    src, dst = _wire(src), _wire(dst)
    assert src == dst and len(dst) == 1203


def test_both_packages_write_the_same_table(pyarrow, tmp_path):
    """The same events exported by each package read back as equal
    Parquet tables, schema included, in row groups of 500."""
    import pyarrow.parquet as pq

    jax_store, port_store = JaxStorage(MEMORY), Storage(MEMORY)
    jax_store.get_events().insert_batch(_events(JaxEvent, JaxDataMap), 1)
    port_store.get_events().insert_batch(_events(Event, DataMap), 1)
    jexport.export_events_parquet(jax_store, 1, str(tmp_path / "jax.parquet"))
    pexport.export_events_parquet(port_store, 1, str(tmp_path / "port.parquet"))
    want, got = (pq.ParquetFile(str(tmp_path / f"{n}.parquet")) for n in ("jax", "port"))
    assert got.schema_arrow.equals(want.schema_arrow)
    assert got.read().equals(want.read())
    assert [got.metadata.row_group(g).num_rows for g in range(got.num_row_groups)] == \
        [500, 500, 203]


def test_schema_equals_jax(pyarrow):
    assert pexport._PARQUET_FIELDS == jexport._PARQUET_FIELDS
    assert pexport._parquet_schema().equals(jexport._parquet_schema())


def test_a_file_that_is_not_parquet_is_a_format_error(pyarrow, tmp_path):
    path = tmp_path / "events.parquet"
    path.write_text('{"event": "rate"}\n')
    with pytest.raises(pexport.ImportFormatError, match="not a parquet file") as got:
        pexport.import_events_parquet(Storage(MEMORY), 1, str(path))
    with pytest.raises(jexport.ImportFormatError) as want:
        jexport.import_events_parquet(JaxStorage(MEMORY), 1, str(path))
    assert str(got.value) == str(want.value) and got.value.imported == 0


def test_a_row_that_is_not_an_event_reports_its_number(pyarrow, tmp_path):
    """Rows of the second batch fail: the first 500 are in, as in JAX."""
    import pyarrow.parquet as pq

    rows = [{f: None for f in pexport._PARQUET_FIELDS} for _ in range(600)]
    for i, row in enumerate(rows):
        row.update(event="view", entityType="user", entityId=f"u{i}",
                   eventTime="2024-03-01T00:00:00.000Z", properties="{}")
    rows[520]["properties"] = "{not json"
    path = str(tmp_path / "bad.parquet")
    pq.write_table(pyarrow.Table.from_pylist(rows, schema=pexport._parquet_schema()), path)
    with pytest.raises(pexport.ImportFormatError) as got:
        pexport.import_events_parquet(Storage(MEMORY), 1, path)
    with pytest.raises(jexport.ImportFormatError) as want:
        jexport.import_events_parquet(JaxStorage(MEMORY), 1, path)
    assert str(got.value) == str(want.value)
    assert (got.value.line_no, got.value.imported) == (521, 500)


def _cli(module: str, base: Path, *args: str) -> tuple[int, str]:
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env.update(PIO_FS_BASEDIR=str(base / "store"),
               PYTHONPATH=os.pathsep.join([str(REPO)] + [p for p in
                                                          [env.get("PYTHONPATH")] if p]))
    p = subprocess.run([sys.executable, "-m", module, *args], cwd=base, env=env,
                       capture_output=True, text=True, timeout=120)
    return p.returncode, re.sub(r"[A-Za-z0-9_-]{64}", "<key>", p.stdout)


def test_pio_parquet_round_trip_equals_jax(pyarrow, tmp_path):
    """`pio import` (JSON lines) → `export --format parquet` → `app new` →
    `import` of the .parquet (the default by its suffix) → `export` (JSON
    lines), each a process of each package over its own sqlite store:
    equal exit codes and messages, and the round trip gives back the
    events it started from."""
    docs = [event_to_json(e) for e in _events(Event, DataMap, n=640)]
    steps = [("app", "new", "Src"),
             ("import", "--appid", "1", "--input", "../events.jsonl"),
             ("export", "--appid", "1", "--output", "out.parquet", "--format", "parquet"),
             ("app", "new", "Dst"),
             ("import", "--appid", "2", "--input", "out.parquet"),
             ("export", "--appid", "2", "--output", "back.jsonl"),
             ("export", "--appid", "1", "--output", "src.jsonl", "--format", "json")]
    (tmp_path / "events.jsonl").write_text("".join(json.dumps(d) + "\n" for d in docs))
    outs = {}
    for name, module in (("port", "predictionio_tpu_torch.cli.pio"),
                         ("jax", "predictionio_tpu.cli.pio")):
        (tmp_path / name).mkdir()
        outs[name] = [_cli(module, tmp_path / name, *args) for args in steps]
    assert outs["port"] == outs["jax"]
    assert [rc for rc, _ in outs["port"]] == [0] * len(steps)
    assert "Exported 640 events to out.parquet" in outs["port"][2][1]
    assert "Imported 640 events from out.parquet" in outs["port"][4][1]
    for name in ("port", "jax"):
        back = sorted((tmp_path / name / "back.jsonl").read_text().splitlines())
        assert back == sorted((tmp_path / name / "src.jsonl").read_text().splitlines())
        assert len(back) == 640
    assert (tmp_path / "port" / "back.jsonl").read_text().count("\n") == 640


@pytest.fixture
def both(tmp_path, monkeypatch):
    """One argument list through the port's and the JAX package's `pio`
    main, each over its own fresh sqlite store: (rc, out) pairs."""
    monkeypatch.chdir(tmp_path)

    def run(capsys, *args):
        results = []
        for name, main in (("port", pio.main), ("jax", jpio.main)):
            monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / name))
            JaxStorage.reset_default()
            rc = main(list(args))
            results.append((rc, re.sub(r"[A-Za-z0-9_-]{64}", "<key>",
                                       capsys.readouterr().out)))
        JaxStorage.reset_default()
        return results

    yield run


@pytest.mark.parametrize("args", [
    ("export", "--appid", "9", "--output", "x.parquet", "--format", "parquet"),
    ("export", "--appid", "1", "--output", "x.parquet", "--format", "parquet",
     "--channel", "web"),
    ("import", "--appid", "1", "--input", "missing.parquet"),
    ("import", "--appid", "1", "--input", "events.jsonl", "--format", "parquet"),
    ("import", "--appid", "1", "--input", "not_parquet.parquet"),
    ("import", "--appid", "1", "--input", "not_parquet.parquet", "--format", "json"),
    ("export", "--appid", "1", "--output", "x.parquet", "--format", "parquet"),
], ids=["unknown_app", "unknown_channel", "missing_file", "json_as_parquet",
        "suffix_not_parquet", "format_json_over_suffix", "empty_app"])
def test_messages_and_exit_codes_equal_jax(pyarrow, both, capsys, tmp_path, args):
    (tmp_path / "events.jsonl").write_text(
        '{"event": "v", "entityType": "user", "entityId": "u"}\n')
    (tmp_path / "not_parquet.parquet").write_text("not json\n")
    both(capsys, "app", "new", "A")
    port, jax = both(capsys, *args)
    assert port == jax
    assert port[0] == (0 if args[-1] == "parquet" and "9" not in args
                       and "--channel" not in args and args[0] == "export" else 1)


def test_format_choices_are_checked(both, capsys):
    for args in (("export", "--appid", "1", "--output", "x", "--format", "csv"),
                 ("import", "--appid", "1", "--input", "x", "--format", "csv")):
        with pytest.raises(SystemExit) as got:
            pio.main(list(args))
        with pytest.raises(SystemExit) as want:
            jpio.main(list(args))
        assert got.value.code == want.value.code == 2
        capsys.readouterr()


@pytest.mark.parametrize("args", [
    ("export", "--appid", "1", "--output", "x.parquet", "--format", "parquet"),
    ("import", "--appid", "1", "--input", "events.parquet"),
    ("import", "--appid", "1", "--input", "events.jsonl", "--format", "parquet"),
], ids=["export", "import_by_suffix", "import_by_flag"])
def test_without_pyarrow_both_say_it_is_required(both, capsys, monkeypatch, tmp_path, args):
    """An import of pyarrow that fails (monkeypatched): JAX's "requires
    pyarrow" message and exit code 1 from both packages' `pio`; the JSON
    format is untouched."""
    (tmp_path / "events.parquet").write_bytes(b"PAR1")
    (tmp_path / "events.jsonl").write_text(
        '{"event": "v", "entityType": "user", "entityId": "u"}\n')
    both(capsys, "app", "new", "A")
    for name in ("pyarrow", "pyarrow.parquet"):
        monkeypatch.setitem(sys.modules, name, None)
    port, jax = both(capsys, *args)
    assert port == jax
    assert port == (1, "[ERROR] Parquet support requires pyarrow "
                       "(pip install 'predictionio-tpu[parquet]').\n")
    port, jax = both(capsys, "import", "--appid", "1", "--input", "events.jsonl")
    assert port == jax and port[0] == 0
