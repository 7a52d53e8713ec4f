"""BENCHMARK.json against the contract's names, units and sources, and
every file it leads the harness to."""

from __future__ import annotations

import json

import bench_tiny
import pytest

from benchmark.harness.manifest import (
    BENCH_DIR,
    NAME_RE,
    ROOT,
    UNIT_RE,
    load_manifest,
    load_module,
    validate,
)

MANIFEST = load_manifest()
#: with the entries that wait in ``benchmark/pending/``
MERGED = bench_tiny.manifest()
CELLS = [w["name"] for w in MERGED["workloads"]]
METRICS = [m["name"] for m in MERGED["per_layer"]]


def test_manifest_has_the_contract_keys_and_no_faults():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert validate(MANIFEST) == []
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("name,ok", [
    ("sessionrec-s2048.serve-b64", True), ("mfu.serve", True), ("_x", True),
    ("a b", False), ("a/b", False), ("a,b", False), ("é", False), ("", False),
    ("-x", False), ("x" * 65, False)])
def test_name_rule(name, ok):
    assert bool(NAME_RE.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("queries/s", True), ("%", True), ("launches/iter", True), ("ms", True),
    ("tokens per s", False), ("µs", False), ("", False), ("x" * 17, False)])
def test_unit_rule(unit, ok):
    assert bool(UNIT_RE.match(unit)) is ok


def test_faults_are_found():
    bad = json.loads(json.dumps(MANIFEST))
    bad["end_to_end"][0]["unit"] = "tokens per second"
    bad["per_layer"][0]["source"] = "guess"
    bad["workloads"].append(dict(bad["workloads"][0]))
    faults = validate(bad)
    assert len(faults) == 3, faults


def test_pending_entries_are_sound_and_new():
    assert validate(MERGED) == []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in MERGED[group]]
        assert len(names) == len(set(names)), group
    # a pending metric waits for the bound its own measured sets give
    pending = MERGED["end_to_end"][len(MANIFEST["end_to_end"]):]
    assert all("bound" not in m for m in pending)


def test_every_metric_every_cell_reports_e2e_and_setup():
    for cell in CELLS:
        c = bench_tiny.load_cell(cell)
        names = [m["name"] for m in c.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in names
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    c = bench_tiny.load_cell(cell)
    assert (BENCH_DIR / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert c.limits
    entry = next(x for x in MERGED["configs"] if x["name"] == c.config_name)
    assert (ROOT / entry["file"]).is_file()
    assert entry["file"].startswith("benchmark/")


@pytest.mark.parametrize("metric", METRICS)
def test_every_metric_has_a_reader(metric):
    assert callable(load_module("metrics", metric).read)


def test_command_names_only_files_under_paths():
    cmd = MANIFEST["command"]
    assert cmd[0] == "python3" and cmd[1] == "benchmark/run.py"
    assert all(not a.startswith("/") and ".." not in a for a in cmd)
