"""A configuration, a traffic mix and a per-layer metric added as new
files (and entries) in a copy of the benchmark are picked up with no
edit to a file that is there; a run's line carries the new metric."""

from __future__ import annotations

import hashlib
import json
import shutil

import bench_tiny
import pytest

from benchmark.harness import manifest as mf
from benchmark.harness.runner import Outcome, RunSpec, result_line
from benchmark.harness.trace import TraceSummary, WindowTrace


def _digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(mf.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(mf.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_config_traffic_and_metric_are_found_by_name(copy):
    bench = copy / "benchmark"
    before = _digests(copy)
    cfg = json.loads((bench / "configs" / "sessionrec-s2048.json").read_text())
    (bench / "configs" / "sessionrec-tiny.json").write_text(json.dumps(dict(cfg, n_layers=1)))
    mix = json.loads((bench / "traffic" / "serve-b64.json").read_text())
    full = {"dist": "log_uniform_int", "low": 2048, "high": 2048}
    (bench / "traffic" / "serve-full.json").write_text(json.dumps(
        dict(mix, history=dict(mix["history"], length=full))))
    (bench / "limits" / "sessionrec-tiny.serve-full.json").write_text(
        json.dumps({"rank_gap": 0.1, "malformed": 0, "failed": 0}))
    (bench / "metrics" / "window_s.serve.py").write_text(
        "def read(outcome):\n    return outcome.facts['window_s']\n")
    manifest = json.loads((copy / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "sessionrec-tiny", "source": "https://example.org",
                                "file": "benchmark/configs/sessionrec-tiny.json",
                                "reduced": ["n_layers"], "why": "test"})
    manifest["workloads"].append({"name": "sessionrec-tiny.serve-full",
                                  "config": "sessionrec-tiny", "traffic": "serve-full",
                                  "chips": 1, "why": "test"})
    manifest["per_layer"].append({"name": "window_s.serve", "unit": "s", "better": "lower",
                                  "source": "host_clock", "layer": "device",
                                  "moves": "queries_per_s",
                                  "workloads": ["sessionrec-tiny.serve-full"]})
    for m in manifest["end_to_end"]:
        if "workloads" in m and "sessionrec-s2048.serve-b64" in m["workloads"]:
            m["workloads"].append("sessionrec-tiny.serve-full")
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = _digests(copy)
    changed = [k for k in before if before[k] != after.get(k)]
    assert changed == ["BENCHMARK.json"]

    assert mf.validate(manifest) == []
    cell = mf.load_cell("sessionrec-tiny.serve-full", manifest, bench)
    assert cell.config["n_layers"] == 1
    assert cell.traffic["history"]["length"]["low"] == 2048
    assert [m["name"] for m in cell.per_layer] == ["window_s.serve"]
    assert mf.load_module("metrics", "window_s.serve", bench).read(
        Outcome(0, 0, {}, {"window_s": 2.5}, {}, 0)) == 2.5

    spec = RunSpec(cell=cell, seed=1, seconds=1.0, trace=WindowTrace(True),
                   device=bench_tiny.torch.device("cpu"), started=0.0)
    outcome = Outcome(attempted=8, failed=0, end_to_end={}, facts={"window_s": 2.5},
                      readings={"rank_gap": 0.01, "malformed": 0, "failed": 0},
                      memory_peak_bytes=1,
                      trace=TraceSummary(2.5, 1.0, 3, {"k": 1.0}, {}, []))
    import benchmark.harness.runner as runner

    original = runner.load_module
    runner.load_module = lambda kind, name: mf.load_module(kind, name, bench)
    try:
        line = result_line(spec, outcome, "cpu")
    finally:
        runner.load_module = original
    assert line["metrics"] == {"window_s.serve": {"value": 2.5, "unit": "s"}}
    assert line["correct"] is True and list(line)[-1] == "checks"
