"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the harness reads ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json`` and ``benchmark/limits/<cell>.json``,
and the traffic file names the driver (``benchmark/drivers/<driver>.py``)
that runs its window. The per-layer metrics a cell reports are the
``per_layer`` entries that list it (or list no cells), each read by
``benchmark/metrics/<metric>.py``. Adding a cell, a configuration, a mix
or a metric adds files and entries; no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

#: the benchmark's folder and the checkout's root
BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload as a run sees it."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple        # the manifest's end_to_end entries this cell reports
    per_layer: tuple         # the manifest's per_layer entries this cell reports


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest: dict | None = None, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` with its configuration, traffic and limits read."""
    manifest = manifest if manifest is not None else load_manifest(bench_dir.parent)
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    w = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _read_json(bench_dir.parent / configs[w["config"]]["file"])
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        traffic_name=w["traffic"],
        config=config,
        traffic=_read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_read_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=tuple(m for m in manifest["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in manifest["per_layer"] if _reports(m, name)),
    )


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` as a module (a metric's name may
    hold dots, so it is loaded by path, not by import name)."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    mod_name = f"benchmark_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def validate(manifest: dict) -> list[str]:
    """The manifest's faults against the names, units and sources the
    contract allows; empty when it is sound."""
    faults = []
    names: dict[str, set] = {"metric": set(), "workload": set(), "config": set()}

    def name_ok(kind: str, value: str) -> None:
        if not isinstance(value, str) or not NAME_RE.match(value):
            faults.append(f"{kind} name {value!r} breaks the name rule")

    for c in manifest.get("configs", []):
        name_ok("config", c["name"])
        if c["name"] in names["config"]:
            faults.append(f"config {c['name']!r} twice")
        names["config"].add(c["name"])
        for key in c.get("reduced", []):
            name_ok("reduced key", key)
    for w in manifest.get("workloads", []):
        name_ok("workload", w["name"])
        name_ok("config", w["config"])
        name_ok("traffic", w["traffic"])
        if w["name"] in names["workload"]:
            faults.append(f"workload {w['name']!r} twice")
        names["workload"].add(w["name"])
        if w["config"] not in names["config"]:
            faults.append(f"workload {w['name']!r} names unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            faults.append(f"workload {w['name']!r} asks for {w['chips']} chips")
    for group in ("end_to_end", "per_layer"):
        for m in manifest.get(group, []):
            name_ok("metric", m["name"])
            if m["name"] in names["metric"]:
                faults.append(f"metric {m['name']!r} twice")
            names["metric"].add(m["name"])
            if not UNIT_RE.match(m["unit"]):
                faults.append(f"metric {m['name']!r} has unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                faults.append(f"metric {m['name']!r} better={m['better']!r}")
            if m["source"] not in SOURCES:
                faults.append(f"metric {m['name']!r} source={m['source']!r}")
            for cell in m.get("workloads", []):
                if cell not in names["workload"]:
                    faults.append(f"metric {m['name']!r} lists unknown cell {cell!r}")
    return faults
