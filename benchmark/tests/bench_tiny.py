"""Tiny versions of the benchmark's cells for the CPU tests: the same
drivers, references and checks at sizes a test run holds, with the
cell's own limits. The cells are those of ``BENCHMARK.json`` and those
whose entries wait in ``benchmark/pending/`` (built, not yet measured
into the manifest)."""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import manifest as mf  # noqa: E402
from benchmark.harness.manifest import Cell  # noqa: E402
from benchmark.harness.runner import RunSpec, execute  # noqa: E402
from benchmark.harness.trace import WindowTrace  # noqa: E402

SERVE = "sessionrec-s2048.serve-b64"
TRAIN = "als-ml20m.train"


def manifest() -> dict:
    """``BENCHMARK.json`` with the entries of every pending fragment that
    it does not hold yet (a cell moved into the manifest keeps its
    fragment, which then adds nothing)."""
    merged = mf.load_manifest()
    for path in sorted((mf.BENCH_DIR / "pending").glob("*.json")):
        for group, entries in json.loads(path.read_text()).items():
            have = {x["name"] for x in merged[group]}
            merged[group] = merged[group] + [x for x in entries if x["name"] not in have]
    return merged


def load_cell(name: str) -> Cell:
    return mf.load_cell(name, manifest())


def tiny_cell(name: str) -> Cell:
    cell = load_cell(name)
    if cell.config["family"] == "seqrec":
        cfg = dict(cell.config, vocab=501, max_len=64, d_model=64, n_heads=2, n_layers=2)
        mix = dict(cell.traffic, users=64,
                   history={"length": {"dist": "log_uniform_int", "low": 4, "high": "$max_len"},
                            "items": {"dist": "power_int", "n": 500, "exponent": 1.8,
                                      "offset": 1}},
                   queries={"batch": 8, "keys": {"dist": "uniform_int", "low": 0, "high": 63}},
                   warmup_batches=1, check={"sample": 16})
    else:
        cfg = dict(cell.config, users=300, items=200, ratings=20_000, rank=8)
        mix = dict(cell.traffic, iterations=3)
    return dataclasses.replace(cell, config=cfg, traffic=mix)


def run_tiny(name: str, seed: int = 2**31 + 11, trace: bool = False,
             seconds: float = 0.3) -> dict:
    """One run of the tiny cell on the CPU, as ``run.py`` makes it but for
    the look for a card."""
    spec = RunSpec(cell=tiny_cell(name), seed=seed, seconds=seconds,
                   trace=WindowTrace(trace), device=torch.device("cpu"),
                   started=time.perf_counter())
    return execute(spec, "cpu")
