"""One run of one cell: the driver's window, the metrics, the checks and
the result line.

A driver (``benchmark/drivers/<name>.py``) has ``run(spec) -> Outcome``:
it makes the inputs, sets up the program, warms it, measures for
``spec.seconds`` (the window inside ``with spec.trace:``), and checks what the window
produced against the plain reference. Its ``Outcome`` holds every
end-to-end value it can give, the facts that the per-layer readers
(``benchmark/metrics/<name>.py``, each ``read(outcome) -> float | None``)
reduce, and the readings that the cell's limits
(``benchmark/limits/<cell>.json``) judge.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Any

from benchmark.harness import guard
from benchmark.harness.manifest import Cell, load_module
from benchmark.harness.trace import TraceSummary, WindowTrace


def log(spec: "RunSpec", message: str) -> None:
    """A progress line on standard error, with the seconds since the
    process started; the checks' lines come after every one of them."""
    import time

    print(f"[bench {time.perf_counter() - spec.started:8.2f} s] {message}", file=sys.stderr,
          flush=True)


@dataclasses.dataclass
class RunSpec:
    cell: Cell
    seed: int
    seconds: float
    trace: WindowTrace
    device: Any                  # torch.device
    started: float               # time.perf_counter() at process start


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict             # metric name -> value
    facts: dict                  # what per-layer readers reduce
    readings: dict               # check name -> value (judged against the cell's limits)
    memory_peak_bytes: int
    trace: TraceSummary | None = None
    config: dict = dataclasses.field(default_factory=dict)
    peaks: dict = dataclasses.field(default_factory=dict)


def judge(readings: dict, limits: dict) -> list[tuple[str, float, float, bool]]:
    """(name, value, limit, passed) for every limit; a reading that is
    missing or not a number fails, and a reading with no limit is an
    error of the harness."""
    extra = set(readings) - set(limits)
    if extra:
        raise KeyError(f"readings without a limit: {sorted(extra)}")
    out = []
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        value = float(value)
        out.append((name, value, float(limit), not math.isnan(value) and value <= limit))
    return out


def result_line(spec: RunSpec, outcome: Outcome, kind: str) -> dict:
    """The contract's result object; ``checks`` comes last."""
    cell = spec.cell
    metrics = {}
    if spec.trace.enabled:
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(outcome)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
    checks = judge(outcome.readings, cell.limits)
    device = {"platform": "gpu" if spec.device.type == "cuda" else spec.device.type,
              "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {
        "correct": all(ok for _, _, _, ok in checks),
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": device,
    }
    if outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit, _ in checks}
    for name, value, limit, ok in checks:
        print(f"check {name}: {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    return line


def execute(spec: RunSpec, kind: str) -> dict:
    """Run the cell's driver, refuse a process that loaded the JAX
    package (:func:`guard.check_no_jax`), and compose the line."""
    driver = load_module("drivers", spec.cell.traffic["driver"])
    outcome = driver.run(spec)
    outcome.trace = spec.trace.summary
    guard.check_no_jax()
    return result_line(spec, outcome, kind)
