"""Device memory and FLOPs accounting (the port's counterpart of the JAX
package's ``obs/device.py``).

Three pieces:

- **Memory gauges** — ``torch.cuda.memory_stats`` rendered as
  ``pio_device_bytes_in_use`` (``allocated_bytes.all.current``),
  ``pio_device_peak_bytes_in_use`` (``allocated_bytes.all.peak``) and
  ``pio_device_bytes_limit`` (``get_device_properties().total_memory``)
  per card. They are read only when this process has already
  initialized CUDA (``torch.cuda.is_initialized()``): a ``/metrics``
  scrape must never be what initializes CUDA, or a process that forks
  workers onto the card afterwards (``pio eval --parallel``) could no
  longer fork. Nothing on this path calls ``torch.cuda.is_available``
  or ``mem_get_info``, which initialize CUDA; a process without CUDA up
  (the CPU, the torch-free event server) reports no samples — absent,
  not zero.
- **Peak-FLOPs table** — dense bf16 peaks keyed by device kind, with the
  ``PIO_DEVICE_PEAK_FLOPS`` override. The H100 SXM row is the kind
  ``torch.cuda.get_device_name()`` gives on the card, "NVIDIA H100 80GB
  HBM3", at 989e12. Any other kind (the PCIe and NVL parts included)
  reports a null MFU with the reason, never a guess.
- **TrainProfiler** — drives ``pio train --profile``: binds to the
  training trace, samples device memory as each DASE stage closes,
  bins the build recorder's compile events (``obs/compile.py``) into
  the stages, counts the train stage's executed FLOPs and writes the
  ``pio.train_report.v1`` document, plus the ``pio_train_*`` gauges.

Where the FLOPs come from: ``torch.utils.flop_counter.FlopCounterMode``
around the train stage (:func:`count_flops`, entered by
``Engine.train``), only while a profiler is active. It counts the aten
matrix products that execute — the forward recomputed under
``torch.utils.checkpoint`` and ALS's batched CG products included — and
nothing elementwise. A kernel launched through ``ctypes`` is invisible
to it, so a profiled flash-attention launch adds 4·D FLOPs per real
(query, key) pair itself (``ops/flash_attention.py``). The JAX package
prices XLA programs with ``cost_analysis()``, which also counts
elementwise work, so the two packages' totals for one run differ.

MFU is executed FLOPs over the run's wall seconds over the device's
peak; it is reported only when that is at most 1, else null with the
reason — measured honestly or not at all.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from contextvars import ContextVar
from typing import Any, Callable, Iterable, Iterator, Mapping

from predictionio_tpu_torch.obs.compile import CompileRecorder, recorder
from predictionio_tpu_torch.obs.registry import Metric

logger = logging.getLogger(__name__)

#: the TRAIN_REPORT.json schema tag (the JAX package's)
TRAIN_REPORT_SCHEMA = "pio.train_report.v1"

#: dense matmul peak FLOPs per device by device-kind substring
#: (lowercased, first match wins). The H100 SXM row is the port's card;
#: the TPU rows are the JAX package's table, kept so both packages
#: resolve a kind the same way.
PEAK_FLOPS_TABLE: tuple[tuple[str, float], ...] = (
    ("h100 80gb hbm3", 989e12),   # H100 SXM, dense bf16
    ("v6e", 918e12),
    ("v5p", 459e12),
    ("v5e", 197e12),
    ("v5 lite", 197e12),
    ("v5litepod", 197e12),
    ("v4", 275e12),
    ("v3", 123e12),
    ("v2", 45e12),
)

_PEAK_FLOPS_ENV = "PIO_DEVICE_PEAK_FLOPS"


def peak_flops_for_kind(device_kind: str) -> float | None:
    kind = device_kind.lower()
    for needle, peak in PEAK_FLOPS_TABLE:
        if needle in kind:
            return peak
    return None


def resolve_peak_flops(device_kind: str) -> tuple[float | None, str]:
    """(peak FLOPs per device, source) for ``device_kind``. The
    ``PIO_DEVICE_PEAK_FLOPS`` override wins over the table; ``source``
    is ``"env"``/``"table"`` or the reason there is none."""
    raw = os.environ.get(_PEAK_FLOPS_ENV, "").strip()
    if raw:
        try:
            value = float(raw)
            if value > 0:
                return value, "env"
            logger.warning("%s=%r is not positive; ignoring",
                           _PEAK_FLOPS_ENV, raw)
        except ValueError:
            logger.warning("%s=%r is not a number; ignoring",
                           _PEAK_FLOPS_ENV, raw)
    peak = peak_flops_for_kind(device_kind)
    if peak is not None:
        return peak, "table"
    return None, (f"no peak-FLOPs table entry for device kind "
                  f"{device_kind!r} (set {_PEAK_FLOPS_ENV})")


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------

#: (snapshot field, exported gauge, help)
_MEM_FIELDS = (
    ("bytes_in_use", "pio_device_bytes_in_use",
     "Device memory currently allocated (torch.cuda.memory_stats "
     "allocated_bytes.all.current)"),
    ("peak_bytes_in_use", "pio_device_peak_bytes_in_use",
     "Device memory high-water since process start "
     "(allocated_bytes.all.peak)"),
    ("bytes_limit", "pio_device_bytes_limit",
     "Device memory capacity (get_device_properties().total_memory)"),
)


def _cuda_up():
    """The torch module when this process has initialized CUDA, else
    None. Reads ``sys.modules`` (a process that never imported torch is
    not made to) and ``torch.cuda.is_initialized`` only."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch


def device_memory_snapshot() -> dict[str, dict[str, Any]]:
    """``{"cuda:<i>": {field: value, "device_kind": name}}`` for every
    card, or empty when this process has not initialized CUDA (see the
    module docstring)."""
    torch = _cuda_up()
    if torch is None:
        return {}
    out: dict[str, dict[str, Any]] = {}
    for idx in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(idx)
        out[f"cuda:{idx}"] = {
            "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": float(torch.cuda.get_device_properties(idx).total_memory),
            "device_kind": torch.cuda.get_device_name(idx),
        }
    return out


def device_memory_collector() -> Callable[[], Iterable[Metric]]:
    """Scrape-time device memory gauges; no samples while CUDA is not
    initialized in this process."""

    def collect() -> list[Metric]:
        snapshot = device_memory_snapshot()
        if not snapshot:
            return []
        return [
            Metric(name=name, kind="gauge", help=help_text, samples=[
                ({"device": label, "kind": str(stats["device_kind"])}, stats[field])
                for label, stats in sorted(snapshot.items())])
            for field, name, help_text in _MEM_FIELDS
        ]

    return collect


def _device_kind(device: Any) -> str:
    """The kind string of ``device`` (None: the current card): "cpu" for
    the CPU, the card's name once this process has initialized CUDA."""
    dev_type = "cuda" if device is None else str(device).split(":")[0]
    if dev_type != "cuda":
        return dev_type
    torch = _cuda_up()
    if torch is None:
        return "cuda (not initialized)"
    return torch.cuda.get_device_name(device)


# ---------------------------------------------------------------------------
# the train profiler (`pio train --profile`)
# ---------------------------------------------------------------------------

#: the last profiled train run's report, exported by
#: :func:`train_report_collector` (per process, like the recorder)
_LAST_REPORT: dict | None = None
#: the profiler whose run is in progress in this context (the training
#: thread): what :func:`count_flops` adds to
_ACTIVE: ContextVar["TrainProfiler | None"] = ContextVar("pio_train_profiler", default=None)


@contextlib.contextmanager
def count_flops() -> Iterator[None]:
    """Count the executed FLOPs of the block into the active profiler
    (``Engine.train`` wraps its train stage in this); a no-op when no
    profiler is active. Matrix products through ``FlopCounterMode``;
    flash-attention launches through the kernel wrapper's hook."""
    prof = _ACTIVE.get()
    if prof is None:
        yield
        return
    from torch.utils.flop_counter import FlopCounterMode

    from predictionio_tpu_torch.ops import flash_attention

    kernel_flops: list[int] = []
    token = flash_attention.flop_hook.set(kernel_flops.append)
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            yield
    finally:
        flash_attention.flop_hook.reset(token)
        prof._add_flops(counter.get_total_flops() + sum(kernel_flops))


class TrainProfiler:
    """Per-stage wall/compile/execute split, MFU, and device-memory
    high-water for one training run.

    Usage (what ``run_train(profiler=...)`` does)::

        profiler = TrainProfiler(profile_dir=args.profile_dir)
        profiler.begin(trace, device=ctx.device)   # before engine.train
        ...                                        # the traced run
        report = profiler.finish(trace, instance_id, status)

    ``begin`` installs a span observer on the trace that samples device
    memory as each DASE stage closes, arms :func:`count_flops`, and with
    ``profile_dir`` starts ``torch.profiler`` (a Chrome trace written
    there by ``finish``). ``finish`` is idempotent and always runs
    (``run_train`` calls it in a ``finally``), so an aborted run still
    stops the profiler."""

    #: the Chrome trace's file name inside ``profile_dir``
    TRACE_FILE = "train_trace.json"

    def __init__(self, recorder_: CompileRecorder | None = None,
                 profile_dir: str | None = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.recorder = recorder_ if recorder_ is not None else recorder()
        self.profile_dir = profile_dir
        self._clock = clock
        self._device: Any = None
        self._stage_mem: dict[str, dict[str, float]] = {}
        self._baseline_events = 0
        self._flops: float | None = None
        self._t0: float | None = None
        self._torch_profiler = None
        self._finished = False

    # -- lifecycle -----------------------------------------------------------
    def begin(self, trace: Any, device: Any = None) -> None:
        self._device = device
        self._baseline_events = len(self.recorder.events())
        if trace is not None:
            trace.observer = self._on_span
        if self.profile_dir:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if device is not None and torch.device(device).type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.profile_dir, exist_ok=True)
            self._torch_profiler = torch.profiler.profile(activities=activities)
            self._torch_profiler.start()
        _ACTIVE.set(self)
        # the wall clock starts after the capture machinery is up: the
        # profiler's start-up is not the run's
        self._t0 = self._clock()

    def _add_flops(self, flops: float) -> None:
        self._flops = (self._flops or 0.0) + float(flops)

    def _on_span(self, name: str, start_off: float, dur: float) -> None:
        # called from Trace.add_span as each stage span closes; keep the
        # per-stage max so repeated spans keep the high-water
        snapshot = device_memory_snapshot()
        if not snapshot:
            return
        peak = max(s["peak_bytes_in_use"] for s in snapshot.values())
        in_use = sum(s["bytes_in_use"] for s in snapshot.values())
        have = self._stage_mem.get(name)
        if have is None or peak >= have.get("peak_bytes_in_use", 0.0):
            self._stage_mem[name] = {"peak_bytes_in_use": peak,
                                     "bytes_in_use": in_use}

    def finish(self, trace: Any, instance_id: str = "",
               status: str = "") -> dict:
        """Stop the captures and build the TRAIN_REPORT document; also
        publishes it for :func:`train_report_collector`."""
        global _LAST_REPORT
        if _ACTIVE.get() is self:
            _ACTIVE.set(None)
        if self._torch_profiler is not None:
            prof, self._torch_profiler = self._torch_profiler, None
            prof.stop()
            prof.export_chrome_trace(os.path.join(self.profile_dir, self.TRACE_FILE))
        if self._finished:
            return _LAST_REPORT or {}
        self._finished = True
        wall = (self._clock() - self._t0) if self._t0 is not None else 0.0

        events = self.recorder.events()[self._baseline_events:]
        compile_total = sum(e[4] for e in events)
        stages = self._stage_split(trace)

        device_kind = _device_kind(self._device)
        peak_flops, peak_source = resolve_peak_flops(device_kind)
        flops_total = self._flops if self._flops else None
        mfu, mfu_reason = self._mfu(flops_total, peak_flops, peak_source, wall)

        mem = device_memory_snapshot()
        hbm_peak = max((s["peak_bytes_in_use"] for s in mem.values()), default=None)
        report = {
            "schema": TRAIN_REPORT_SCHEMA,
            "instanceId": instance_id,
            "status": status,
            "deviceKind": device_kind,
            # the port trains on one device
            "deviceCount": 1,
            "wallSeconds": round(wall, 6),
            "stages": stages,
            "compile": {
                "totalSeconds": round(compile_total, 6),
                "totalCompiles": len(events),
                "table": self.recorder.recompile_table(),
            },
            "flops": {
                "executed": flops_total,
                "peakPerChip": peak_flops,
                "peakSource": peak_source if peak_flops is not None else None,
            },
            "mfu": mfu,
            "mfuReason": mfu_reason,
            "hbm": {
                "peakBytes": hbm_peak,
                "perStage": {name: dict(vals)
                             for name, vals in self._stage_mem.items()}
                            or None,
            },
            "profileDir": self.profile_dir,
        }
        _LAST_REPORT = report
        return report

    # -- pieces --------------------------------------------------------------
    def _stage_split(self, trace: Any) -> dict[str, dict]:
        """Per-stage wall/compile/execute: wall from the trace's span
        records, compile from the recorder's events whose midpoint falls
        in the stage, execute as the remainder."""
        stages: dict[str, dict] = {}
        if trace is None:
            return stages
        t0 = trace.start_perf
        intervals: dict[str, list[tuple[float, float]]] = {}
        for name, _parent, _sid, start_off, dur in trace.spans():
            intervals.setdefault(name, []).append(
                (t0 + start_off, t0 + start_off + dur))
        for name, spans in intervals.items():
            wall = sum(e - s for s, e in spans)
            compile_s = sum(
                self.recorder.compile_seconds_between(s, e)
                for s, e in spans)
            stages[name] = {
                "wallSeconds": round(wall, 6),
                "compileSeconds": round(compile_s, 6),
                "executeSeconds": round(max(0.0, wall - compile_s), 6),
            }
        return stages

    @staticmethod
    def _mfu(flops_total: float | None, peak_flops: float | None,
             peak_source: str, wall: float) -> tuple[float | None, str]:
        if flops_total is None:
            return None, ("no matrix products were counted (the train "
                          "stage did not run under the profiler)")
        if peak_flops is None:
            return None, peak_source  # carries the no-table-entry reason
        if wall <= 0:
            return None, "zero measured wall time"
        mfu = flops_total / wall / peak_flops
        if mfu > 1.0:
            return None, (f"counted FLOPs over the wall time exceed the peak "
                          f"({mfu:.3f} of it): the count or the clock is wrong")
        return mfu, "ok"


def summarize_train_report(report: Mapping[str, Any]) -> str:
    """The one-line human summary `pio train --profile` prints."""
    compile_doc = report.get("compile", {})
    mfu = report.get("mfu")
    mfu_text = (f"{mfu * 100:.2f}%" if isinstance(mfu, (int, float))
                else f"n/a ({report.get('mfuReason', 'unknown')})")
    hbm = (report.get("hbm") or {}).get("peakBytes")
    hbm_text = (f"{hbm / (1 << 30):.2f} GiB" if hbm is not None else "n/a")
    wall = report.get("wallSeconds", 0.0)
    total_c = compile_doc.get("totalSeconds", 0.0)
    return (f"wall {wall:.2f}s | compile {total_c:.2f}s "
            f"({compile_doc.get('totalCompiles', 0)} compiles) | "
            f"execute {max(0.0, wall - total_c):.2f}s | "
            f"MFU {mfu_text} | HBM peak {hbm_text} | "
            f"device {report.get('deviceKind', '?')}"
            f" x{report.get('deviceCount', 1)}")


def train_report_collector() -> Callable[[], Iterable[Metric]]:
    """Gauges from the last profiled train run in this process —
    nothing until one ran."""

    def collect() -> list[Metric]:
        report = _LAST_REPORT
        if report is None:
            return []
        out = []
        mfu = report.get("mfu")
        if isinstance(mfu, (int, float)):
            out.append(Metric(
                name="pio_train_mfu", kind="gauge",
                help="Model FLOPs utilization of the last profiled "
                     "train run (executed FLOPs / wall / peak per chip)",
                samples=[({}, float(mfu))]))
        out.append(Metric(
            name="pio_train_compile_seconds", kind="gauge",
            help="Kernel and native library build seconds inside the "
                 "last profiled train",
            samples=[({},
                      float(report.get("compile", {})
                            .get("totalSeconds", 0.0)))]))
        per_stage = (report.get("hbm") or {}).get("perStage") or {}
        samples = [({"stage": stage},
                    float(vals.get("peak_bytes_in_use", 0.0)))
                   for stage, vals in sorted(per_stage.items())]
        if samples:
            out.append(Metric(
                name="pio_train_stage_hbm_peak_bytes", kind="gauge",
                help="Device memory high-water sampled as each DASE "
                     "stage of the last profiled train closed "
                     "(monotone across stages: allocator high-water)",
                samples=samples))
        return out

    return collect
