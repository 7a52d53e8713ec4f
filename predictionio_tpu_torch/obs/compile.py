"""The build sentinel: what the port compiles at run time, counted the
way the JAX package's ``obs/compile.py`` counts XLA compiles, under the
same metric names, so one dashboard reads both packages.

What counts as a compile here. The port runs eager torch: a new input
shape costs an eager function nothing, so new signatures are not counted
(that number would be false). What the port does compile at run time is
a library:

- the ``nvcc`` build of a CUDA kernel library (``ops/_build.py``,
  ``csrc/<name>.cu`` into ``build/kernels/``);
- the ``g++`` build of a native host library (``native/__init__.py``,
  ``native/<name>.cc`` into ``build/native/``).

Each build is one compile event: the library's name as ``fn``, the
build's seconds, and the source file as ``signature``. A library loaded
from ``build/kernels/`` or ``build/native/`` was built before and is not
a compile. A build that fires after :meth:`CompileRecorder.mark_warmup_complete`
(the engine server marks it when it answers its first query) counts in
``pio_serving_recompile_total``, with a WARN and a ``kernel_build`` span
on the ambient trace: a live request paid for the build — in practice
the first query to reach a kernel that nothing built before the server
came up.

Families: ``pio_jit_compiles_total{fn}``, ``pio_jit_compile_seconds_total``
and ``pio_serving_recompile_total`` (the JAX package's names). The
recorder is plain Python with an injectable clock and imports no torch.
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterable

from predictionio_tpu_torch.obs.registry import Metric

logger = logging.getLogger(__name__)

#: bounded compile-event history — enough for any run's per-stage
#: binning, never an unbounded list on a long-lived server
_MAX_EVENTS = 1024


class CompileRecorder:
    """Thread-safe ledger of compiles: per-function counts, the
    per-(function, signature) table, cumulative compile seconds, and the
    post-warmup serving-recompile counter.

    ``clock`` is injectable (``time.perf_counter`` in production, a
    ManualClock in tests) and only stamps event times — the durations
    are measured by the caller and passed in."""

    def __init__(self, clock: Any = time.perf_counter):
        self._lock = threading.Lock()
        # either a bare callable (time.perf_counter) or the repo's
        # Clock protocol (utils/resilience: .monotonic())
        self._clock = (clock.monotonic
                       if hasattr(clock, "monotonic") and not callable(clock)
                       else clock)
        self._compiles: dict[str, int] = {}
        self._seconds: dict[str, float] = {}
        #: (fn, signature) -> compile count
        self._signatures: dict[tuple[str, str], int] = {}
        #: recent compile events: (fn, sig, start, end, seconds) — the
        #: train profiler bins them into the DASE stages
        self._events: list[tuple[str, str, float, float, float]] = []
        self._serving_recompiles = 0
        self._warmup_done = False

    # -- recording -----------------------------------------------------------
    def record_compile(self, fn: str, signature: str, seconds: float,
                       start: float | None = None,
                       end: float | None = None) -> bool:
        """Count one compile. Returns True when it fired post-warmup (a
        serving recompile); the caller owns the WARN/span side effects
        (:func:`record_build` does both)."""
        if end is None:
            end = self._clock()
        if start is None:
            start = end - seconds
        with self._lock:
            self._compiles[fn] = self._compiles.get(fn, 0) + 1
            self._seconds[fn] = self._seconds.get(fn, 0.0) + seconds
            key = (fn, signature)
            self._signatures[key] = self._signatures.get(key, 0) + 1
            if len(self._events) < _MAX_EVENTS:
                self._events.append((fn, signature, start, end, seconds))
            post_warmup = self._warmup_done
            if post_warmup:
                self._serving_recompiles += 1
        return post_warmup

    def note_serving_recompile(self, fn: str, signature: str,
                               seconds: float) -> None:
        """The operator-facing side of a post-warmup build: the WARN
        that turns a silent latency cliff into a searchable incident."""
        logger.warning(
            "serving recompile: %s built from %s (%.3fs) AFTER warmup — a "
            "live request paid this build. Build the kernels before the "
            "server takes traffic (ops/_build.build_all).",
            fn, signature, seconds)

    # -- warmup --------------------------------------------------------------
    def mark_warmup_complete(self) -> None:
        with self._lock:
            self._warmup_done = True

    @property
    def warmup_complete(self) -> bool:
        with self._lock:
            return self._warmup_done

    def reset(self) -> None:
        """Back to the just-constructed state (tests). The process-global
        recorder outlives servers, so tests reset instead of
        re-importing."""
        with self._lock:
            self._compiles.clear()
            self._seconds.clear()
            self._signatures.clear()
            self._events.clear()
            self._serving_recompiles = 0
            self._warmup_done = False

    # -- views ---------------------------------------------------------------
    def totals(self) -> tuple[int, float, int]:
        """(compiles, compile_seconds, serving_recompiles)."""
        with self._lock:
            return (sum(self._compiles.values()),
                    sum(self._seconds.values()),
                    self._serving_recompiles)

    def compiles_by_fn(self) -> dict[str, int]:
        with self._lock:
            return dict(self._compiles)

    def seconds_by_fn(self) -> dict[str, float]:
        with self._lock:
            return dict(self._seconds)

    def recompile_table(self) -> list[dict]:
        """One row per (function, signature): the TRAIN_REPORT /
        /stats.json table."""
        with self._lock:
            sig_counts = dict(self._signatures)
        return [{"fn": fn, "signature": sig, "compiles": n}
                for (fn, sig), n in sorted(sig_counts.items())]

    def events(self) -> list[tuple[str, str, float, float, float]]:
        with self._lock:
            return list(self._events)

    def compile_seconds_between(self, start: float, end: float) -> float:
        """Compile seconds whose event midpoint falls in [start, end) —
        the profiler's per-stage binning (clock values from the clock the
        recorder stamps with)."""
        total = 0.0
        for _, _, s, e, secs in self.events():
            mid = (s + e) / 2.0
            if start <= mid < end:
                total += secs
        return total

    def stats_doc(self) -> dict:
        """The /stats.json 'compile' section."""
        compiles, seconds, recompiles = self.totals()
        return {
            "compiles": compiles,
            "compileSeconds": round(seconds, 6),
            "servingRecompiles": recompiles,
            "warmupComplete": self.warmup_complete,
            "byFunction": self.compiles_by_fn(),
        }


#: the process-global recorder every build reports to (per process, like
#: the libraries it observes)
_GLOBAL_RECORDER = CompileRecorder()


def recorder() -> CompileRecorder:
    return _GLOBAL_RECORDER


def mark_warmup_complete() -> None:
    """Mark serving warmup done on the process-global recorder."""
    _GLOBAL_RECORDER.mark_warmup_complete()


def stats_doc() -> dict:
    """The process-global recorder's ``/stats.json`` ``compile`` block."""
    return _GLOBAL_RECORDER.stats_doc()


#: the repository root: build sources are named relative to it
_REPO = Path(__file__).resolve().parent.parent.parent


def record_build(fn: str, source: Path, start: float, end: float) -> None:
    """One build of library ``fn`` from ``source`` that ran from
    ``start`` to ``end`` (``time.perf_counter`` values): counted on the
    global recorder, the source named relative to the repository, and
    after warmup also WARNed and recorded as a ``kernel_build`` span on
    the ambient trace."""
    source = str(source.relative_to(_REPO) if source.is_relative_to(_REPO) else source)
    seconds = max(0.0, end - start)
    if _GLOBAL_RECORDER.record_compile(fn, source, seconds, start=start, end=end):
        _GLOBAL_RECORDER.note_serving_recompile(fn, source, seconds)
        from predictionio_tpu_torch.obs.trace import active_trace

        trace = active_trace()
        if trace is not None:
            trace.add_span("kernel_build", start, end)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def compile_metrics_collector(
        rec: CompileRecorder | None = None) -> Callable[[], Iterable[Metric]]:
    """Scrape-time collector for the sentinel's families. The aggregate
    counters are always present (zero on an idle server); the
    per-function family appears with its first sample."""

    def collect() -> list[Metric]:
        r = rec if rec is not None else _GLOBAL_RECORDER
        compiles, seconds, recompiles = r.totals()
        out = [
            Metric(
                name="pio_jit_compile_seconds_total", kind="counter",
                help="Cumulative seconds spent building kernel and "
                     "native libraries (nvcc, g++) at run time",
                samples=[({}, seconds)],
            ),
            Metric(
                name="pio_serving_recompile_total", kind="counter",
                help="Library builds that fired AFTER serving warmup — "
                     "each one was a live request paying a build",
                samples=[({}, float(recompiles))],
            ),
        ]
        by_fn = r.compiles_by_fn()
        if by_fn:
            out.append(Metric(
                name="pio_jit_compiles_total", kind="counter",
                help="Run-time builds per kernel or native library",
                samples=[({"fn": fn}, float(n))
                         for fn, n in sorted(by_fn.items())],
            ))
        return out

    return collect
