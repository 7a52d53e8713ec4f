"""SLO engine (a copy of the JAX package's ``obs/slo.py``): declarative
service-level objectives evaluated into multi-window burn-rate gauges,
plus the fleet-pressure signal.

An :class:`SLOObjective` names what "good" means — availability (non-
5xx) or latency (answered within ``threshold_ms``) — and a ``target``
fraction of good requests. The engine folds every request outcome into a
per-second ring (one lock, one list write; the clock is injectable for
deterministic tests) and, at scrape time only, evaluates

    burn_rate(window) = bad_fraction(window) / (1 - target)

the standard multi-window burn-rate construction (Google SRE workbook):
``burn == 1`` means the error budget is being spent exactly at the
sustainable rate; an alert pages when the fast window burns hot and the
slow window confirms it is not a blip.

``pio_fleet_pressure`` is the Clipper-style scaling signal derived from
the queue-wait/device-dispatch split the batcher measures:

    pressure = p95(queue_wait) / (p95(queue_wait) + p95(device_dispatch))

0 means requests never wait, → 1 means latency is queueing, not model
time (more replicas help); model-bound saturation keeps it low.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Sequence

from predictionio_tpu_torch.obs.histogram import HistogramSnapshot
from predictionio_tpu_torch.obs.registry import Collector, Metric
from predictionio_tpu_torch.utils.resilience import SYSTEM_CLOCK, Clock

AVAILABILITY = "availability"
LATENCY = "latency"


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One objective: ``target`` fraction of requests must be good."""

    name: str
    target: float                       # e.g. 0.999
    kind: str = AVAILABILITY            # AVAILABILITY | LATENCY
    #: latency objectives: good iff answered (non-5xx) within this
    threshold_ms: float = 0.0

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"SLO target must be in (0, 1), got {self.target}")
        if self.kind not in (AVAILABILITY, LATENCY):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == LATENCY and self.threshold_ms <= 0:
            raise ValueError("latency SLO needs threshold_ms > 0")

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def is_bad(self, ok: bool, latency_s: float) -> bool:
        if not ok:
            return True             # a failed request violates every SLO
        if self.kind == LATENCY:
            return latency_s * 1e3 > self.threshold_ms
        return False


#: multi-window convention: the fast window catches the incident, the
#: slow window keeps one bad minute from paging
DEFAULT_WINDOWS: tuple[tuple[str, float], ...] = (
    ("fast", 300.0), ("slow", 3600.0))


def _env_float(key: str, default: float) -> float:
    raw = os.environ.get(key)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def default_slos() -> tuple[SLOObjective, ...]:
    """The stock objectives every server ships with, read from the
    environment at server construction: ``PIO_SLO_AVAILABILITY_TARGET``
    (default 99.9%), ``PIO_SLO_LATENCY_MS`` + ``PIO_SLO_LATENCY_TARGET``
    (default 99% under 500 ms; ``PIO_SLO_LATENCY_MS=0`` drops the
    latency SLO)."""
    objectives = [SLOObjective(
        name="availability",
        target=_env_float("PIO_SLO_AVAILABILITY_TARGET", 0.999))]
    threshold = _env_float("PIO_SLO_LATENCY_MS", 500.0)
    if threshold > 0:
        objectives.append(SLOObjective(
            name=f"latency_{threshold:g}ms", kind=LATENCY,
            threshold_ms=threshold,
            target=_env_float("PIO_SLO_LATENCY_TARGET", 0.99)))
    return tuple(objectives)


def default_windows() -> tuple[tuple[str, float], ...]:
    """``PIO_SLO_FAST_WINDOW_S`` / ``PIO_SLO_SLOW_WINDOW_S`` overrides
    of :data:`DEFAULT_WINDOWS`."""
    return (
        ("fast", max(1.0, _env_float("PIO_SLO_FAST_WINDOW_S", 300.0))),
        ("slow", max(1.0, _env_float("PIO_SLO_SLOW_WINDOW_S", 3600.0))),
    )


class SLOEngine:
    """Per-second outcome ring + scrape-time burn-rate evaluation.

    One lock guards the ring at the writer (``record``, every request)
    and the reader (``burn_rates``, scrape time). A ring slot is
    ``[second, total, bad_0, ..., bad_{n-1}]`` (one bad counter per
    objective); slots recycle by ``second % len(ring)`` with the
    absolute second stored, so stale laps never leak into a window."""

    def __init__(self, objectives: Sequence[SLOObjective] | None = None,
                 windows: Sequence[tuple[str, float]] | None = None,
                 clock: Clock = SYSTEM_CLOCK):
        self.objectives = tuple(objectives if objectives is not None
                                else default_slos())
        self.windows = tuple(windows if windows is not None
                             else default_windows())
        if not self.windows:
            raise ValueError("SLOEngine needs at least one window")
        self._clock = clock
        self._lock = threading.Lock()
        horizon = int(max(seconds for _, seconds in self.windows)) + 1
        #: slot: [absolute_second, total, bad per objective...]
        self._ring: list[list[int]] = [
            [-1, 0] + [0] * len(self.objectives) for _ in range(horizon)
        ]

    # -- hot path ------------------------------------------------------------
    def record(self, ok: bool, latency_s: float) -> None:
        """Fold one request outcome in (one lock acquisition)."""
        second = int(self._clock.monotonic())
        bad = [obj.is_bad(ok, latency_s) for obj in self.objectives]
        with self._lock:
            slot = self._ring[second % len(self._ring)]
            if slot[0] != second:
                slot[0] = second
                for i in range(1, len(slot)):
                    slot[i] = 0
            slot[1] += 1
            for i, b in enumerate(bad):
                if b:
                    slot[2 + i] += 1

    # -- scrape path ---------------------------------------------------------
    def _window_counts(self, now_s: int,
                       window_s: float) -> list[tuple[int, list[int]]]:
        lo = now_s - int(window_s)
        out = []
        with self._lock:
            for slot in self._ring:
                if lo < slot[0] <= now_s:
                    out.append((slot[1], list(slot[2:])))
        return out

    def burn_rates(self) -> dict[tuple[str, str], float]:
        """``{(slo_name, window_label): burn}`` — 0.0 for an idle window
        (no traffic spends no budget)."""
        now_s = int(self._clock.monotonic())
        out: dict[tuple[str, str], float] = {}
        for label, seconds in self.windows:
            counts = self._window_counts(now_s, seconds)
            total = sum(t for t, _ in counts)
            for i, obj in enumerate(self.objectives):
                if total == 0:
                    out[(obj.name, label)] = 0.0
                    continue
                bad = sum(b[i] for _, b in counts)
                out[(obj.name, label)] = (bad / total) / obj.budget
        return out

    def max_burns(self) -> dict[str, float]:
        """``{window_label: worst burn across objectives}``: any
        objective burning hot in a window makes that window hot."""
        out: dict[str, float] = {label: 0.0 for label, _ in self.windows}
        for (_slo, window), rate in self.burn_rates().items():
            if rate > out.get(window, 0.0):
                out[window] = rate
        return out

    # -- registry adapter ----------------------------------------------------
    def collector(self) -> Collector:
        def collect() -> list[Metric]:
            burn = Metric(
                name="pio_slo_burn_rate", kind="gauge",
                help="Error-budget burn rate per SLO and window "
                     "(1 = budget spent exactly at the sustainable "
                     "rate; docs/fleet.md autoscaler contract)")
            for (slo, window), rate in sorted(self.burn_rates().items()):
                burn.samples.append(
                    ({"slo": slo, "window": window}, rate))
            target = Metric(
                name="pio_slo_target", kind="gauge",
                help="Configured good-fraction target per SLO")
            for obj in self.objectives:
                target.samples.append(({"slo": obj.name}, obj.target))
            windows = Metric(
                name="pio_slo_window_seconds", kind="gauge",
                help="Evaluation window lengths by label")
            for label, seconds in self.windows:
                windows.samples.append(({"window": label}, seconds))
            return [burn, target, windows]

        return collect


def labeled_burn_metric(engines: Sequence[tuple[dict, "SLOEngine"]],
                        name: str = "pio_slo_burn_rate",
                        help: str = "Error-budget burn rate per SLO "
                                    "and window") -> Metric:
    """Fold several SLO engines into one burn-rate family, each engine's
    samples stamped with its label set (N engines cannot each register a
    collector for the same family name)."""
    metric = Metric(name=name, kind="gauge", help=help)
    for labels, engine in engines:
        for (slo, window), rate in sorted(engine.burn_rates().items()):
            metric.samples.append(
                ({**labels, "slo": slo, "window": window}, rate))
    return metric


# ---------------------------------------------------------------------------
# fleet pressure (module docstring)
# ---------------------------------------------------------------------------

def fleet_pressure(queue_wait: HistogramSnapshot,
                   device_dispatch: HistogramSnapshot,
                   q: float = 0.95) -> float:
    """Queue share of tail latency in [0, 1]; 0.0 when idle."""
    wait = queue_wait.quantile(q) or 0.0
    device = device_dispatch.quantile(q) or 0.0
    if wait + device <= 0.0:
        return 0.0
    return wait / (wait + device)


def pressure_metric(queue_wait: HistogramSnapshot,
                    device_dispatch: HistogramSnapshot,
                    labels: dict[str, str] | None = None) -> Metric:
    return Metric(
        name="pio_fleet_pressure", kind="gauge",
        help="Queue-wait share of p95 serving latency (0 idle, ->1 "
             "queue-bound: add replicas; docs/fleet.md)",
        samples=[(dict(labels or {}),
                  fleet_pressure(queue_wait, device_dispatch))])


def serving_pressure_collector(stats) -> Collector:
    """Engine-server adapter: the pressure gauge from the ServingStats
    queue-wait / device-dispatch histograms, at scrape time."""

    def collect() -> list[Metric]:
        return [pressure_metric(stats.queue_wait.snapshot(),
                                stats.device_time.snapshot())]

    return collect
