"""The metric registry (a copy of the JAX package's ``obs/registry.py``):
one per server, composed of scrape-time collectors that adopt the
counters the servers already keep — ``api/stats.ServingStats``,
``IngestStats``, the resilience registry (``utils/resilience.py``) —
instead of duplicating bookkeeping on the hot path. A collector is any
callable returning :class:`Metric` families; it runs only when
``GET /metrics`` is scraped, so the steady-state cost of the registry is
zero.

Per server, not process-global: ServingStats and IngestStats belong to
one service, and two servers in one process (the tests, the feedback
loop's engine and event servers) must not collide in one namespace. The
resilience counters are process-global and appear on every server's
registry.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Iterable, Mapping, Sequence

from predictionio_tpu_torch.obs.histogram import HistogramSnapshot, LatencyHistogram

@dataclasses.dataclass
class Metric:
    """One metric family: name, type, help, and its samples. Counter
    and gauge families carry ``samples``; histogram families carry
    ``histograms`` (label set -> snapshot)."""

    name: str
    kind: str  # "counter" | "gauge" | "histogram"
    help: str
    samples: list[tuple[dict[str, str], float]] = dataclasses.field(
        default_factory=list)
    histograms: list[tuple[dict[str, str], HistogramSnapshot]] = \
        dataclasses.field(default_factory=list)


Collector = Callable[[], Iterable[Metric]]


class MetricRegistry:
    """Scrape-time composition of collectors (module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._collectors: list[Collector] = []

    def register(self, collector: Collector) -> None:
        with self._lock:
            self._collectors.append(collector)

    def collect(self) -> list[Metric]:
        """All families from all collectors, same-name families merged
        (a kind mismatch on one name fails loud on the scrape path)."""
        with self._lock:
            collectors = list(self._collectors)
        out: list[Metric] = []
        for collector in collectors:
            out.extend(collector())
        return merge_families(out)


def merge_families(metrics: Sequence[Metric]) -> list[Metric]:
    """Merge same-name families into one (duplicate HELP/TYPE blocks
    are invalid exposition), failing loud on a kind mismatch. Input
    families are never mutated — the first occurrence is copied."""
    by_name: dict[str, Metric] = {}
    for metric in metrics:
        have = by_name.get(metric.name)
        if have is None:
            by_name[metric.name] = dataclasses.replace(
                metric,
                samples=list(metric.samples),
                histograms=list(metric.histograms),
            )
            continue
        if have.kind != metric.kind:
            raise ValueError(
                f"metric {metric.name!r} registered as both "
                f"{have.kind!r} and {metric.kind!r}")
        have.samples.extend(metric.samples)
        have.histograms.extend(metric.histograms)
    return list(by_name.values())


class HistogramFamily:
    """A labeled family of LatencyHistograms with a fixed label-value
    set built up front — the hot path never allocates a histogram, and
    an unexpected label value falls into ``other`` instead of growing
    the family without bound (a scrape-cardinality guard)."""

    FALLBACK = "other"

    def __init__(self, name: str, help: str, label: str, values: Sequence[str]):
        self.name = name
        self.help = help
        self.label = label
        values = [*values] + ([self.FALLBACK]
                              if self.FALLBACK not in values else [])
        self._hists: dict[str, LatencyHistogram] = {v: LatencyHistogram() for v in values}

    def observe(self, value: str, seconds: float) -> None:
        hist = self._hists.get(value)
        if hist is None:
            hist = self._hists[self.FALLBACK]
        hist.observe(seconds)

    def get(self, value: str) -> LatencyHistogram:
        """The label's histogram, or the fallback label's."""
        return self._hists.get(value) or self._hists[self.FALLBACK]

    def collect(self) -> list[Metric]:
        return [Metric(
            name=self.name, kind="histogram", help=self.help,
            histograms=[
                ({self.label: value}, hist.snapshot())
                for value, hist in self._hists.items()
            ],
        )]


def counts_to_snapshot(counts: Mapping[int, int]) -> HistogramSnapshot:
    """A Prometheus-histogram view of an exact-value count table (the
    batch-size histograms ServingStats/IngestStats keep): bounds are
    the observed sizes, the sum is the total of size×count."""
    sizes = sorted(counts)
    cumulative: list[int] = []
    running = 0
    total = 0.0
    for size in sizes:
        running += counts[size]
        cumulative.append(running)
        total += size * counts[size]
    return HistogramSnapshot(
        bounds=tuple(float(s) for s in sizes) or (1.0,),
        cumulative=tuple(cumulative + [running]) if sizes else (0, 0),
        sum=total,
        count=running,
    )


# ---------------------------------------------------------------------------
# adapters over the existing stats objects (duck-typed: no api/ import,
# so obs/ stays importable below the serving layer, and without torch)
# ---------------------------------------------------------------------------

def serving_collector(stats: Any) -> Collector:
    """Adopt an ``api/stats.ServingStats``: hot-path counters, the
    dispatched batch-size histogram, and the queue-wait /
    device-dispatch latency histograms the batcher feeds."""

    def collect() -> list[Metric]:
        counts = stats.raw_counts()
        out = [
            Metric(
                name=f"pio_serving_{field}_total", kind="counter",
                help=f"ServingStats counter {field!r} (api/stats.py)",
                samples=[({}, float(value))],
            )
            for field, value in counts.items()
        ]
        out.append(Metric(
            name="pio_serving_batch_size", kind="histogram",
            help="Dispatched (post-dedup) batch sizes",
            histograms=[({}, counts_to_snapshot(stats.batch_histogram()))],
        ))
        ann_hist = stats.ann_histogram()
        if ann_hist:
            # present only once ANN retrieval has served a query — a
            # brute-force deployment's exposition stays unchanged
            out.append(Metric(
                name="pio_serving_ann_shortlist_size", kind="histogram",
                help="ANN shortlist widths exact-rescored per query "
                     "(candidate columns incl. pad; ops/ann)",
                histograms=[({}, counts_to_snapshot(ann_hist))],
            ))
        out.append(Metric(
            name="pio_serving_queue_wait_seconds", kind="histogram",
            help="Per-query wait from enqueue to device dispatch "
                 "(the batcher's queue component of serving latency)",
            histograms=[({}, stats.queue_wait.snapshot())],
        ))
        out.append(Metric(
            name="pio_serving_device_dispatch_seconds", kind="histogram",
            help="Per-batch device dispatch time (query_batch walltime)",
            histograms=[({}, stats.device_time.snapshot())],
        ))
        return out

    return collect


def ingest_collector(stats: Any) -> Collector:
    """Adopt an ``api/stats.IngestStats``: batch/event totals, the
    inserted batch-size histogram, storage insert latency, and both rate
    estimates (windowed + EWMA)."""

    def collect() -> list[Metric]:
        batches, events = stats.totals()
        ewma, windowed, window_s = stats.rates()
        out = [
            Metric(
                name="pio_ingest_batches_total", kind="counter",
                help="Successful storage insert calls (1 event or many)",
                samples=[({}, float(batches))],
            ),
            Metric(
                name="pio_ingest_events_total", kind="counter",
                help="Events successfully inserted",
                samples=[({}, float(events))],
            ),
            Metric(
                name="pio_ingest_batch_size", kind="histogram",
                help="Inserted batch sizes (1 = single-event posts)",
                histograms=[({}, counts_to_snapshot(stats.batch_histogram()))],
            ),
            Metric(
                name="pio_ingest_insert_seconds", kind="histogram",
                help="Storage insert/insert_batch walltime per call",
                histograms=[({}, stats.insert_latency.snapshot())],
            ),
        ]
        if windowed is not None:
            # HELP must be stable scrape-to-scrape metadata — the
            # current window length is itself a sample, not help text
            out.append(Metric(
                name="pio_ingest_events_per_sec_windowed", kind="gauge",
                help="True windowed ingest rate over the trailing "
                     "complete seconds (see pio_ingest_window_seconds)",
                samples=[({}, windowed)],
            ))
            out.append(Metric(
                name="pio_ingest_window_seconds", kind="gauge",
                help="Complete seconds covered by the windowed rate",
                samples=[({}, float(window_s))],
            ))
        if ewma is not None:
            out.append(Metric(
                name="pio_ingest_events_per_sec_ewma", kind="gauge",
                help="EWMA of instantaneous batch rate (observability "
                     "signal; closed-loop caveat in api/stats.py)",
                samples=[({}, ewma)],
            ))
        return out

    return collect


def wal_collector(wal: Any, drainer: Any) -> Collector:
    """Adopt a ``data/wal.WriteAheadLog`` and its drainer: journal depth
    and disk footprint, the ride-through mode gauge, and the lifetime
    journal/replay/dead-letter counters."""

    def collect() -> list[Metric]:
        c = wal.counters()
        gauges = (
            ("pio_ingest_wal_depth",
             "Journaled events awaiting replay into storage",
             float(c["depth"])),
            ("pio_ingest_wal_bytes",
             "Pending journal bytes on disk (budget: wal_max_bytes)",
             float(c["bytes"])),
            ("pio_ingest_wal_mode",
             "Durable-ingest mode: 0 idle (direct inserts), 1 draining "
             "(ride-through backlog replaying), 2 backpressure "
             "(journal at disk budget; ingest shedding 503s)",
             float(drainer.mode())),
        )
        counters = (
            ("pio_ingest_wal_journaled_total",
             "Events appended to the write-ahead journal",
             float(c["journaledTotal"])),
            ("pio_ingest_wal_replayed_total",
             "Journaled events successfully replayed into storage",
             float(c["replayedTotal"])),
            ("pio_ingest_wal_dead_letter_total",
             "Records quarantined to the dead-letter series",
             float(c["deadLetterTotal"])),
            ("pio_ingest_wal_corrupt_total",
             "CRC-corrupt journal records skipped at recovery",
             float(c["corruptRecords"])),
        )
        return [
            *(Metric(name=n, kind="gauge", help=h, samples=[({}, v)])
              for n, h, v in gauges),
            *(Metric(name=n, kind="counter", help=h, samples=[({}, v)])
              for n, h, v in counters),
        ]

    return collect


def online_collector(svc: Any) -> Collector:
    """Adopt an ``online/service.OnlineFoldIn``: the freshness plane's
    operator view — event→serving lag, fold throughput counters, and
    overlay occupancy."""

    def collect() -> list[Metric]:
        m = svc.metrics()
        out = [
            Metric(
                name="pio_online_folded_events_total", kind="counter",
                help="Events folded into the deployed model between "
                     "retrains (online/service.py)",
                samples=[({}, float(m["foldedEventsTotal"]))],
            ),
            Metric(
                name="pio_online_fold_cycles_total", kind="counter",
                help="Completed fold-in cycles (tail→solve→publish)",
                samples=[({}, float(m["foldCycles"]))],
            ),
            Metric(
                name="pio_online_fenced_total", kind="counter",
                help="Deltas discarded by the model-generation fence "
                     "(computed pre-/reload, never applied)",
                samples=[({}, float(m["fenced"]))],
            ),
            Metric(
                name="pio_online_overlay_evictions_total", kind="counter",
                help="Overlay LRU evictions (user falls back to the "
                     "base vector; grow PIO_ONLINE_OVERLAY_MAX if "
                     "this churns)",
                samples=[({}, float(m["evictions"]))],
            ),
            Metric(
                name="pio_online_overlay_size", kind="gauge",
                help="Live overlay entries (folded users + delta items)",
                samples=[({}, float(m["overlaySize"]))],
            ),
            Metric(
                name="pio_online_enabled", kind="gauge",
                help="1 when the fold-in loop is running (0: --online "
                     "requested but the deployment cannot fold in)",
                samples=[({}, 1.0 if m["enabled"] else 0.0)],
            ),
        ]
        if m["lagSeconds"] is not None:
            # absent until the first fold: a gauge of "no data" must
            # not masquerade as zero lag
            out.append(Metric(
                name="pio_online_freshness_lag_seconds", kind="gauge",
                help="Event time → applied-to-serving time of the "
                     "latest fold-in cycle (worst event in the batch)",
                samples=[({}, float(m["lagSeconds"]))],
            ))
        return out

    return collect


#: breaker state encoding for the gauge (strings are not a sample value)
_BREAKER_STATES = {"closed": 0.0, "half-open": 1.0, "half_open": 1.0,
                   "open": 2.0}


def resilience_collector() -> Collector:
    """Adopt the process-global resilience registry
    (``utils/resilience.registry_snapshot``): per-policy counters as
    ``pio_resilience_<field>_total{policy}``, and for each policy with a
    circuit breaker (the router's per-replica ``Resilience``) its state
    (``pio_resilience_breaker_state``: 0 closed, 1 half-open, 2 open) and
    open transitions (``pio_resilience_breaker_opens_total``)."""

    def collect() -> list[Metric]:
        # deferred import: obs/ stays importable below the utils layer
        from predictionio_tpu_torch.utils.resilience import registry_snapshot

        counters: dict[str, Metric] = {}
        state = Metric(
            name="pio_resilience_breaker_state", kind="gauge",
            help="Circuit breaker state: 0 closed, 1 half-open, 2 open")
        opens = Metric(
            name="pio_resilience_breaker_opens_total", kind="counter",
            help="Circuit breaker open transitions")
        for policy, snap in registry_snapshot().items():
            labels = {"policy": policy}
            for field, value in snap.items():
                if field == "breaker":
                    code = _BREAKER_STATES.get(str(value.get("state")))
                    if code is not None:
                        state.samples.append((labels, code))
                    opens.samples.append(
                        (labels, float(value.get("opens", 0))))
                    continue
                if not isinstance(value, (int, float)):
                    continue
                name = f"pio_resilience_{field}_total"
                fam = counters.setdefault(name, Metric(
                    name=name, kind="counter",
                    help=f"Resilience counter {field!r} per policy "
                         "(utils/resilience.py)"))
                fam.samples.append((labels, float(value)))
        out = list(counters.values())
        if state.samples:
            out.append(state)
        if opens.samples:
            out.append(opens)
        return out

    return collect


def server_info_collector(server: str) -> Collector:
    """A constant ``pio_server_info`` gauge carrying the server role
    and the port's version — the join key dashboards group scrapes by."""

    def collect() -> list[Metric]:
        from predictionio_tpu_torch import __version__

        return [Metric(
            name="pio_server_info", kind="gauge",
            help="Constant 1; labels carry server role and version",
            samples=[({"server": server, "version": __version__}, 1.0)],
        )]

    return collect
