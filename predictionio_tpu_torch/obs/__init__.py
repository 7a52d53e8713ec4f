"""The observability plane (the port's counterpart of the JAX package's
``obs/``): request tracing, latency histograms, the metric registry and
its Prometheus text export, the SLO engine, build accounting and the
train profiler. Seven modules:

- :mod:`~predictionio_tpu_torch.obs.trace` — spans with ids, parent
  links and contextvar propagation that survives the QueryBatcher's
  thread handoff and the deadline pool (``GET /traces.json``);
- :mod:`~predictionio_tpu_torch.obs.histogram` — log-bucketed latency
  histograms with lock-guarded snapshots;
- :mod:`~predictionio_tpu_torch.obs.registry` — one metric registry per
  server, adopting ServingStats / IngestStats / the WAL / the online
  plane / the resilience counters through scrape-time collectors;
- :mod:`~predictionio_tpu_torch.obs.exporter` — Prometheus text for
  ``GET /metrics``;
- :mod:`~predictionio_tpu_torch.obs.slo` — SLO burn-rate gauges and the
  fleet-pressure signal;
- :mod:`~predictionio_tpu_torch.obs.compile` — the build sentinel: nvcc
  and g++ builds as compile events, post-warmup builds as serving
  recompiles;
- :mod:`~predictionio_tpu_torch.obs.device` — device memory gauges from
  ``torch.cuda``, the peak-FLOPs table and ``pio train --profile``.

- :mod:`~predictionio_tpu_torch.obs.aggregate` — Prometheus text parsed
  back into families and merged across the workers of a pool.

The JAX package's cross-process ``stitch`` (the router's trace trees) is
ROADMAP.md queue 1 item 23.

The disabled path is near-free: one flag check and no allocation per
request. None of these modules imports torch at import time, so the
event server stays torch-free.
"""

from predictionio_tpu_torch.obs.compile import (
    CompileRecorder,
    compile_metrics_collector,
    mark_warmup_complete,
    record_build,
    recorder,
    stats_doc,
)
from predictionio_tpu_torch.obs.device import (
    TrainProfiler,
    count_flops,
    device_memory_collector,
    device_memory_snapshot,
    resolve_peak_flops,
    summarize_train_report,
    train_report_collector,
)
from predictionio_tpu_torch.obs.exporter import (
    CONTENT_TYPE,
    escape_label_value,
    render_metrics,
    render_prometheus,
)
from predictionio_tpu_torch.obs.histogram import LatencyHistogram
from predictionio_tpu_torch.obs.registry import (
    HistogramFamily,
    Metric,
    MetricRegistry,
    ingest_collector,
    online_collector,
    resilience_collector,
    server_info_collector,
    serving_collector,
    wal_collector,
)
from predictionio_tpu_torch.obs.slo import (
    SLOEngine,
    SLOObjective,
    fleet_pressure,
    serving_pressure_collector,
)
from predictionio_tpu_torch.obs.trace import (
    PARENT_SPAN_HEADER,
    TRACE_ID_HEADER,
    Trace,
    TraceLog,
    active_trace,
    parse_trace_context,
    span,
    start_trace,
    tracing_default,
    use_trace,
)

__all__ = [
    "CONTENT_TYPE",
    "CompileRecorder",
    "HistogramFamily",
    "LatencyHistogram",
    "Metric",
    "MetricRegistry",
    "PARENT_SPAN_HEADER",
    "SLOEngine",
    "SLOObjective",
    "TRACE_ID_HEADER",
    "Trace",
    "TraceLog",
    "TrainProfiler",
    "active_trace",
    "compile_metrics_collector",
    "count_flops",
    "device_memory_collector",
    "device_memory_snapshot",
    "escape_label_value",
    "fleet_pressure",
    "ingest_collector",
    "mark_warmup_complete",
    "online_collector",
    "parse_trace_context",
    "record_build",
    "recorder",
    "render_metrics",
    "render_prometheus",
    "resilience_collector",
    "resolve_peak_flops",
    "server_info_collector",
    "serving_collector",
    "serving_pressure_collector",
    "span",
    "start_trace",
    "stats_doc",
    "summarize_train_report",
    "train_report_collector",
    "tracing_default",
    "use_trace",
    "wal_collector",
]
