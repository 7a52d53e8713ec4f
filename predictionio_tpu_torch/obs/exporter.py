"""Prometheus text exposition (version 0.0.4) over a MetricRegistry (a
copy of the JAX package's ``obs/exporter.py``: both packages render one
registry to the same bytes, so one scraper and one dashboard read both).

Pure rendering — no client library, no network:

- every family gets ``# HELP`` and ``# TYPE`` lines;
- counter sample names end in ``_total``;
- histograms expose cumulative ``_bucket{le=...}`` series ending in
  ``le="+Inf"``, plus ``_sum`` and ``_count``, with
  ``_count == _bucket{le="+Inf"}`` (the torn-snapshot invariant the
  lock-guarded HistogramSnapshot carries through to the wire).
"""

from __future__ import annotations

from typing import Iterable, Mapping

from predictionio_tpu_torch.obs.registry import Metric, MetricRegistry

#: the content type Prometheus scrapers expect for this format
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(value: str) -> str:
    """Text-format 0.0.4 label-value escaping: backslash first (or the
    other escapes' backslashes would be doubled), then quote and
    line-feed."""
    return (value.replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _fmt_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_prometheus(registry: MetricRegistry) -> str:
    """Render every family in the registry, sorted by name so
    successive scrapes diff cleanly."""
    return render_metrics(registry.collect())


def render_metrics(metrics: Iterable[Metric]) -> str:
    """Render an explicit family list."""
    lines: list[str] = []
    for metric in sorted(metrics, key=lambda m: m.name):
        lines.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        if metric.kind == "histogram":
            for labels, snap in metric.histograms:
                base = dict(labels)
                # cumulative[-1] is the +Inf bucket; the pairs below
                # cover the finite bounds (a +Inf bound is skipped, or it
                # would render a second, conflicting le="+Inf" line)
                for bound, cum in zip(snap.bounds, snap.cumulative):
                    if bound == float("inf"):
                        continue
                    lines.append(
                        f"{metric.name}_bucket"
                        f"{_fmt_labels({**base, 'le': repr(float(bound))})}"
                        f" {cum}")
                lines.append(
                    f"{metric.name}_bucket"
                    f"{_fmt_labels({**base, 'le': '+Inf'})}"
                    f" {snap.cumulative[-1]}")
                lines.append(
                    f"{metric.name}_sum{_fmt_labels(base)}"
                    f" {_fmt_value(snap.sum)}")
                lines.append(
                    f"{metric.name}_count{_fmt_labels(base)}"
                    f" {snap.count}")
            continue
        for labels, value in metric.samples:
            lines.append(
                f"{metric.name}{_fmt_labels(labels)} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"
