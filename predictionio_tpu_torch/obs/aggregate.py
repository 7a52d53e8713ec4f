"""Scrape-time aggregation across processes (a copy of the JAX package's
``obs/aggregate.py``): parse Prometheus text back into
:class:`~predictionio_tpu_torch.obs.registry.Metric` families and merge
the families of several sources into one exposition.

Under ``pio deploy --workers N`` the N ``SO_REUSEPORT`` processes each
hold a private registry, and a scrape lands on ONE of them. The scraped
worker pulls its siblings' expositions (``fleet/workers.py``) and merges,
so ``/metrics`` reports the whole pool instead of a 1/N sample; the
router's ``/fleet/metrics`` re-exports each replica's families under
:func:`relabel`'s ``replica``/``group`` labels. This module does no I/O.

Merge rules by family kind:

- **counter**: samples with identical label sets are SUMMED;
- **histogram**: merged bucket-wise on the union of the bound ladders
  (each source's cumulative snapshot becomes per-bucket deltas, which
  land on their own bound in the union ladder and are re-accumulated):
  exact when the ladders agree, as they do between workers of one
  deploy. Sums and counts add;
- **gauge**: NOT summed (two workers' device bytes or breaker states do
  not add up): each sample gains a source label (``worker="<id>"``) and
  all are kept.
"""

from __future__ import annotations

import re
from typing import Iterable, Mapping, Sequence

from predictionio_tpu_torch.obs.histogram import HistogramSnapshot
from predictionio_tpu_torch.obs.registry import Metric

#: a label set may hold "}" inside a quoted value (the JAX package's
#: pattern, ``[^}]*``, refuses such a line)
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(?:\{(?P<labels>(?:[^}"]|"(?:[^"\\]|\\.)*")*)\})?'
    r"\s+(?P<value>\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPES = {"n": "\n", '"': '"', "\\": "\\"}


def unescape_label_value(value: str) -> str:
    """Single-pass inverse of exporter.escape_label_value. Sequential
    ``str.replace`` passes are WRONG here: they re-scan bytes produced
    by earlier passes, so ``a\\nb`` (backslash, 'n') unescaped
    newline-first turns into a real newline. One regex pass cannot
    re-read its own output."""
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPES.get(m.group(1), m.group(1)), value)


class ExpositionParseError(ValueError):
    """The text is not parseable Prometheus 0.0.4 exposition."""


def _parse_value(raw: str) -> float:
    if raw == "NaN":
        return float("nan")
    if raw == "+Inf":
        return float("inf")
    if raw == "-Inf":
        return float("-inf")
    return float(raw)


def parse_exposition(text: str) -> list[Metric]:
    """Parse one ``/metrics`` body back into Metric families —
    histograms are reconstructed into :class:`HistogramSnapshot` form
    (bounds from ``le=``, cumulative buckets, sum, count) so a merged
    family re-renders through the same exporter. Raises
    :class:`ExpositionParseError` on malformed input; fan-out callers
    catch it per source and degrade instead of failing the scrape."""
    try:
        return _parse_exposition(text)
    except ExpositionParseError:
        raise
    except (ValueError, KeyError) as exc:
        # a garbled value token (float('1.2e')), a bucket line without
        # le=, a NaN bucket count — all mean "this body is not valid
        # exposition", and the contract above is that callers only
        # need to catch ExpositionParseError to degrade per source
        raise ExpositionParseError(f"malformed exposition: {exc}") from exc


def _parse_exposition(text: str) -> list[Metric]:
    families: dict[str, Metric] = {}
    # histogram assembly: family -> {frozen base labels: parts}
    hist_parts: dict[str, dict[tuple, dict]] = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            kind_line = line.startswith("# TYPE ")
            _, _, rest = line.partition(
                "# TYPE " if kind_line else "# HELP ")
            name, _, payload = rest.partition(" ")
            fam = families.get(name)
            if fam is None:
                fam = families[name] = Metric(name=name, kind="untyped",
                                              help="")
            if kind_line:
                if payload not in ("counter", "gauge", "histogram",
                                   "untyped"):
                    raise ExpositionParseError(
                        f"unsupported TYPE {payload!r} for {name}")
                fam.kind = payload
            else:
                fam.help = payload
            continue
        if line.startswith("#"):
            continue    # comments are legal exposition
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ExpositionParseError(f"unparseable line: {line!r}")
        sample_name = m.group("name")
        labels = {
            k: unescape_label_value(v)
            for k, v in _LABEL_RE.findall(m.group("labels") or "")
        }
        value = _parse_value(m.group("value"))
        family = sample_name
        suffix = ""
        for cand in ("_bucket", "_sum", "_count"):
            base = sample_name[:-len(cand)] if sample_name.endswith(cand) \
                else None
            if base is not None and families.get(base) is not None \
                    and families[base].kind == "histogram":
                family, suffix = base, cand
                break
        fam = families.get(family)
        if fam is None:
            raise ExpositionParseError(
                f"sample before HELP/TYPE: {line!r}")
        if fam.kind == "histogram":
            base_labels = {k: v for k, v in labels.items() if k != "le"}
            key = tuple(sorted(base_labels.items()))
            part = hist_parts.setdefault(family, {}).setdefault(
                key, {"labels": base_labels, "buckets": {},
                      "sum": 0.0, "count": 0})
            if suffix == "_bucket":
                part["buckets"][_parse_value(labels["le"])] = int(value)
            elif suffix == "_sum":
                part["sum"] = value
            elif suffix == "_count":
                part["count"] = int(value)
            else:
                raise ExpositionParseError(
                    f"bare sample on histogram family: {line!r}")
        else:
            fam.samples.append((labels, value))

    inf = float("inf")
    for family, by_labels in hist_parts.items():
        fam = families[family]
        for part in by_labels.values():
            buckets = part["buckets"]
            if inf not in buckets:
                raise ExpositionParseError(
                    f"histogram {family} lacks a +Inf bucket")
            bounds = tuple(sorted(b for b in buckets if b != inf))
            cumulative = tuple(buckets[b] for b in bounds) + (buckets[inf],)
            fam.histograms.append((part["labels"], HistogramSnapshot(
                bounds=bounds or (inf,),
                cumulative=cumulative if bounds else (buckets[inf],
                                                      buckets[inf]),
                sum=part["sum"],
                count=part["count"],
            )))
    return list(families.values())


def merge_snapshots(snaps: Sequence[HistogramSnapshot]) -> HistogramSnapshot:
    """Bucket-wise merge on the union bound ladder (module docstring)."""
    inf = float("inf")
    # a parsed +Inf-only histogram carries bounds=(inf,): keep inf out
    # of the union ladder (its mass is the overflow below) or the
    # merged snapshot renders two conflicting le="+Inf" bucket lines
    union = sorted({b for s in snaps for b in s.bounds if b != inf})
    totals = [0] * (len(union) + 1)
    total_sum = 0.0
    total_count = 0
    index = {b: i for i, b in enumerate(union)}
    for snap in snaps:
        prev = 0
        for bound, cum in zip(snap.bounds, snap.cumulative):
            if bound == inf:
                break   # bounds ascend: only the overflow remains
            totals[index[bound]] += cum - prev
            prev = cum
        totals[-1] += snap.cumulative[-1] - prev     # the +Inf overflow
        total_sum += snap.sum
        total_count += snap.count
    cumulative: list[int] = []
    running = 0
    for delta in totals:
        running += delta
        cumulative.append(running)
    return HistogramSnapshot(
        bounds=tuple(union) or (float("inf"),),
        cumulative=tuple(cumulative) if union else (running, running),
        sum=total_sum,
        count=total_count,
    )


def source_count_metric(name: str, help: str, count: int) -> Metric:
    """The "how many processes fed this scrape" gauge a merged exposition
    appends AFTER :func:`merge_sources` (so it never gains a per-source
    label itself): ``pio_serving_workers`` on the engine server. A
    reading below the launched worker count means a sibling is dead or
    wedged."""
    return Metric(name=name, kind="gauge", help=help,
                  samples=[({}, float(count))])


def merge_sources(sources: Sequence[tuple[str, list[Metric]]],
                  source_label: str = "worker") -> list[Metric]:
    """Merge several processes' family lists into one namespace
    (module docstring's rules). ``sources`` is ``(source_id,
    families)`` pairs; gauges gain ``{source_label: source_id}``.
    A family whose kind disagrees across sources is dropped from the
    merge rather than failing the whole scrape (the disagreement is a
    version skew between workers, not a reason to blind the operator)."""
    kinds: dict[str, str] = {}
    skip: set[str] = set()
    for _, families in sources:
        for fam in families:
            have = kinds.setdefault(fam.name, fam.kind)
            if have != fam.kind:
                skip.add(fam.name)
    merged: dict[str, Metric] = {}
    # counter samples sum by label set; histograms merge per label set
    counter_acc: dict[str, dict[tuple, float]] = {}
    hist_acc: dict[str, dict[tuple, list[HistogramSnapshot]]] = {}
    for source_id, families in sources:
        for fam in families:
            if fam.name in skip:
                continue
            out = merged.get(fam.name)
            if out is None:
                out = merged[fam.name] = Metric(
                    name=fam.name, kind=fam.kind, help=fam.help)
            if fam.kind == "histogram":
                acc = hist_acc.setdefault(fam.name, {})
                for labels, snap in fam.histograms:
                    acc.setdefault(
                        tuple(sorted(labels.items())), []).append(snap)
            elif fam.kind == "counter":
                acc_c = counter_acc.setdefault(fam.name, {})
                for labels, value in fam.samples:
                    key = tuple(sorted(labels.items()))
                    acc_c[key] = acc_c.get(key, 0.0) + value
            else:   # gauge / untyped: keep all, labeled per source
                for labels, value in fam.samples:
                    out.samples.append(
                        ({source_label: source_id, **labels}, value))
    for name, acc_c in counter_acc.items():
        merged[name].samples = [
            (dict(key), value) for key, value in sorted(acc_c.items())]
    for name, acc in hist_acc.items():
        merged[name].histograms = [
            (dict(key), merge_snapshots(snaps))
            for key, snaps in sorted(acc.items())]
    return list(merged.values())


def relabel(metrics: Iterable[Metric], extra: Mapping[str, str]) -> list[Metric]:
    """Copies with ``extra`` merged into every sample's label set (the
    ``replica=...``/``group=...`` annotation on the router's
    ``/fleet/metrics``, plus ``engine=...`` behind a multi-engine
    gateway). Existing keys are not overwritten: a replica that already
    labels per worker (or exports its own ``engine`` label) keeps its
    labels. Label values pass through untouched: escaping happens at
    render time and unescaping at parse time, so a hostile engine name
    (quotes, backslashes, newlines) round-trips exactly."""
    out = []
    for m in metrics:
        out.append(Metric(
            name=m.name, kind=m.kind, help=m.help,
            samples=[({**extra, **labels}, value)
                     for labels, value in m.samples],
            histograms=[({**extra, **labels}, snap)
                        for labels, snap in m.histograms],
        ))
    return out
