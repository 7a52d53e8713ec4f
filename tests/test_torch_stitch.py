"""The port's ``obs/stitch.py`` and ``obs/aggregate.relabel`` held against
the JAX package's.

The same trace segments give an equal stitched document, equal
``render_tree`` text and an equal Chrome trace in both packages; the
same families give equal ``relabel`` output and equal expositions after
a render → parse round trip, on the label values both parsers accept.
The port's parser also accepts a ``}`` inside a quoted label value,
which JAX's refuses: that case is held on its own.
"""

from __future__ import annotations

import copy
import importlib

import pytest

from predictionio_tpu.obs import aggregate as jagg
from predictionio_tpu.obs import exporter as jexp
from predictionio_tpu.obs import registry as jreg
from predictionio_tpu.obs.histogram import LatencyHistogram as JHist
from predictionio_tpu_torch.obs import aggregate as pagg
from predictionio_tpu_torch.obs import exporter as pexp
from predictionio_tpu_torch.obs import registry as preg
from predictionio_tpu_torch.obs.histogram import LatencyHistogram as PHist

#: the JAX package's ``obs`` exports a function named ``stitch``, which
#: shadows the module as an attribute
jstitch = importlib.import_module("predictionio_tpu.obs.stitch")
pstitch = importlib.import_module("predictionio_tpu_torch.obs.stitch")

JAX = (jstitch, jagg, jexp, jreg, JHist)
PORT = (pstitch, pagg, pexp, preg, PHist)


def _segment(trace_id, name, service, start, spans, parent_span_id=None,
             duration=5.0, **extra):
    doc = {"traceId": trace_id, "name": name, "service": service,
           "startTime": start, "durationMs": duration, "spans": spans, **extra}
    if parent_span_id:
        doc["parentSpanId"] = parent_span_id
    return doc


def _span(name, span_id, start, duration, parent=None, **attrs):
    doc = {"name": name, "spanId": span_id, "startMs": start, "durationMs": duration}
    if parent:
        doc["parentId"] = parent
    return {**doc, **attrs}


SEGMENT_SETS = {
    "attempt_nests_replica": [
        _segment("t1", "queries.json", "engine", 100.0015, [
            _span("predict", "sB.0", 0.5, 1.0)], parent_span_id="sA.0"),
        _segment("t1", "queries.json", "router", 100.0, [
            _span("attempt[r1]", "sA.0", 1.0, 3.0)]),
    ],
    "orphan_kept_and_flagged": [
        _segment("t2", "queries.json", "router", 100.0, []),
        _segment("t2", "queries.json", "engine", 100.5, [],
                 parent_span_id="s-never-collected"),
    ],
    "cyclic_spans": [
        _segment("t3", "queries.json", "router", 100.0, [
            _span("a", "sX", 0.0, 1.0, parent="sY"),
            _span("b", "sY", 0.0, 1.0, parent="sX")]),
    ],
    "retry_across_two_replicas": [
        _segment("t4", "queries.json", "router", 50.0, [
            _span("admission", "r.0", 0.0, 0.1),
            _span("attempt[a:1]", "r.1", 0.2, 2.0, status=503),
            _span("retry", "r.2", 2.3, 0.05),
            _span("attempt[b:2]", "r.3", 2.4, 4.0, status=200)],
            attrs={"status": 200}),
        _segment("t4", "queries.json", "engine", 50.0003, [
            _span("parse", "a.0", 0.0, 0.1)], parent_span_id="r.1",
            source="a:1", duration=1.5),
        _segment("t4", "queries.json", "engine", 50.0025, [
            _span("parse", "b.0", 0.0, 0.1),
            _span("batcher.queue_wait", "b.1", 0.1, 1.2),
            _span("batcher.device_dispatch", "b.2", 1.3, 2.1),
            _span("encode", "b.3", 3.4, 0.2)], parent_span_id="r.3",
            source="b:2", duration=3.7),
    ],
    "hedge_loser_and_winner": [
        _segment("t5", "queries.json", "router", 10.0, [
            _span("attempt[a:1]", "h.0", 0.0, 9.0),
            _span("hedge", "h.1", 3.0, 0.01),
            _span("attempt[b:2]", "h.2", 3.0, 2.0)]),
        _segment("t5", "queries.json", "engine", 10.003, [
            _span("predict", "w.0", 0.1, 1.5)], parent_span_id="h.2"),
        _segment("t5", "queries.json", "engine", 10.0, [
            _span("predict", "l.0", 0.1, 8.5)], parent_span_id="h.0"),
    ],
    "lone_replica_segment": [
        _segment("t6", "queries.json", "engine", 1.0, [
            _span("parse", "e.0", 0.0, 0.1),
            _span("predict", "e.1", 0.1, 0.4, parent="e.0")]),
    ],
}


@pytest.mark.parametrize("name", sorted(SEGMENT_SETS))
def test_stitch_render_and_chrome_equal_jax(name):
    segments = SEGMENT_SETS[name]
    out = []
    for stitch_mod, *_ in (JAX, PORT):
        tree = stitch_mod.stitch(copy.deepcopy(segments))
        out.append((tree, stitch_mod.render_tree(tree),
                    stitch_mod.to_chrome_trace(tree)))
    assert out[1] == out[0]
    tree, text, chrome = out[1]
    assert tree["traceId"] == segments[0]["traceId"]
    assert text.strip() and chrome["traceEvents"]


def test_stitch_nests_device_dispatch_under_the_winning_attempt():
    tree = pstitch.stitch(copy.deepcopy(SEGMENT_SETS["retry_across_two_replicas"]))
    spans = {s["spanId"]: s for s in tree["spans"]}
    segment = spans[spans["b.2"]["parentId"]]
    assert segment.get("segment") and segment["parentId"] == "r.3"
    text = pstitch.render_tree(tree)
    assert text.index("attempt[b:2]") < text.index("batcher.device_dispatch")


def test_stitch_of_nothing():
    assert jstitch.stitch([]) is None and pstitch.stitch([]) is None


# -- relabel ------------------------------------------------------------------

#: label values both parsers accept (no "}")
LABEL_VALUES = ["127.0.0.1:8000", "latency_500ms", 'va"l\nue', "a\\nb",
                "back\\slash\\\\double", 'mix\\"n\nmatch\\', "rec-v3"]


def _families(mods, value):
    *_, reg, hist_cls = mods
    h = hist_cls(bounds=(0.001, 1.0))
    h.observe(0.5)
    h.observe(2.0)
    return [
        reg.Metric("pio_demo_total", "counter", "c",
                   samples=[({"replica": "127.0.0.1:1", "group": "stable"}, 3.0),
                            ({"engine": "inner", "k": value}, 1.0)]),
        reg.Metric("pio_demo_seconds", "histogram", "h",
                   histograms=[({"replica": value}, h.snapshot())]),
        reg.Metric("pio_demo_up", "gauge", "g", samples=[({}, 1.0)]),
    ]


def _norm(families):
    return [(m.name, m.kind, m.help,
             [(sorted(lb.items()), v) for lb, v in m.samples],
             [(sorted(lb.items()), s.bounds, s.cumulative, s.sum, s.count)
              for lb, s in m.histograms]) for m in families]


@pytest.mark.parametrize("value", LABEL_VALUES)
def test_relabel_and_round_trip_equal_jax(value):
    extra = {"engine": value, "replica": "r9", "group": "canary"}
    out = []
    for mods in (JAX, PORT):
        _, agg, exp, *_ = mods
        relabelled = agg.relabel(_families(mods, value), extra)
        text = exp.render_metrics(relabelled)
        out.append((_norm(relabelled), text, _norm(agg.parse_exposition(text))))
    assert out[1] == out[0]
    families = out[1][0]
    # existing labels are never overwritten; the annotation fills gaps
    assert families[0][3] == [
        (sorted({"replica": "127.0.0.1:1", "group": "stable", "engine": value}.items()), 3.0),
        (sorted({"engine": "inner", "k": value, "replica": "r9",
                 "group": "canary"}.items()), 1.0)]


def test_relabel_merge_sources_equal_jax():
    out = []
    for mods in (JAX, PORT):
        _, agg, exp, *_ = mods
        sources = [(rid, agg.relabel(_families(mods, rid), {"replica": rid}))
                   for rid in ("a:1", "b:2")]
        out.append(exp.render_metrics(agg.merge_sources(sources, source_label="replica")))
    assert out[1] == out[0]


def test_brace_in_a_label_value_round_trips_in_the_port_only():
    """A ``}`` inside a quoted value: the port's parser reads it back,
    JAX's pattern (``[^}]*``) refuses the line."""
    value = "rec}v{2"
    text = pexp.render_metrics(pagg.relabel(_families(PORT, "x"), {"engine": value}))
    back = {m.name: m for m in pagg.parse_exposition(text)}
    assert {lb["engine"] for lb, _ in back["pio_demo_total"].samples} == {"inner", value}
    with pytest.raises(jagg.ExpositionParseError):
        jagg.parse_exposition(text)
