"""The ``idle.*.serve`` readers, which name the card's idle time inside
``query_batch`` by the program's own stage spans: on hand-built trace
summaries, and through the trace reduction on fake profiler events where
the program's annotations name the gaps and add no device work."""

from __future__ import annotations

import bench_tiny  # noqa: F401  (puts the checkout on sys.path)
import pytest

from benchmark.harness.manifest import load_manifest, load_module
from benchmark.harness.runner import Outcome
from benchmark.harness.trace import TraceSummary, reduce_events

CELL = "sessionrec-s2048.serve-b64"
READERS = ("idle.host_stages.serve", "idle.unnamed.serve")


def _outcome(trace):
    return Outcome(attempted=64, failed=0, end_to_end={}, facts={}, readings={},
                   memory_peak_bytes=0, trace=trace)


def _summary(gaps: dict, window_s: float = 50.0, busy_s: float = 25.0) -> TraceSummary:
    return TraceSummary(window_s, busy_s, 100, {"kernel": busy_s}, gaps, [])


def _read(name: str, trace):
    return load_module("metrics", name).read(_outcome(trace))


GAPS = {
    "bench.query_batch: seqrec.prepare": 9.0,
    "bench.query_batch: seqrec.stack": 3.0,
    "bench.query_batch: seqrec.decode": 1.5,
    # a gap named by a stage in which the card works is no host stage's
    "bench.query_batch: seqrec.forward": 0.3,
    "bench.query_batch: python": 0.5,
    "bench.query_batch: cudaMemcpyAsync": 0.4,
    "outside any call: python": 0.1,
    "gaps under 20 us": 0.7,
    # a span of another call is not this call's
    "bench.other: seqrec.prepare": 2.0,
}


@pytest.mark.parametrize("name,want", [
    ("idle.host_stages.serve", 100 * 13.5 / 50), ("idle.unnamed.serve", 100 * 0.5 / 50)])
def test_readers_name_the_idle_time_by_stage(name, want):
    assert _read(name, _summary(GAPS)) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_a_trace_or_device_work(name):
    assert _read(name, None) is None
    assert _read(name, _summary(GAPS, busy_s=0.0)) is None
    assert _read(name, _summary(GAPS, window_s=0.0)) is None


def test_a_program_without_stage_spans_reads_no_stage_share_and_all_unnamed():
    # the port before its stage spans (or a later one that lost them): the
    # host's time in query_batch is all "python"; the host stages' share
    # is not defined there, and the unnamed share reads all of it
    gaps = {"bench.query_batch: python": 19.9, "bench.query_batch: aten::topk": 0.1,
            "gaps under 20 us": 0.7}
    assert _read("idle.host_stages.serve", _summary(gaps)) is None
    assert _read("idle.unnamed.serve", _summary(gaps)) == pytest.approx(100 * 19.9 / 50)


def test_fully_overlapped_host_work_reads_zero_unnamed():
    # no idle gap inside query_batch at all: nothing is left unnamed
    gaps = {"gaps under 20 us": 0.7}
    assert _read("idle.unnamed.serve", _summary(gaps)) == 0.0
    assert _read("idle.host_stages.serve", _summary(gaps)) is None


def test_a_stage_with_no_idle_gap_reads_zero():
    gaps = {"bench.query_batch: seqrec.forward": 10.0}
    assert _read("idle.host_stages.serve", _summary(gaps)) == 0.0
    assert _read("idle.unnamed.serve", _summary(gaps)) == 0.0


def test_the_manifest_lists_the_readers_for_the_serve_cell():
    entries = {m["name"]: m for m in load_manifest()["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"], m["workloads"]) == (
            "%", "lower", "program_span", "queries_per_s", [CELL])
    assert entries["idle.host_stages.serve"]["layer"] == "template"
    assert entries["idle.unnamed.serve"]["layer"] == "deploy and template"


class _Ev:
    def __init__(self, name, device, s, e, annotation=False):
        self._n, self._d, self._s, self._e, self._a = name, device, s, e, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def is_user_annotation(self):
        return self._a


def _events():
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    return [
        _Ev("bench.window", cpu, 0, 1_000_000, True),
        _Ev("bench.query_batch", cpu, 0, 950_000, True),
        # the template prepares on the host while the card idles (0-300 us)
        _Ev("seqrec.prepare", cpu, 10_000, 250_000, True),
        _Ev("seqrec.stack", cpu, 250_000, 290_000, True),
        _Ev("seqrec.copy_in", cpu, 290_000, 320_000, True),
        _Ev("aten::to", cpu, 292_000, 318_000),
        _Ev("Memcpy HtoD (Pageable -> Device)", gpu, 300_000, 320_000),
        _Ev("seqrec.forward", cpu, 320_000, 400_000, True),
        # the profiler mirrors the annotation onto the card's timeline
        _Ev("seqrec.forward", gpu, 321_000, 700_000, True),
        _Ev("kernel_a", gpu, 322_000, 700_000),
        _Ev("seqrec.fetch", cpu, 400_000, 710_000, True),
        _Ev("Memcpy DtoH (Device -> Pageable)", gpu, 700_000, 705_000),
        # decode, then the host in query_batch outside every span
        _Ev("seqrec.decode", cpu, 710_000, 900_000, True),
    ]


def test_reduce_events_names_gaps_by_the_program_spans():
    t = reduce_events(_events())
    # gaps: 0-300 us (mid 150: seqrec.prepare), 320-322 us (short),
    # 705-1000 us (mid 852.5: seqrec.decode)
    assert t.idle_gaps["bench.query_batch: seqrec.prepare"] == pytest.approx(300_000 / 1e9)
    assert t.idle_gaps["bench.query_batch: seqrec.decode"] == pytest.approx(295_000 / 1e9)
    assert t.idle_gaps["gaps under 20 us"] == pytest.approx(2_000 / 1e9)
    assert "bench.query_batch: python" not in t.idle_gaps
    outcome = _outcome(t)
    assert load_module("metrics", "idle.host_stages.serve").read(outcome) == pytest.approx(59.5)
    assert load_module("metrics", "idle.unnamed.serve").read(outcome) == 0.0


def test_a_mirrored_program_annotation_is_no_device_work():
    t = reduce_events(_events())
    assert not any(name.startswith("seqrec.") for name in t.device_ops)
    assert not any(name.startswith("seqrec.") for name, _, _ in t.device_events)
    # busy: the two copies and the kernel, not the mirrored 321-700 us span
    assert t.busy_s == pytest.approx((20_000 + 378_000 + 5_000) / 1e9)
    assert t.launches == 1
