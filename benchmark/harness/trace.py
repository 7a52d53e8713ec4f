"""The traced window: ``torch.profiler`` around the measured calls, and
the reduction of its events to what the per-layer metrics read.

A ``--trace 1`` run wraps its window in :class:`WindowTrace`. The
profiler records the host's torch operations and the card's kernels and
copies; the window is the benchmark's own ``bench.window`` annotation,
and each measured call sits in a ``bench.<name>`` annotation
(:meth:`WindowTrace.span`). :func:`reduce_events` turns the raw events
into a :class:`TraceSummary`: the device's busy seconds (the union of
its operations' intervals inside the window), the kernels by name, the
launch count, and the idle gaps named by what the host was in.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Iterable, Iterator

WINDOW = "bench.window"
#: idle gaps shorter than this are summed under one name rather than
#: each named by the host operation around it
SHORT_GAP_NS = 20_000


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int
    #: device seconds by operation name
    device_ops: dict
    #: idle seconds by what the host was in
    idle_gaps: dict
    #: (name, start_ns, end_ns) of every device operation in the window
    device_events: list

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum((e - s) for name, s, e in self.device_events if match(name)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        return {
            "device_ops": [[n, s] for n, s in sorted(self.device_ops.items(),
                                                    key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(self.idle_gaps.items(),
                                                   key=lambda kv: -kv[1])[:top]],
        }


def _is_annotation(ev) -> bool:
    """The benchmark's own spans; and any other user annotation where the
    profiler's events say which they are (not every torch release does)."""
    flag = getattr(ev, "is_user_annotation", None)
    return ev.name().startswith("bench.") or bool(flag and flag())


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _name_gaps(host: list[tuple[str, int, int]], points: list[int]) -> list[str]:
    """For each time of ``points`` (ascending), the benchmark span and the
    innermost host operation open at that time: one sweep over the host
    events by start, keeping the stack of those still open."""
    host = sorted(host, key=lambda h: h[1])
    spans = [h for h in host if h[0].startswith("bench.") and h[0] != WINDOW]
    names, stack, i, k = [], [], 0, 0
    for t in points:
        while i < len(host) and host[i][1] <= t:
            name, s, e = host[i]
            i += 1
            if name.startswith("bench."):
                continue
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((e, name))
        while stack and stack[-1][0] <= t:
            stack.pop()
        while k < len(spans) and spans[k][2] <= t:
            k += 1
        span = spans[k][0] if k < len(spans) and spans[k][1] <= t else "outside any call"
        names.append(f"{span}: {stack[-1][1] if stack else 'python'}")
    return names


def reduce_events(events: Iterable) -> TraceSummary:
    """Reduce ``prof.profiler.kineto_results.events()`` to a summary."""
    from torch.autograd import DeviceType

    device, host = [], []
    window = None
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if ev.device_type() == DeviceType.CUDA:
            # the profiler mirrors host annotations onto the device's
            # timeline; they are no device work
            if not _is_annotation(ev):
                device.append((ev.name(), s, e))
        elif ev.device_type() == DeviceType.CPU:
            if ev.name() == WINDOW:
                window = (s, e)
            host.append((ev.name(), s, e))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    w0, w1 = window
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    ops: dict[str, float] = defaultdict(float)
    for n, s, e in inside:
        ops[n] += (e - s) / 1e9
    busy = _union([(s, e) for _, s, e in inside])
    gaps: dict[str, float] = defaultdict(float)
    long_gaps = []                        # (midpoint, seconds)
    edge = w0
    for s, e in busy + [(w1, w1)]:
        if s > edge:
            gap = s - edge
            if gap < SHORT_GAP_NS:
                gaps[f"gaps under {SHORT_GAP_NS // 1000} us"] += gap / 1e9
            else:
                long_gaps.append((edge + gap // 2, gap / 1e9))
        edge = max(edge, e)
    for name, (_, seconds) in zip(_name_gaps(host, [t for t, _ in long_gaps]), long_gaps):
        gaps[name] += seconds
    return TraceSummary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        launches=sum(1 for n, _, _ in inside if not _is_copy(n)),
        device_ops=dict(ops),
        idle_gaps=dict(gaps),
        device_events=inside,
    )


class WindowTrace:
    """The window's profiler when ``enabled``; else a no-op with the same
    calls, so the driver's loop is one code path in both kinds of run.

    The profiler is started and stopped through ``torch.profiler``'s own
    trace calls, and its raw events are read without building the
    ``FunctionEvent`` tree that leaving a ``profile`` block builds: that
    tree costs more than the window itself on a trace of a million
    launches."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: TraceSummary | None = None
        self._stack = contextlib.ExitStack()

    def __enter__(self) -> "WindowTrace":
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.prepare_trace()
            self._prof.start_trace()
            self._stack.enter_context(record_function(WINDOW))
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()
        if not self.enabled:
            return
        from torch.autograd import _disable_profiler

        results = _disable_profiler()
        if exc[0] is None:
            self.summary = reduce_events(results.events())

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function

        with record_function(f"bench.{name}"):
            yield
