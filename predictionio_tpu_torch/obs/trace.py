"""Dapper-style request tracing for the serving, ingest and training
paths (a copy of the JAX package's ``obs/trace.py``; Sigelman et al.,
2010).

A :class:`Trace` is one request's (or one train run's) span tree: flat
records of ``(name, parent, span id, start offset, duration)``, so spans
measured on other threads — the QueryBatcher's dispatcher recording
queue-wait and device time, the deadline pool running an unbatched
predict — land on the same trace safely.

Propagation has two legs:

- **ambient** — a contextvar carries the active trace on the current
  thread; ``span(name)`` opens a child span against it and is a shared
  no-op when no trace is active (one contextvar read, no allocation).
  ``contextvars.copy_context`` captures it, so the engine server's
  deadline pool threads inherit the trace;
- **explicit** — queue handoffs (``QueryBatcher.submit``) carry the
  trace object on the queue entry; the dispatcher thread calls
  ``Trace.add_span`` with intervals it measured itself.

The enabled path takes no lock: span records are tuples appended with
``list.append`` (atomic under the GIL), and ids are a per-process random
prefix plus a counter, with no ``uuid4`` per request. Finished traces go
into a bounded :class:`TraceLog` ring per server, served as JSON on
``GET /traces.json``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import re
import threading
import time
import uuid
from collections import deque
from contextvars import ContextVar
from typing import Any, Iterator, Mapping

#: process-unique trace ids: one random prefix per process plus a
#: sequence (no os.urandom read per traced request); itertools.count is
#: one C call, safe under the GIL
_TRACE_ID_PREFIX = uuid.uuid4().hex[:16]
_TRACE_ID_SEQ = itertools.count(1)

#: span ids carry a per-segment prefix: a per-process random part plus a
#: per-process segment counter, so the spans of several trace segments
#: (several servers in one process, or processes joined by the trace
#: headers) never share an id
_SPAN_ID_PREFIX = uuid.uuid4().hex[:6]
_SPAN_SEG_SEQ = itertools.count(1)

#: cross-process trace context headers: a caller forwards the trace id
#: and the id of its own span, so this server's segment nests under it
TRACE_ID_HEADER = "X-PIO-Trace-Id"
PARENT_SPAN_HEADER = "X-PIO-Parent-Span"

#: inbound trace context is adopted only when it looks like an id —
#: anything else (spaces, quotes, control bytes, unbounded length) is
#: dropped and a fresh local trace started: a hostile header must never
#: inject into trace documents nor fail the request
_TRACE_CTX_RE = re.compile(r"^[A-Za-z0-9._:-]{1,128}$")


def parse_trace_context(
        headers: Mapping[str, str]) -> tuple[str | None, str | None]:
    """``(trace_id, parent_span_id)`` from inbound headers, each None
    when absent or malformed/oversized (never raises). ``headers`` may
    be an ``email.Message`` (case-insensitive get) or a lowercased
    dict."""

    def clean(name: str) -> str | None:
        raw = headers.get(name) or headers.get(name.lower())
        if raw and _TRACE_CTX_RE.match(raw):
            return raw
        return None

    return clean(TRACE_ID_HEADER), clean(PARENT_SPAN_HEADER)


def tracing_default() -> bool:
    """The default for servers whose config leaves ``tracing`` unset:
    the ``PIO_TRACE`` env var, read at call time (server construction)."""
    return os.environ.get("PIO_TRACE", "").strip().lower() in (
        "1", "true", "yes", "on")


_current: ContextVar["Trace | None"] = ContextVar("pio_trace", default=None)

_ROOT_PARENT = ""


class Trace:
    """One request's spans. Cheap to create (an id, a list); creation is
    gated behind the server's tracing flag, so the disabled path never
    allocates.

    Why there is no lock: span records are appended with
    ``list.append`` — atomic under the GIL — and every read
    (``to_dict``/``stage_seconds``) first takes an atomic ``list(...)``
    copy, so a reader never sees a half-written record (tuples are built
    before the append). In the serving wiring the writers do not overlap
    anyway: the handler thread waits on its future while the batcher's
    dispatcher records the queue-wait and device spans."""

    __slots__ = ("trace_id", "name", "request_id", "parent_span_id",
                 "service", "tags", "_t0", "_wall_start", "_spans",
                 "_span_seq", "_span_prefix", "_duration", "observer")

    def __init__(self, name: str, request_id: str | None = None,
                 trace_id: str | None = None,
                 parent_span_id: str | None = None,
                 service: str | None = None):
        self.trace_id = (trace_id
                         or f"{_TRACE_ID_PREFIX}{next(_TRACE_ID_SEQ):012x}")
        self.name = name
        self.request_id = request_id
        #: the remote span this segment nests under (forwarded with
        #: X-PIO-Parent-Span); None for a root segment
        self.parent_span_id = parent_span_id
        #: which server recorded this segment ("engine"/"event")
        self.service = service
        self.tags: dict[str, Any] = {}
        self._t0 = time.perf_counter()
        self._wall_start = time.time()
        #: flat records: (name, parent_id, span_id, start_off_s, dur_s)
        self._spans: list[tuple[str, str, str, float, float]] = []
        #: per-trace span-id sequence (reserve_span_id hands ids out
        #: before their spans are recorded, so not len(self._spans))
        self._span_seq = itertools.count()
        self._span_prefix = f"{_SPAN_ID_PREFIX}{next(_SPAN_SEG_SEQ):x}"
        self._duration: float | None = None
        #: optional span-completion callback ``(name, start_off_s,
        #: dur_s)`` — the train profiler samples device memory as each
        #: DASE stage closes (obs/device.TrainProfiler). Exceptions are
        #: swallowed: an observer must never fail the traced work.
        self.observer = None

    # -- span recording ------------------------------------------------------
    def span(self, name: str, parent_id: str = _ROOT_PARENT) -> "_ActiveSpan":
        """Context manager timing one in-thread stage."""
        return _ActiveSpan(self, name, parent_id)

    def reserve_span_id(self) -> str:
        """A span id usable before its span is recorded (the feedback
        post puts it on its headers, then records the span with it)."""
        return f"s{self._span_prefix}.{next(self._span_seq):x}"

    def add_span(self, name: str, start_perf: float, end_perf: float,
                 parent_id: str = _ROOT_PARENT,
                 span_id: str | None = None) -> str:
        """Record an interval measured elsewhere (e.g. the batcher's
        dispatcher thread timing queue wait with its own clock reads).
        ``start_perf``/``end_perf`` are ``time.perf_counter`` values.
        Returns the new span id."""
        if span_id is None:
            span_id = f"s{self._span_prefix}.{next(self._span_seq):x}"
        self._spans.append(
            (name, parent_id, span_id,
             start_perf - self._t0, max(0.0, end_perf - start_perf)))
        observer = self.observer
        if observer is not None:
            try:
                observer(name, start_perf - self._t0,
                         max(0.0, end_perf - start_perf))
            except Exception:
                pass
        return span_id

    def finish(self, **tags: Any) -> None:
        self._duration = time.perf_counter() - self._t0
        if tags:
            self.tags.update(tags)

    # -- views ---------------------------------------------------------------
    @property
    def start_perf(self) -> float:
        """The ``time.perf_counter`` origin span offsets are relative
        to — lets external clock readings (the build recorder's events)
        be binned into this trace's spans."""
        return self._t0

    def spans(self) -> list[tuple[str, str, str, float, float]]:
        """Atomic copy of the raw span records ``(name, parent_id,
        span_id, start_off_s, dur_s)``."""
        return list(self._spans)

    def stage_seconds(self) -> dict[str, float]:
        """Total seconds per span name, insertion-ordered — the
        ``pio train`` stage breakdown."""
        out: dict[str, float] = {}
        for name, _, _, _, dur in list(self._spans):
            out[name] = out.get(name, 0.0) + dur
        return out

    def to_dict(self) -> dict:
        spans = list(self._spans)
        duration = self._duration
        tags = dict(self.tags)
        doc: dict[str, Any] = {
            "traceId": self.trace_id,
            "name": self.name,
            "startTime": self._wall_start,
            "durationMs": (round(duration * 1e3, 3)
                           if duration is not None else None),
            "spans": [
                {
                    "name": name,
                    "spanId": span_id,
                    **({"parentId": parent} if parent else {}),
                    "startMs": round(start * 1e3, 3),
                    "durationMs": round(dur * 1e3, 3),
                }
                for name, parent, span_id, start, dur in sorted(
                    spans, key=lambda s: s[3])
            ],
        }
        if self.request_id:
            doc["requestId"] = self.request_id
        if self.parent_span_id:
            doc["parentSpanId"] = self.parent_span_id
        if self.service:
            doc["service"] = self.service
        if tags:
            doc["tags"] = tags
        return doc


class _ActiveSpan:
    """The in-thread span context manager (``Trace.span``)."""

    __slots__ = ("_trace", "_name", "_parent", "_start", "span_id")

    def __init__(self, trace: Trace, name: str, parent_id: str):
        self._trace = trace
        self._name = name
        self._parent = parent_id
        self._start = 0.0
        self.span_id = ""

    def __enter__(self) -> "_ActiveSpan":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.span_id = self._trace.add_span(
            self._name, self._start, time.perf_counter(), self._parent)


class _NullSpan:
    """Shared no-op for the disabled path: ``span()`` with no active
    trace returns this singleton — no allocation, two no-op calls."""

    __slots__ = ()
    span_id = ""

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


def start_trace(name: str, request_id: str | None = None,
                trace_id: str | None = None,
                parent_span_id: str | None = None,
                service: str | None = None) -> Trace:
    """A new root trace (or, with ``trace_id``/``parent_span_id`` from
    :func:`parse_trace_context`, a child segment of a cross-process
    trace). Call sites gate this behind their tracing flag — the flag
    check is the whole cost of the disabled path."""
    return Trace(name, request_id=request_id, trace_id=trace_id,
                 parent_span_id=parent_span_id, service=service)


def active_trace() -> Trace | None:
    return _current.get()


@contextlib.contextmanager
def use_trace(trace: Trace | None) -> Iterator[Trace | None]:
    """Bind ``trace`` as the ambient trace for the current context.
    ``contextvars.copy_context()`` carries the binding onto pool
    threads (the deadline-dispatch path)."""
    token = _current.set(trace)
    try:
        yield trace
    finally:
        _current.reset(token)


def span(name: str):
    """Ambient child span: records against the current trace, or is a
    shared no-op when none is active (one contextvar read, zero
    allocation)."""
    trace = _current.get()
    if trace is None:
        return _NULL_SPAN
    return trace.span(name)


class TraceLog:
    """Bounded ring of recently finished traces (newest first on read).
    Recording is one deque append under the ring's lock; serialization
    to JSON-able dicts happens at read time (relying on the lock-free
    :class:`Trace` read contract), so the request hot path never pays
    for a trace nobody is looking at."""

    def __init__(self, maxlen: int = 64):
        self._lock = threading.Lock()
        self._ring: deque[Trace] = deque(maxlen=maxlen)
        self._recorded = 0

    def record(self, trace: Trace) -> None:
        with self._lock:
            self._ring.append(trace)
            self._recorded += 1

    def snapshot(self) -> list[dict]:
        with self._lock:
            traces = list(reversed(self._ring))
        return [t.to_dict() for t in traces]

    def find(self, trace_id: str) -> list[dict]:
        """Every recorded segment of one trace."""
        with self._lock:
            traces = [t for t in self._ring if t.trace_id == trace_id]
        return [t.to_dict() for t in traces]

    @property
    def recorded(self) -> int:
        with self._lock:
            return self._recorded
