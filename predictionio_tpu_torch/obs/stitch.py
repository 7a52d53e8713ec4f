"""Cross-process trace stitching: join the per-process segments of one
fleet request into a single span tree (a copy of the JAX package's
``obs/stitch.py``).

A request that crosses the router hop leaves one trace SEGMENT per
process — the router's (admission, attempt, retry, hedge spans) and one
per replica that saw an attempt — all sharing a ``traceId``. The router
forwards ``X-PIO-Trace-Id`` plus ``X-PIO-Parent-Span`` (the span id of
its attempt span), so each replica segment records which remote span it
nests under (``parentSpanId`` on the segment document).

:func:`stitch` joins the documents:

- each segment becomes a synthetic root span (the segment's name and
  duration) parented on its ``parentSpanId`` — or on nothing for the
  root segment (no ``parentSpanId``; ties broken by earliest wall
  start);
- the segment's own spans keep their ids (process-prefixed, so no
  cross-segment collisions) and hang off the synthetic root when they
  had no in-segment parent;
- span start offsets are re-expressed relative to the ROOT segment's
  wall start using each segment's wall-clock ``startTime``. Same-host
  fleets make that exact to NTP noise; the renderer never relies on a
  child sitting strictly inside its parent's interval.

Orphan segments (their ``parentSpanId`` names a span no collected
segment contains — e.g. the parent fell off a bounded trace ring) are
kept, parented at the root, and flagged ``"orphan": true`` rather than
dropped: a stitched view must degrade to "everything we know" instead
of silently narrowing.

Pure functions over JSON-able dicts — no I/O, no clock reads (the obs
plane never pushes; the router's merge endpoint and ``pio trace`` do
the fetching).
"""

from __future__ import annotations

from typing import Any, Iterable

#: synthetic span id prefix for segment roots — cannot collide with
#: real span ids (those start with "s")
_SEG = "seg"


def stitch(segments: Iterable[dict]) -> dict | None:
    """One stitched trace document from the segments of one trace, or
    None when ``segments`` is empty. Input docs are ``Trace.to_dict``
    output (optionally annotated with ``source`` by the collector)."""
    docs = sorted(segments, key=lambda d: d.get("startTime") or 0.0)
    if not docs:
        return None
    root_idx = next(
        (i for i, d in enumerate(docs) if not d.get("parentSpanId")), 0)
    root = docs[root_idx]
    base_start = root.get("startTime") or 0.0
    known_spans: set[str] = set()
    for doc in docs:
        for span in doc.get("spans", ()):
            known_spans.add(span["spanId"])

    spans: list[dict] = []
    seg_docs: list[dict] = []
    for i, doc in enumerate(docs):
        seg_id = f"{_SEG}{i}"
        offset_ms = ((doc.get("startTime") or base_start) - base_start) * 1e3
        parent = doc.get("parentSpanId") or ""
        orphan = False
        if doc is not root and parent and parent not in known_spans:
            # the remote parent span was never collected (ring bound,
            # dead worker): keep the segment, attach it at the root
            parent, orphan = "", True
        seg_span = {
            "name": doc.get("name", "trace"),
            "spanId": seg_id,
            "startMs": round(offset_ms, 3),
            "durationMs": doc.get("durationMs"),
            "segment": True,
        }
        if doc is not root and not parent:
            parent = f"{_SEG}{root_idx}"
        if parent:
            seg_span["parentId"] = parent
        if orphan:
            seg_span["orphan"] = True
        for key in ("service", "source", "requestId", "tags"):
            if doc.get(key) is not None:
                seg_span[key] = doc[key]
        spans.append(seg_span)
        for span in doc.get("spans", ()):
            out = dict(span)
            out["startMs"] = round(span["startMs"] + offset_ms, 3)
            if not out.get("parentId"):
                out["parentId"] = seg_id
            spans.append(out)

        seg_docs.append({
            "segment": seg_id,
            "name": doc.get("name"),
            "service": doc.get("service"),
            "source": doc.get("source"),
            "startTime": doc.get("startTime"),
            "durationMs": doc.get("durationMs"),
            "spanCount": len(doc.get("spans", ())),
        })

    return {
        "traceId": root.get("traceId"),
        "name": root.get("name"),
        "startTime": base_start,
        "durationMs": root.get("durationMs"),
        **({"requestId": root["requestId"]}
           if root.get("requestId") else {}),
        "segments": seg_docs,
        "spans": spans,
    }


def _children(spans: list[dict]) -> dict[str, list[dict]]:
    by_parent: dict[str, list[dict]] = {}
    for span in spans:
        by_parent.setdefault(span.get("parentId", ""), []).append(span)
    for kids in by_parent.values():
        kids.sort(key=lambda s: (s.get("startMs") or 0.0, s["spanId"]))
    return by_parent


def render_tree(doc: dict) -> str:
    """Operator-facing text tree of a stitched trace (``pio trace``)."""
    lines = [
        f"trace {doc.get('traceId')}  {doc.get('name')}"
        + (f"  request_id={doc['requestId']}" if doc.get("requestId") else "")
        + (f"  {doc['durationMs']:.3f}ms"
           if doc.get("durationMs") is not None else "")
    ]
    by_parent = _children(doc.get("spans", []))
    seen: set[str] = set()

    def walk(parent: str, indent: str) -> None:
        kids = [s for s in by_parent.get(parent, [])
                if s["spanId"] not in seen]
        # a malformed segment set (duplicate span ids, a parent loop)
        # must render partially, never recurse forever
        seen.update(s["spanId"] for s in kids)
        for i, span in enumerate(kids):
            last = i == len(kids) - 1
            branch, cont = ("└─ ", "   ") if last else ("├─ ", "│  ")
            where = ""
            if span.get("segment"):
                service = span.get("service") or "?"
                source = span.get("source")
                where = f"  [{service}{' ' + source if source else ''}]"
                if span.get("orphan"):
                    where += " (orphan)"
            dur = (f"  {span['durationMs']:.3f}ms"
                   if span.get("durationMs") is not None else "")
            start = (f"  @{span['startMs']:.3f}ms"
                     if span.get("startMs") is not None else "")
            lines.append(f"{indent}{branch}{span['name']}{dur}{start}{where}")
            walk(span["spanId"], indent + cont)

    walk("", "")
    return "\n".join(lines)


def to_chrome_trace(doc: dict) -> dict:
    """Chrome trace-viewer JSON (``chrome://tracing`` / Perfetto) for a
    stitched trace — complete ("X") events in microseconds, one pid per
    segment, named via metadata events."""
    events: list[dict[str, Any]] = []
    seg_pid: dict[str, int] = {}
    for i, seg in enumerate(doc.get("segments", ())):
        seg_pid[seg["segment"]] = i
        label = seg.get("service") or seg.get("name") or seg["segment"]
        if seg.get("source"):
            label = f"{label} {seg['source']}"
        events.append({
            "ph": "M", "name": "process_name", "pid": i, "tid": 0,
            "args": {"name": label},
        })
    # spans belong to the segment they were recorded in: segment roots
    # map by their own id, ordinary spans inherit from their segment
    # root via the parent chain
    by_id = {s["spanId"]: s for s in doc.get("spans", ())}

    def pid_of(span: dict) -> int:
        cursor = span
        hops: set[str] = set()
        while cursor is not None and cursor["spanId"] not in hops:
            hops.add(cursor["spanId"])
            if cursor["spanId"] in seg_pid:
                return seg_pid[cursor["spanId"]]
            cursor = by_id.get(cursor.get("parentId", ""))
        return 0

    for span in doc.get("spans", ()):
        events.append({
            "ph": "X",
            "name": span["name"],
            "pid": pid_of(span),
            "tid": 0,
            "ts": round((span.get("startMs") or 0.0) * 1e3, 1),
            "dur": round((span.get("durationMs") or 0.0) * 1e3, 1),
            "args": {"spanId": span["spanId"],
                     **({"orphan": True} if span.get("orphan") else {})},
        })
    return {"displayTimeUnit": "ms", "traceEvents": events}
