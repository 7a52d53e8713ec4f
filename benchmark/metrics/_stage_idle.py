"""Idle card time inside ``query_batch`` by the program's own stage
spans, shared by the ``idle.*.serve`` readers.

With ``--trace 1`` the harness names each idle gap of the window by the
benchmark span and the innermost host event open at the gap's midpoint
(``harness/trace.py``): ``"bench.query_batch: seqrec.prepare"`` when
the host was inside the template's ``seqrec.prepare`` span and no torch
operation, ``"bench.query_batch: python"`` when it was inside
``query_batch`` but in no span and no operation at all. A reader sums
the idle seconds of the gaps named after its names, as a share of the
window.

The card idles once a batch, from the last copy of one batch's
``seqrec.fetch`` to the next batch's ``seqrec.copy_in``: the host
decodes, steps its loop, prepares and stacks. The gap takes the name of
the stage at its midpoint, so the host stages are read together, never
one by one.
"""

CALL = "bench.query_batch"
#: the prefix of the program's serve-path stage spans
STAGE_PREFIX = "seqrec."
#: the stages in which only the host works: between one batch's answers
#: and the next batch's copy to the card
HOST_STAGES = ("seqrec.prepare", "seqrec.stack", "seqrec.decode")


def idle_inside_call(outcome) -> tuple[dict[str, float], float] | None:
    """``({innermost host event: idle seconds}, window seconds)`` over the
    gaps whose midpoint lay inside a ``query_batch`` call; None without a
    trace or without device work in it."""
    trace = outcome.trace
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    inside: dict[str, float] = {}
    for key, seconds in trace.idle_gaps.items():
        span, sep, inner = key.partition(": ")
        if sep and span == CALL:
            inside[inner] = inside.get(inner, 0.0) + seconds
    return inside, trace.window_s


def share(inside: dict[str, float], window_s: float, names) -> float:
    """100 · the idle seconds named by one of ``names`` / the window."""
    return 100.0 * sum(inside.get(n, 0.0) for n in names) / window_s
