"""``idle.host_stages.serve`` (%): the share of the traced serving window
in which the card sat idle between batches while the host worked in the
template's host-only stages: ``seqrec.decode`` of one batch,
``seqrec.prepare`` and ``seqrec.stack`` of the next
(``SeqRecAlgorithm.batch_predict``).

A program without the stage spans (no gap inside ``query_batch`` is
named after a ``seqrec.`` span) reads nothing: the share is not defined
there."""

from benchmark.metrics._stage_idle import HOST_STAGES, STAGE_PREFIX, idle_inside_call, share


def read(outcome):
    got = idle_inside_call(outcome)
    if got is None:
        return None
    inside, window_s = got
    if not any(name.startswith(STAGE_PREFIX) for name in inside):
        return None
    return share(inside, window_s, HOST_STAGES)
