"""``idle.moe.serve-long`` (%): the share of the traced window in which
the card sat idle while the host was inside ``query_batch`` in the MoE
layers' own spans (``seqrec.moe.route``: router, top-k, sort, offsets;
``seqrec.moe.experts``: grouped products, combine) and in no torch
operation: a host wait in the dispatch shows here. Zero where no idle
gap falls in those spans; nothing to read without a trace or without
device work in it."""

from benchmark.metrics._stage_idle import idle_inside_call, share

MOE_STAGES = ("seqrec.moe.route", "seqrec.moe.experts")


def read(outcome):
    got = idle_inside_call(outcome)
    if got is None:
        return None
    return share(*got, MOE_STAGES)
