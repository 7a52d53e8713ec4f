"""``idle.unnamed.serve`` (%): the share of the traced serving window in
which the card sat idle while the host was inside ``query_batch`` but in
no program span and no torch operation: the idle time the program's
stage spans leave unnamed. Defined with or without the spans: a program
that lacks them, or loses them, reads all of that time here."""

from benchmark.metrics._stage_idle import idle_inside_call, share


def read(outcome):
    got = idle_inside_call(outcome)
    if got is None:
        return None
    return share(*got, ("python",))
