"""``launches_per_iter.als`` (launches/iter): kernels that ran on the card
in the traced window (copies and fills not counted), over the ALS
iterations in it."""


def read(outcome):
    trace, n = outcome.trace, outcome.facts.get("iterations", 0)
    if trace is None or n <= 0 or trace.launches <= 0:
        return None
    return trace.launches / n
