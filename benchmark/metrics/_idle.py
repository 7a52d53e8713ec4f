"""The idle share of a traced window, shared by the ``device_idle.*``
readers: 100 · (1 - busy / window), where busy is the union of the
card's operations inside the window."""


def idle_share(outcome):
    trace = outcome.trace
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
