"""``batch_ms.p50.serve`` (ms): the median of the benchmark's own host
spans around each ``DeployedEngine.query_batch`` call of the traced
window: the deploy and template layers' time for one batch."""

import statistics


def read(outcome):
    spans = outcome.facts.get("batch_ms") if outcome.trace is not None else None
    return statistics.median(spans) if spans else None
