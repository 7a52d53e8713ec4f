"""``moe.load_max.serve-long`` (ratio): the (position, expert) pairs
routed to the busiest expert over the mean pairs per expert, the largest
over the layers, in the window: from the program's own counter of routed
pairs (``pio_moe_routed_pairs_total{layer, expert}``), read before and
after the window. 1 is an even load; the grouped products wait for the
busiest expert. Nothing to read where the program has no such counter."""


def read(outcome):
    routed = outcome.facts.get("moe_routed")
    if outcome.trace is None or not routed:
        return None
    ratios = [max(row) / (sum(row) / len(row)) for row in routed if sum(row) > 0]
    return max(ratios) if ratios else None
