"""``device_idle.train`` (%): the share of the traced training window in
which no operation ran on the card, from the profiler's trace."""

from benchmark.metrics._idle import idle_share

read = idle_share
