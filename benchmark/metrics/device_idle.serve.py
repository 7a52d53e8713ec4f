"""``device_idle.serve`` (%): the share of the traced serving window in
which no operation ran on the card, from the profiler's trace."""

from benchmark.metrics._idle import idle_share

read = idle_share
