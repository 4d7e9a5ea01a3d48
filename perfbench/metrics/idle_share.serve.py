"""Share of the traced window in which no kernel ran on the device
(1 - profiler busy / window; the open loop's arrivals set the window's
length, so the profiler's own cost does not lengthen it)."""
from perfbench.reductions import idle_share


def read(outcome):
    return idle_share(outcome)
