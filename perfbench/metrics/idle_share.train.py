"""Share of the device's time in which no kernel ran: 1 - the traced
units' profiler busy time over what they take unprofiled (their count
times the untraced part's seconds a unit; ``reductions.py``)."""
from perfbench.reductions import idle_share


def read(outcome):
    return idle_share(outcome)
