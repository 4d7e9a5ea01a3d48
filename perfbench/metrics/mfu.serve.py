"""Counted model FLOPs (``flops.py``) of the requests completed in the
traced window over its length times the configuration's peak, in
percent (the open loop's arrivals set that length)."""
from perfbench.reductions import mfu


def read(outcome):
    return mfu(outcome)
