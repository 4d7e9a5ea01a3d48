"""Counted model FLOPs (``flops.py``) of the window's untraced part over
its host-clock length times the configuration's peak, in percent."""
from perfbench.reductions import mfu


def read(outcome):
    return mfu(outcome)
