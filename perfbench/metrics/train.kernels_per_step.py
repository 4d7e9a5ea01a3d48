"""Device kernels per replayed full QAT step in the traced window."""
from perfbench.reductions import kernels_per_unit


def read(outcome):
    return kernels_per_unit(outcome)
