"""Device kernels per MD step over the traced, replayed segments."""
from perfbench.reductions import kernels_per_unit


def read(outcome):
    return kernels_per_unit(outcome)
