"""The hand-written kernels' least time (by ``rooflines/``) over their
device time in the traced window, in percent."""
from perfbench.reductions import kernel_roofline


def read(outcome):
    return kernel_roofline(outcome)
