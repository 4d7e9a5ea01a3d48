"""95th percentile over the window's flushes of the oldest request's
queue residence at flush time (``FlushRecord.wait_s``), in ms."""
import numpy as np


def read(outcome):
    waits = outcome.counters.get("flush_wait_s")
    if not waits:
        return None
    return float(np.percentile(waits, 95)) * 1e3
