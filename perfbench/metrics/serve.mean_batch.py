"""Mean molecules per flush over the window (``FlushRecord.n_requests``)."""


def read(outcome):
    sizes = outcome.counters.get("flush_requests")
    if not sizes:
        return None
    return sum(sizes) / len(sizes)
