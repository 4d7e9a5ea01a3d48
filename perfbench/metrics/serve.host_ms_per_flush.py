"""Mean host time per flush in the engine before the device sync: host
prep (padding, edge lists) plus dispatch, from
``QuantizedEngine.last_infer_breakdown`` through ``FlushRecord``, in ms."""


def read(outcome):
    host = outcome.counters.get("flush_host_s")
    if not host:
        return None
    return 1e3 * sum(host) / len(host)
