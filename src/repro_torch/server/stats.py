"""Latency/throughput accounting shared by the scheduler and the traffic
harness: a copy of ``repro/server/stats.py`` (numpy only).

Percentiles are computed over *request* latencies (one sample per
molecule, not per batch) with linear interpolation — the convention the
serving literature reports p50/p95/p99 in. Open-loop latency is measured
from the request's **scheduled arrival time**, not from when the driver
thread actually managed to submit it, so a driver that falls behind under
overload cannot hide queueing delay (coordinated omission).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["latency_summary", "FlushRecord", "flush_summary"]


def latency_summary(latencies_s: Sequence[float],
                    span_s: Optional[float] = None) -> Dict[str, float]:
    """p50/p95/p99/mean/max latency (milliseconds) + throughput over the
    span (requests/s). ``span_s`` is first-arrival -> last-completion;
    when omitted only the latency fields are filled."""
    lat = np.asarray(latencies_s, dtype=np.float64)
    if lat.size == 0:
        raise ValueError("no latency samples")
    out = {
        "n_requests": int(lat.size),
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p95_ms": float(np.percentile(lat, 95) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "mean_ms": float(lat.mean() * 1e3),
        "max_ms": float(lat.max() * 1e3),
    }
    if span_s is not None:
        out["span_s"] = float(span_s)
        out["throughput_rps"] = float(lat.size / max(span_s, 1e-9))
    return out


@dataclasses.dataclass(frozen=True)
class FlushRecord:
    """One scheduler flush: which shape class ran, where, and why."""
    capacity: int        # bucket the flushed queue belongs to
    n_requests: int      # real molecules in the flush
    reason: str          # "full" | "deadline" | "drain"
    queue_depth: int     # total requests waiting across all queues, pre-pop
    wait_s: float        # oldest request's queue residence at flush time
    service_s: float     # infer_batch wall clock for the flush
    path: str            # execution path the batch took (dense/sparse)
    batch_size: int = 0  # compiled batch rows (incl. alignment dummies)
    replica_id: int = 0  # replica that served the flush (0: single engine)
    # obs linkage: trace ids of the requests in this flush (empty when
    # tracing is disabled); joins flush telemetry to per-request traces
    trace_ids: tuple = ()
    # per-flush serve-time breakdown from the engine profiling hooks
    # (serving.engine.last_infer_breakdown): prep (padding), dispatch (kernel submit), device sync
    prep_s: float = 0.0
    dispatch_s: float = 0.0
    sync_s: float = 0.0
    # monotonic flush start time: places the flush on the fleet
    # timeline; 0.0 = not recorded
    t_start: float = 0.0


def flush_summary(flushes: Sequence[FlushRecord]) -> Dict[str, object]:
    """Aggregate flush telemetry: batch-size distribution (the bucket
    occupancy dynamic batching achieved), flush reasons, queue depths,
    and the per-replica breakdown that verifies cluster routing balance
    (degenerate single-replica schedulers report one entry for id 0)."""
    if not flushes:
        return {"n_flushes": 0}
    sizes = np.asarray([f.n_requests for f in flushes], np.float64)
    depths = np.asarray([f.queue_depth for f in flushes], np.float64)
    reasons: Dict[str, int] = {}
    per_bucket: Dict[int, List[int]] = {}
    per_replica: Dict[int, List[FlushRecord]] = {}
    for f in flushes:
        reasons[f.reason] = reasons.get(f.reason, 0) + 1
        per_bucket.setdefault(f.capacity, []).append(f.n_requests)
        per_replica.setdefault(f.replica_id, []).append(f)
    return {
        "n_flushes": len(flushes),
        "mean_batch": float(sizes.mean()),
        "max_batch": int(sizes.max()),
        "mean_queue_depth": float(depths.mean()),
        "max_queue_depth": int(depths.max()),
        "flush_reasons": reasons,
        "mean_batch_per_bucket": {
            str(cap): float(np.mean(v)) for cap, v in sorted(
                per_bucket.items())},
        "per_replica": {
            str(rid): {
                "n_flushes": len(fs),
                "n_requests": int(sum(f.n_requests for f in fs)),
                "mean_batch": float(np.mean([f.n_requests for f in fs])),
            } for rid, fs in sorted(per_replica.items())},
    }
