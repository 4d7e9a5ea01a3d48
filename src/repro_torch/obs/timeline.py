"""Chrome-trace / Perfetto export for the fleet timeline: a copy of
``repro/obs/timeline.py`` (stdlib only, no torch).

Renders three sources onto one loadable timeline
(``chrome://tracing`` or https://ui.perfetto.dev):

- **Request/chunk span trees** (:class:`~repro_torch.obs.trace.RequestTrace`
  JSONL docs): each trace becomes one *async* event tree (``ph``
  ``b``/``e`` with ``id`` = trace id) on the router process — async
  tracks may overlap freely, which concurrent requests do. The span
  model's exact-tiling invariant (children partition the root with
  shared endpoints) survives the export because the µs conversion is
  one linear map applied to identical floats;
  :func:`validate_chrome_trace` re-checks it on the exported doc.
- **Per-flush breakdowns** (:class:`~repro_torch.server.stats.FlushRecord`
  with ``t_start``): complete (``ph`` ``X``) slices on one pid per
  replica, tid per worker thread. A replica's worker serializes its
  flushes, so ``X`` slices never overlap; ``prep``/``dispatch``/
  ``sync`` render as contained child slices.
- **Warmup records** (``QuantizedEngine.warmup_report`` with ``t0``;
  on the card each is a shape's first run, which builds the kernels,
  not an XLA compile): ``X`` slices on the owning replica's worker
  lane, so a storm of them is visibly a wall of slices.

Timestamps are monotonic seconds rebased to the earliest event and
scaled to µs (floats; Chrome's format takes fractional µs).
Wall-clock never enters the timeline — only the exported doc's
``otherData`` stamp.
"""
from __future__ import annotations

import json
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["chrome_trace", "write_chrome_trace", "validate_chrome_trace",
           "ROUTER_PID", "replica_pid"]

#: pid hosting the async request/chunk trees (queues live router-side).
ROUTER_PID = 1
_REPLICA_PID0 = 100
_TID_WORKER = 1
_TID_CHUNKS = 2


def replica_pid(replica_id) -> int:
    try:
        return _REPLICA_PID0 + int(replica_id)
    except (TypeError, ValueError):
        return _REPLICA_PID0


def _get(rec, field: str, default=None):
    """Field access for dataclass records and plain dicts alike."""
    if isinstance(rec, dict):
        return rec.get(field, default)
    return getattr(rec, field, default)


def _t_base(traces: Sequence[Dict], flushes: Sequence,
            warmup: Sequence) -> float:
    t0s = [t.get("t0") for t in traces if t.get("t0") is not None]
    t0s += [_get(f, "t_start", 0.0) for f in flushes
            if _get(f, "t_start", 0.0) > 0.0]
    t0s += [_get(w, "t0", 0.0) for w in warmup
            if _get(w, "t0", 0.0) > 0.0]
    return min(t0s) if t0s else 0.0


def chrome_trace(traces: Sequence[Dict] = (),
                 flushes: Sequence = (),
                 warmup: Sequence = ()) -> Dict:
    """Build a Chrome-trace JSON object (``{"traceEvents": [...]}``).

    ``traces`` are JSONL trace docs (``RequestTrace.to_json`` /
    ``load_traces``); ``flushes`` are :class:`FlushRecord` objects or
    dicts (records without ``t_start`` predate the timeline plane and
    are skipped); ``warmup`` entries are ``warmup_report`` dicts, with
    an optional ``replica`` key (``ClusterPool.warmup_records`` adds
    it)."""
    traces = list(traces)
    flushes = list(flushes)
    warmup = list(warmup)
    base = _t_base(traces, flushes, warmup)

    def us(t: float) -> float:
        return (t - base) * 1e6

    events: List[Dict] = []
    pids: Dict[int, str] = {ROUTER_PID: "router/queues"}
    tids: Dict[Tuple[int, int], str] = {(ROUTER_PID, _TID_WORKER):
                                        "requests"}
    n_skipped_flushes = 0

    # ---- request/chunk span trees as async b/e trees ----------------
    for doc in traces:
        tid_ = doc.get("trace_id", "?")
        kind = doc.get("kind", "request")
        root_args = {"status": doc.get("status", ""),
                     "hops": doc.get("hops", 0)}
        root_args.update(doc.get("attrs") or {})
        common = {"cat": kind, "id": tid_, "pid": ROUTER_PID,
                  "tid": _TID_WORKER}
        t0, t1 = doc.get("t0"), doc.get("t1")
        if t0 is None or t1 is None:
            continue
        events.append({"ph": "b", "name": kind, "ts": us(t0),
                       "args": root_args, **common})
        for span in doc.get("spans", ()):
            if span.get("parent_id") is None:
                continue  # the root span IS the b/e envelope above
            events.append({"ph": "b", "name": span["name"],
                           "ts": us(span["t0"]),
                           "args": dict(span.get("attrs") or {}),
                           **common})
            events.append({"ph": "e", "name": span["name"],
                           "ts": us(span["t1"]), **common})
        events.append({"ph": "e", "name": kind, "ts": us(t1), **common})
        for ev in doc.get("events", ()):
            attrs = dict(ev.get("attrs") or {})
            rep = attrs.get("replica")
            pid = replica_pid(rep) if rep is not None else ROUTER_PID
            if rep is not None:
                pids.setdefault(pid, f"replica {rep}")
                tids.setdefault((pid, _TID_WORKER), "worker")
            events.append({"ph": "i", "s": "p", "name": ev.get("name", ""),
                           "ts": us(ev.get("t", t0)), "pid": pid,
                           "tid": _TID_WORKER,
                           "args": {"trace_id": tid_, **attrs}})

    # ---- flush slices on replica worker lanes -----------------------
    for rec in flushes:
        t_start = float(_get(rec, "t_start", 0.0) or 0.0)
        if t_start <= 0.0:
            n_skipped_flushes += 1
            continue
        rep = _get(rec, "replica_id", 0)
        pid = replica_pid(rep)
        pids.setdefault(pid, f"replica {rep}")
        tids.setdefault((pid, _TID_WORKER), "worker")
        service = float(_get(rec, "service_s", 0.0) or 0.0)
        reason = _get(rec, "reason", "")
        events.append({
            "ph": "X", "name": f"flush[{reason}]", "pid": pid,
            "tid": _TID_WORKER, "ts": us(t_start), "dur": service * 1e6,
            "args": {"capacity": _get(rec, "capacity", 0),
                     "n_requests": _get(rec, "n_requests", 0),
                     "batch_size": _get(rec, "batch_size", 0),
                     "queue_depth": _get(rec, "queue_depth", 0),
                     "wait_ms": float(_get(rec, "wait_s", 0.0) or 0.0)
                     * 1e3,
                     "path": _get(rec, "path", "")}})
        cursor = t_start
        for seg in ("prep", "dispatch", "sync"):
            dur = float(_get(rec, f"{seg}_s", 0.0) or 0.0)
            if dur <= 0.0:
                continue
            events.append({"ph": "X", "name": seg, "pid": pid,
                           "tid": _TID_WORKER, "ts": us(cursor),
                           "dur": dur * 1e6, "args": {}})
            cursor += dur

    # ---- warmup compile slices --------------------------------------
    for rec in warmup:
        t0 = float(_get(rec, "t0", 0.0) or 0.0)
        if t0 <= 0.0:
            continue
        rep = _get(rec, "replica", 0)
        pid = replica_pid(rep)
        pids.setdefault(pid, f"replica {rep}")
        tids.setdefault((pid, _TID_WORKER), "worker")
        events.append({
            "ph": "X",
            "name": f"compile {_get(rec, 'path', '')} "
                    f"b{_get(rec, 'bucket', 0)}"
                    f"x{_get(rec, 'batch_size', 0)}",
            "pid": pid, "tid": _TID_WORKER, "ts": us(t0),
            "dur": float(_get(rec, "seconds", 0.0) or 0.0) * 1e6,
            "args": {"mode": _get(rec, "mode", ""),
                     "bucket": _get(rec, "bucket", 0)}})

    # ---- metadata ---------------------------------------------------
    meta: List[Dict] = []
    for pid, name in sorted(pids.items()):
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "args": {"name": name}})
        meta.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                     "tid": 0, "args": {"sort_index": pid}})
    for (pid, tid), name in sorted(tids.items()):
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": name}})

    return {"traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"generator": "repro_torch.obs.timeline",
                          "t_base_monotonic": base,
                          "exported_at": time.time(),
                          "n_traces": len(traces),
                          "n_flushes": len(flushes) - n_skipped_flushes,
                          "n_flushes_skipped": n_skipped_flushes,
                          "n_warmup": len(warmup)}}


def write_chrome_trace(path: str, traces: Sequence[Dict] = (),
                       flushes: Sequence = (),
                       warmup: Sequence = ()) -> Dict:
    """Build and write the Chrome-trace doc; returns it."""
    doc = chrome_trace(traces, flushes=flushes, warmup=warmup)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


# --------------------------------------------------------------------------
# validation


_PH_REQUIRED = {
    "X": ("name", "pid", "tid", "ts", "dur"),
    "b": ("name", "pid", "tid", "ts", "cat", "id"),
    "e": ("name", "pid", "tid", "ts", "cat", "id"),
    "i": ("name", "pid", "tid", "ts"),
    "M": ("name", "pid", "args"),
}


def validate_chrome_trace(doc: Dict, tol_us: float = 0.5) -> Dict:
    """Schema + invariant check on an exported Chrome-trace doc.

    Verifies (1) every event carries the fields its phase requires and
    ``X`` durations are non-negative; (2) for every async tree, the
    depth-1 child intervals tile the root *exactly* — shared endpoints
    as identical floats — and (3) the child durations sum to the root
    duration within ``tol_us`` (the span-sum == e2e-latency invariant,
    re-checked after export). Returns a verdict dict with violation
    counts; ``ok`` is True only when everything passes."""
    errors: List[str] = []
    n_events = 0
    trees: Dict[Tuple[str, str], List[Dict]] = {}
    for i, ev in enumerate(doc.get("traceEvents", ())):
        n_events += 1
        ph = ev.get("ph")
        req = _PH_REQUIRED.get(ph)
        if req is None:
            errors.append(f"event {i}: unknown ph {ph!r}")
            continue
        missing = [k for k in req if k not in ev]
        if missing:
            errors.append(f"event {i} (ph={ph}): missing {missing}")
            continue
        if ph == "X" and ev["dur"] < 0:
            errors.append(f"event {i}: negative dur {ev['dur']}")
        if ph in ("b", "e"):
            trees.setdefault((ev["cat"], ev["id"]), []).append(ev)

    tiling_violations = 0
    sum_violations = 0
    max_sum_err = 0.0
    n_trees = 0
    for (cat, tid_), evs in trees.items():
        # events were emitted in document order: b(root) [b/e children] e(root)
        stack: List[Dict] = []
        root: Optional[Tuple[float, float]] = None
        children: List[Tuple[float, float]] = []
        bad = False
        for ev in evs:
            if ev["ph"] == "b":
                stack.append(ev)
            else:
                if not stack:
                    errors.append(f"tree {cat}/{tid_}: unbalanced 'e'")
                    bad = True
                    break
                b = stack.pop()
                pair = (b["ts"], ev["ts"])
                if len(stack) == 0:
                    root = pair
                elif len(stack) == 1:
                    children.append(pair)
        if bad or stack or root is None:
            if stack:
                errors.append(f"tree {cat}/{tid_}: unbalanced 'b'")
            continue
        n_trees += 1
        if not children:
            continue
        children.sort()
        edges = [root[0]] + [c[1] for c in children]
        starts = [c[0] for c in children] + [root[1]]
        # exact tiling: each child starts where the previous ended,
        # first at the root start, last ends at the root end
        if any(a != b for a, b in zip(edges, starts)):
            tiling_violations += 1
        span_sum = sum(c[1] - c[0] for c in children)
        err = abs(span_sum - (root[1] - root[0]))
        max_sum_err = max(max_sum_err, err)
        if err > tol_us:
            sum_violations += 1

    return {"ok": (not errors and tiling_violations == 0
                   and sum_violations == 0),
            "n_events": n_events,
            "n_async_trees": n_trees,
            "schema_errors": errors[:20],
            "n_schema_errors": len(errors),
            "tiling_violations": tiling_violations,
            "sum_violations": sum_violations,
            "max_sum_err_us": max_sum_err}
