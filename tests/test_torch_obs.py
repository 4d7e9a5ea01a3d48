"""The port's health plane (``repro_torch.obs``) against the JAX package's
``repro.obs`` on the CPU: the same inputs, drawn from a numpy seed, go
through both packages.

* ``prometheus_text`` of one registry's writes is byte for byte the same
  (and so is the text each package renders of the other's snapshot).
* A ``JsonlTraceSink`` file written by either package loads in the
  other's ``load_traces``, after rotation too; both sinks rotate into the
  same bytes.
* The same registry writes at the same explicit ``now`` values, stepped
  through both ``HealthMonitor``s of ``SLOEvaluator(default_slos())`` and
  ``AnomalyMonitor(default_detectors())``, publish equal alerts: name,
  severity, source, labels, threshold and ``t`` equal, value and every
  number of the evidence within 1e-12, in the same order. The stream
  fires every SLO kind and every detector.
* ``quantile_from_buckets`` agrees on random bucket dicts.
* ``chrome_trace`` and ``validate_chrome_trace`` agree on the same
  traces, flush records and warmup records, and on corrupted documents.

No test sleeps: every evaluation takes an explicit ``now``.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

from repro.obs import anomaly as j_anomaly
from repro.obs import export as j_export
from repro.obs import metrics as j_metrics
from repro.obs import slo as j_slo
from repro.obs import timeline as j_timeline
from repro.server.stats import FlushRecord as JFlushRecord
from repro_torch.obs import anomaly as t_anomaly
from repro_torch.obs import export as t_export
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import slo as t_slo
from repro_torch.obs import timeline as t_timeline
from repro_torch.obs import trace as t_trace
from repro_torch.server.stats import FlushRecord

PKGS = {"jax": (j_metrics, j_slo, j_anomaly, j_export),
        "port": (t_metrics, t_slo, t_anomaly, t_export)}
# value and evidence numbers, the two packages' alerts
ALERT_TOL = 1e-12
STEPS = 120


def _apply(reg, ops):
    for kind, name, labels, x in ops:
        if kind == "counter":
            reg.counter(name, **labels).inc(x)
        elif kind == "gauge":
            reg.gauge(name, **labels).set(x)
        else:
            reg.histogram(name, **labels).observe(x)


def _registry_ops(seed):
    """Random writes over every instrument kind: names with characters
    Prometheus does not allow, label values of every replica, and
    histogram samples from 0 (the underflow bucket) to minutes."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(200):
        k = int(rng.integers(0, 3))
        labels = {"replica": str(int(rng.integers(0, 4)))}
        if rng.random() < 0.3:
            labels["event"] = str(rng.choice(["submitted", "shed", "done"]))
        if k == 0:
            ops.append(("counter", str(rng.choice(
                ["serve_requests_total", "pool.events-total", "beat"])),
                labels, float(rng.integers(1, 5))))
        elif k == 1:
            ops.append(("gauge", str(rng.choice(
                ["cluster_queue_depth", "md_energy_drift_ratio"])),
                labels, float(rng.normal() * 10.0 ** rng.integers(-8, 8))))
        else:
            x = float(rng.lognormal(-4.0, 3.0)) if rng.random() < 0.9 \
                else 0.0
            ops.append(("hist", str(rng.choice(
                ["replica_flush_seconds", "serve_request_latency_seconds"])),
                labels, x))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_is_byte_for_byte_the_jax_packages(seed):
    ops = _registry_ops(seed)
    regs = {}
    for key, (metrics, _, _, _) in PKGS.items():
        regs[key] = metrics.MetricsRegistry()
        _apply(regs[key], ops)
    text = t_export.prometheus_text(registry=regs["port"])
    assert text == j_export.prometheus_text(registry=regs["jax"])
    assert text.count("# TYPE") >= 6 and "pool_events_total" in text
    snap = regs["port"].snapshot()
    assert j_export.prometheus_text(snap) == text
    assert t_export.prometheus_text(regs["jax"].snapshot()) == text


def test_write_metrics_matches_but_the_export_stamp(tmp_path):
    ops = _registry_ops(3)
    bodies = []
    for key, (metrics, _, _, export) in PKGS.items():
        reg = metrics.MetricsRegistry()
        _apply(reg, ops)
        path = tmp_path / f"{key}.prom"
        export.write_metrics(str(path), registry=reg)
        lines = path.read_text().splitlines(keepends=True)
        assert lines[0].startswith("# exported_at ")
        bodies.append("".join(lines[1:]))
    assert bodies[0] == bodies[1] and bodies[0]
    assert not list(tmp_path.glob("*.tmp.*"))


def _trace_docs(seed, n=40):
    """Finished request and chunk traces of the port's span model, from
    numpy times (both packages' ``RequestTrace`` give the same document,
    tests/test_torch_trace.py)."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        t = float(rng.uniform(0.0, 100.0))
        rt = t_trace.RequestTrace(f"r-{i}", "chunk" if i % 7 == 0
                                  else "request", t0=t)
        for name in ("queue", "serve", "queue", "serve")[
                :int(rng.integers(1, 5))]:
            t += float(rng.exponential(0.05))
            rt.begin(name, t, replica=int(rng.integers(0, 4)))
        rt.finish(t + float(rng.exponential(0.05)), status="ok")
        docs.append(rt.to_json())
    return docs


def _files(path):
    """A rotated sink's files, oldest first."""
    rotated = sorted(path.parent.glob(path.name + ".*"),
                     key=lambda p: -int(p.suffix[1:]))
    return rotated + [path]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_trace_files_read_both_ways_after_rotation(tmp_path, writer, reader):
    docs = _trace_docs(4)
    sink = PKGS[writer][3].JsonlTraceSink(str(tmp_path / "t.jsonl"),
                                          max_bytes=4096, keep=20)
    for d in docs:
        sink.write(d)
    sink.close()
    assert sink.n_rotations >= 2
    back = []
    for f in _files(tmp_path / "t.jsonl"):
        back += PKGS[reader][3].load_traces(str(f))
    assert back == docs


def test_both_sinks_rotate_into_the_same_bytes(tmp_path):
    docs = _trace_docs(5)
    for key, (_, _, _, export) in PKGS.items():
        (tmp_path / key).mkdir()
        with export.JsonlTraceSink(str(tmp_path / key / "t.jsonl"),
                                   max_bytes=3000, keep=3) as sink:
            for d in docs:
                sink.write(d)
    j = _files(tmp_path / "jax" / "t.jsonl")
    t = _files(tmp_path / "port" / "t.jsonl")
    assert [p.name for p in j] == [p.name for p in t] and len(t) == 4
    assert [p.read_bytes() for p in j] == [p.read_bytes() for p in t]


# -- the health plane: one stream of registry writes through both ------------

def _health_stream(seed):
    """Per step, the registry writes of a served fleet with one episode
    of each fault the catalogue and the detectors know, at known steps:
    a latency storm, an MD drift, a LEE level, replica deaths and a
    stall, shedding, a compile mid-serving, an escalation burst, a queue
    runaway, lost session frames and one slow replica."""
    rng = np.random.default_rng(seed)
    steps = []
    for t in range(STEPS):
        ops = []
        n = int(rng.poisson(20)) + 1
        ops.append(("counter", "serve_requests_total",
                    {"surface": "pool", "event": "submitted"}, n))
        ops.append(("counter", "serve_requests_total",
                    {"surface": "replica", "event": "completed"}, n))
        storm = 30 <= t < 40
        for x in rng.lognormal(math.log(2.0 if storm else 0.05), 0.4, n):
            ops.append(("hist", "serve_request_latency_seconds",
                        {"kind": "request", "bucket": "16"}, float(x)))
        if 60 <= t < 72:
            ops.append(("counter", "serve_requests_total",
                        {"surface": "pool", "event": "shed"},
                        int(rng.integers(5, 10))))
        if 80 <= t < 88:
            ops.append(("counter", "pool_events_total",
                        {"event": "escalated"}, int(rng.integers(3, 6))))
        for ev, at in (("replica_failure", (20, 70)),
                       ("stall_detected", (33,))):
            if t in at:
                ops.append(("counter", "pool_events_total", {"event": ev},
                            1))
        ops.append(("counter", "session_frames_total", {"event": "emitted"},
                    2))
        if 95 <= t < 103:
            ops.append(("counter", "session_frames_total", {"event": "lost"},
                        1))
        ops.append(("gauge", "md_energy_drift_ratio", {"mode": "w4a8"},
                    3.0 if 40 <= t < 44 else float(rng.uniform(0, 0.5))))
        ops.append(("gauge", "engine_lee_probe_level", {},
                    2.0 if 55 <= t < 58 else float(rng.uniform(0, 0.1))))
        if t == 0 or t == 65:
            for _ in range(4):
                ops.append(("hist", "engine_warmup_compile_seconds",
                            {"mode": "w4a8", "path": "sparse"},
                            float(rng.uniform(0.2, 1.5))))
        for r in range(4):
            slow = r == 2 and 100 <= t < 112
            for x in rng.normal(0.1 if slow else 0.01, 0.001, 3):
                ops.append(("hist", "replica_flush_seconds",
                            {"replica": str(r)}, float(abs(x))))
            depth = (10.0 * 1.4 ** (t - 85) if (r == 0 and 85 <= t < 92)
                     else float(rng.integers(0, 3)))
            ops.append(("gauge", "cluster_queue_depth", {"replica": str(r)},
                        depth))
        steps.append(ops)
    return steps


def _run_health(key, stream, slo_kw):
    metrics, slo, anomaly, _ = PKGS[key]
    reg = metrics.MetricsRegistry()
    bus = slo.AlertBus(registry=reg)
    fired = []
    bus.subscribe(fired.append)
    mon = slo.HealthMonitor(
        [slo.SLOEvaluator(slo.default_slos(**slo_kw), registry=reg, bus=bus),
         anomaly.AnomalyMonitor(anomaly.default_detectors(), registry=reg,
                                bus=bus)])
    for t, ops in enumerate(stream):
        _apply(reg, ops)
        before = len(fired)
        assert mon.step_all(now=float(t)) == fired[before:]
    return fired, reg


def _close(a, b, path="evidence"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == b or abs(a - b) <= ALERT_TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("seed,slo_kw", [
    (0, dict(fast_window_s=5.0, slow_window_s=15.0)),
    (1, dict(fast_window_s=3.0, slow_window_s=9.0, allow_partial=True,
             latency_p99_s=1.0))])
def test_alerts_equal_the_jax_packages(seed, slo_kw):
    stream = _health_stream(seed)
    jax_fired, jreg = _run_health("jax", stream, slo_kw)
    port_fired, treg = _run_health("port", stream, slo_kw)
    assert [a.name for a in port_fired] == [a.name for a in jax_fired]
    for a, b in zip(port_fired, jax_fired):
        assert (a.name, a.severity, a.source, a.message, dict(a.labels),
                a.threshold, a.t) == (b.name, b.severity, b.source,
                                      b.message, dict(b.labels),
                                      b.threshold, b.t)
        assert abs(a.value - b.value) <= ALERT_TOL
        _close(dict(a.evidence), dict(b.evidence))
    # every SLO kind and every detector fired
    names = {a.name for a in port_fired}
    assert names == ({s.name for s in t_slo.default_slos()}
                     | {d.name for d in t_anomaly.default_detectors()})
    # the status gauges and the bus's counter agree too
    snap = {k: v for k, v in treg.flat().items()
            if k.startswith(("slo_breached", "anomaly_active",
                             "repro_obs_alerts_total"))}
    assert snap and snap == {
        k: v for k, v in jreg.flat().items()
        if k.startswith(("slo_breached", "anomaly_active",
                         "repro_obs_alerts_total"))}


def test_default_catalogues_equal_the_jax_packages():
    kw = dict(fast_window_s=0.6, slow_window_s=1.8, latency_p99_s=30.0,
              allow_partial=True)
    for args in ({}, kw):
        a, b = t_slo.default_slos(**args), j_slo.default_slos(**args)
        assert [dataclasses.asdict(s) for s in a] \
            == [dataclasses.asdict(s) for s in b]
    assert [vars(d) | {"cls": type(d).__name__}
            for d in t_anomaly.default_detectors()] \
        == [vars(d) | {"cls": type(d).__name__}
            for d in j_anomaly.default_detectors()]


@pytest.mark.parametrize("seed", range(4))
def test_quantile_from_buckets_equals_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        keys = {str(int(k)) for k in rng.integers(-60, 60, 12)}
        if rng.random() < 0.5:
            keys.add("u")
        buckets = {k: int(rng.integers(0, 9)) for k in keys}
        for q in (0.0, 0.5, 0.95, 0.99, 1.0, float(rng.random())):
            assert t_slo.quantile_from_buckets(buckets, q) \
                == j_slo.quantile_from_buckets(buckets, q)
    assert t_slo.quantile_from_buckets({}, 0.99) == 0.0


def test_robust_zscore_and_ewma_equal_the_jax_packages():
    rng = np.random.default_rng(7)
    for _ in range(30):
        hist = list(rng.normal(5, 2, int(rng.integers(0, 12))))
        x = float(rng.normal(5, 6))
        assert t_anomaly.robust_zscore(hist, x) \
            == j_anomaly.robust_zscore(hist, x)
    a, b = t_anomaly.EwmaZScore(), j_anomaly.EwmaZScore()
    for x in rng.normal(10, 1, 40):
        assert a.score(x) == b.score(x)
        a.update(x)
        b.update(x)


# -- the timeline ----------------------------------------------------------

def _timeline_inputs(seed):
    rng = np.random.default_rng(seed)
    docs = _trace_docs(seed, n=12)
    fields = []
    for i in range(10):
        prep, disp, sync = (float(x) for x in rng.exponential(0.01, 3))
        fields.append(dict(
            capacity=int(rng.choice([16, 32])), n_requests=int(i % 8 + 1),
            reason=str(rng.choice(["full", "deadline"])),
            queue_depth=int(rng.integers(0, 9)),
            wait_s=float(rng.exponential(0.02)),
            service_s=prep + disp + sync, path="sparse", batch_size=8,
            replica_id=int(rng.integers(0, 4)), prep_s=prep,
            dispatch_s=disp, sync_s=sync,
            t_start=0.0 if i == 3 else float(rng.uniform(1.0, 100.0))))
    warm = [{"replica": r, "bucket": cap, "batch_size": b, "path": p,
             "mode": "w4a8", "seconds": float(rng.uniform(0.1, 2.0)),
             "t0": float(rng.uniform(0.5, 1.0))}
            for r in range(2) for cap in (16, 32) for b in (1, 8)
            for p in ("dense", "sparse")]
    return docs, fields, warm


def _without_stamps(doc):
    other = {k: v for k, v in doc["otherData"].items()
             if k not in ("exported_at", "generator")}
    return {**doc, "otherData": other}


@pytest.mark.parametrize("seed", [0, 1])
def test_chrome_trace_equals_the_jax_packages(seed):
    docs, fields, warm = _timeline_inputs(seed)
    port = t_timeline.chrome_trace(docs, [FlushRecord(**f) for f in fields],
                                   warm)
    jax_ = j_timeline.chrome_trace(docs, [JFlushRecord(**f) for f in fields],
                                   warm)
    assert _without_stamps(port) == _without_stamps(jax_)
    assert port["otherData"]["generator"] == "repro_torch.obs.timeline"
    assert port["otherData"]["n_flushes_skipped"] == 1
    # dict records render as the dataclasses do
    assert _without_stamps(t_timeline.chrome_trace(docs, fields, warm)) \
        == _without_stamps(port)
    verdict = t_timeline.validate_chrome_trace(port)
    assert verdict == j_timeline.validate_chrome_trace(port)
    assert verdict["ok"] and verdict["n_async_trees"] == len(docs)
    # corrupted: a shifted child boundary, a missing field, a negative dur
    bad = json.loads(json.dumps(port))
    spans = [e for e in bad["traceEvents"] if e["ph"] in ("b", "e")]
    [e for e in spans if e["ph"] == "e"][1]["ts"] += 40.0
    next(e for e in bad["traceEvents"] if e["ph"] == "X")["dur"] = -1.0
    del bad["traceEvents"][-1]["ts"]
    verdict = t_timeline.validate_chrome_trace(bad)
    assert verdict == j_timeline.validate_chrome_trace(bad)
    assert not verdict["ok"] and verdict["tiling_violations"] >= 1 \
        and verdict["n_schema_errors"] >= 2


def test_write_chrome_trace_reads_back(tmp_path):
    docs, fields, warm = _timeline_inputs(2)
    doc = t_timeline.write_chrome_trace(str(tmp_path / "c.json"), docs,
                                        fields, warm)
    back = json.loads((tmp_path / "c.json").read_text())
    assert back == json.loads(json.dumps(doc))
    assert j_timeline.validate_chrome_trace(back)["ok"]
