"""The port's health plane on the CPU: the cases of
``tests/test_obs_health.py`` and the export cases of ``tests/test_obs.py``
on ``repro_torch.obs``, and the seeded chaos replay on CPU replicas of the
port's cluster.

* Burn-rate SLO evaluation over synthetic streams with known breach
  points (fire at, and only at, the engineered step; re-arm on
  recovery; strict coverage against ``allow_partial``; the event and
  level kinds; a windowed quantile ageing out an old storm), the
  evaluator's hardening, the anomaly statistics and detectors, the alert
  bus, label-cardinality bounding, sink rotation, the exporters'
  shutdown, the Chrome-trace timeline and its validator, and the JAX
  package's ``scripts/obs_top.py`` and ``scripts/trace_report.py``
  reading the port's files.
* The chaos replay (``TestChaosReplay``): a 4-replica pool of the port's
  engines (``feat=16, vec_feat=4, n_layers=1``) under ``HealthMonitor``,
  ``SLOEvaluator`` and ``AnomalyMonitor``. The chaos arm injects the JAX
  test's four faults (pinned requests on hair-trigger w4a8 replicas, an
  in-flight kill, a stall past the watchdog, an MD session with
  ``drift_limit=1e-12``) and must fire every fault class and nothing
  unattributed; the clean arm fires nothing.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.obs import (REGISTRY, Alert, AlertBus, AnomalyMonitor,
                             CompileStorm, EscalationTrend, EwmaZScore,
                             HealthMonitor, JsonlTraceSink, MetricsRegistry,
                             PeriodicExporter, QueueDepthRunaway,
                             ReplicaLatencySkew, RequestTrace, SLO,
                             SLOEvaluator, chrome_trace, default_detectors,
                             default_slos, load_traces, prometheus_text,
                             robust_zscore, validate_chrome_trace,
                             write_metrics)
from repro_torch.obs.metrics import OVERFLOW_LABELS
from repro_torch.obs.slo import quantile_from_buckets

WAIT_S = 120
REPO = Path(__file__).resolve().parent.parent
SCRIPT_ENV = {**os.environ, "PYTHONPATH": str(REPO / "src")}


def _bus():
    """Fresh bus on a throwaway registry, with a capture list."""
    reg = MetricsRegistry()
    bus = AlertBus(registry=reg)
    fired = []
    bus.subscribe(fired.append)
    return bus, fired


# -- burn-rate SLO evaluation (synthetic streams, synthetic clock) ------------

class TestBurnRate:
    RATIO = SLO(name="err_rate", kind="ratio",
                bad="reqs", bad_where={"event": "bad"},
                total="reqs", total_where={"event": "all"},
                objective=0.01, burn_threshold=10.0,
                fast_window_s=10.0, slow_window_s=30.0)

    def test_breach_fires_once_at_the_engineered_step(self):
        reg = MetricsRegistry()
        bus, fired = _bus()
        ev = SLOEvaluator([self.RATIO], registry=reg, bus=bus)
        all_c = reg.counter("reqs", event="all")
        bad_c = reg.counter("reqs", event="bad")
        breach_t = 41
        for t in range(80):
            all_c.inc(10)
            if t >= breach_t:
                bad_c.inc(5)          # 50% bad from t=41 on
            ev.step(now=float(t))
            if t < breach_t:
                assert not fired, f"false positive at t={t}"
        # both windows must burn >= 10x: the fire lands after the
        # injection but within one slow window of it
        assert len(fired) == 1
        alert = fired[0]
        assert alert.name == "err_rate" and alert.source == "slo"
        assert breach_t < alert.t <= breach_t + 30
        assert alert.evidence["fast_burn"] >= 10.0
        assert alert.evidence["slow_burn"] >= 10.0
        assert alert.evidence["slo_kind"] == "ratio"

    @pytest.mark.parametrize("allow_partial,steps,n_fired",
                             [(False, 20, 0), (True, 5, 1)])
    def test_slow_window_coverage(self, allow_partial, steps, n_fired):
        """Strict mode waits for the history to span the slow window;
        ``allow_partial`` evaluates over the history there is."""
        reg = MetricsRegistry()
        bus, fired = _bus()
        slo = dataclasses.replace(self.RATIO, allow_partial=allow_partial)
        ev = SLOEvaluator([slo], registry=reg, bus=bus)
        all_c = reg.counter("reqs", event="all")
        bad_c = reg.counter("reqs", event="bad")
        for t in range(steps):            # 100% bad
            all_c.inc(10)
            bad_c.inc(10)
            ev.step(now=float(t))
        assert len(fired) == n_fired
        assert ev.status()["err_rate"]["evaluable"] is allow_partial

    def test_rearm_after_recovery_fires_again(self):
        reg = MetricsRegistry()
        bus, fired = _bus()
        ev = SLOEvaluator([self.RATIO], registry=reg, bus=bus)
        all_c = reg.counter("reqs", event="all")
        bad_c = reg.counter("reqs", event="bad")
        phases = [(40, 0.0), (20, 5.0), (60, 0.0), (20, 5.0), (60, 0.0)]
        t = 0
        for steps, bad_rate in phases:
            for _ in range(steps):
                all_c.inc(10)
                if bad_rate:
                    bad_c.inc(bad_rate)
                ev.step(now=float(t))
                t += 1
        assert [a.name for a in fired] == ["err_rate", "err_rate"]
        assert reg.gauge("slo_breached", slo="err_rate").value == 0.0

    def test_event_slo_arms_baseline_then_fires_per_burst(self):
        reg = MetricsRegistry()
        bus, fired = _bus()
        slo = SLO(name="deaths", kind="event", metric="pool_events_total",
                  where={"event": "replica_failure"})
        ev = SLOEvaluator([slo], registry=reg, bus=bus)
        c = reg.counter("pool_events_total", event="replica_failure")
        c.inc(7)                          # pre-existing: must never fire
        ev.step(now=0.0)
        assert fired == []
        c.inc()                           # a fresh death
        ev.step(now=1.0)
        assert [a.name for a in fired] == ["deaths"]
        ev.step(now=2.0)                  # quiet: clears (edge re-arms)
        c.inc()
        ev.step(now=3.0)
        assert [a.name for a in fired] == ["deaths", "deaths"]

    def test_level_slo_fires_and_clears_with_the_gauge(self):
        reg = MetricsRegistry()
        bus, fired = _bus()
        slo = SLO(name="drift", kind="level",
                  metric="md_energy_drift_ratio", objective=1.0)
        ev = SLOEvaluator([slo], registry=reg, bus=bus)
        ev.step(now=0.0)                  # gauge unwritten: not evaluable
        assert ev.status()["drift"]["evaluable"] is False
        reg.gauge("md_energy_drift_ratio", mode="w8a8").set(3.5)
        ev.step(now=1.0)
        assert [a.name for a in fired] == ["drift"]
        assert fired[0].value == 3.5
        reg.gauge("md_energy_drift_ratio", mode="w8a8").set(0.2)
        ev.step(now=2.0)
        assert ev.status()["drift"]["breached"] is False

    def test_quantile_slo_window_ages_out_old_storm(self):
        reg = MetricsRegistry()
        bus, fired = _bus()
        slo = SLO(name="p99", kind="quantile",
                  metric="serve_request_latency_seconds",
                  where={"kind": "request"}, q=0.99, objective=0.5,
                  min_events=20, fast_window_s=10.0, slow_window_s=30.0,
                  allow_partial=True)
        ev = SLOEvaluator([slo], registry=reg, bus=bus)
        h = reg.histogram("serve_request_latency_seconds", kind="request",
                          bucket="16")
        ev.step(now=0.0)
        for _ in range(30):               # the storm: p99 ~ 2s
            h.observe(2.0)
        ev.step(now=1.0)
        assert [a.name for a in fired] == ["p99"]
        assert fired[0].value > 0.5
        # fast traffic only from t=50 on: the storm ages out of both
        # windows (a cumulative histogram would hold p99 ~ 2s forever)
        for t in range(50, 90):
            for _ in range(5):
                h.observe(0.001)
            ev.step(now=float(t))
        st = ev.status()["p99"]
        assert st["breached"] is False and st["value"] < 0.5
        assert len(fired) == 1            # no re-fire after recovery

    def test_duplicate_slo_names_rejected(self):
        with pytest.raises(ValueError, match="duplicate"):
            SLOEvaluator([self.RATIO, self.RATIO])

    def test_default_catalogue_shape(self):
        slos = default_slos()
        assert {s.name for s in slos} == {
            "latency_p99", "shed_rate", "escalation_rate",
            "session_frame_loss", "md_energy_drift", "lee_probe_level",
            "replica_failure", "replica_stall"}
        assert all(s.runbook for s in slos)

    @pytest.mark.parametrize("kw,what", [
        (dict(kind="bogus", metric="m"), "unknown SLO kind"),
        (dict(kind="ratio", bad="b"), "needs bad\\+total"),
        (dict(kind="level"), "needs metric")])
    def test_malformed_slo_rejected(self, kw, what):
        with pytest.raises(ValueError, match=what):
            SLO(name="x", **kw)


# -- evaluator hardening ------------------------------------------------------

class TestEvalHardening:
    @pytest.mark.parametrize("buckets,q,positive", [
        ({"u": 1, "3": 5}, 0.99, True),   # "u" sorts below every index
        ({"u": 10, "3": 1}, 0.5, False),
        ({"u": 4}, 0.99, False)])
    def test_quantile_from_buckets_handles_underflow_key(self, buckets, q,
                                                         positive):
        assert (quantile_from_buckets(buckets, q) > 0.0) is positive

    def test_underflow_observation_does_not_kill_the_catalogue(self):
        reg = MetricsRegistry()
        bus, fired = _bus()
        p99 = SLO(name="p99", kind="quantile",
                  metric="serve_request_latency_seconds", q=0.99,
                  objective=0.5, min_events=1, fast_window_s=10.0,
                  slow_window_s=30.0, allow_partial=True)
        drift = SLO(name="drift", kind="level",
                    metric="md_energy_drift_ratio", objective=1.0)
        ev = SLOEvaluator([p99, drift], registry=reg, bus=bus)
        h = reg.histogram("serve_request_latency_seconds")
        reg.gauge("md_energy_drift_ratio").set(3.0)
        ev.step(now=0.0)
        h.observe(0.0)                    # zero-duration sample: "u" bucket
        h.observe(2.0)
        ev.step(now=1.0)
        assert {a.name for a in fired} == {"p99", "drift"}

    def test_one_broken_slo_isolated_and_counted(self):
        reg = MetricsRegistry()
        bus, fired = _bus()
        good = SLO(name="drift", kind="level",
                   metric="md_energy_drift_ratio", objective=1.0)
        bad = SLO(name="boom", kind="level", metric="whatever")
        ev = SLOEvaluator([bad, good], registry=reg, bus=bus)
        ev._EVAL = dict(ev._EVAL)
        orig = ev._EVAL["level"]
        ev._EVAL["level"] = (lambda self, slo: (_ for _ in ()).throw(
            RuntimeError("bad slo")) if slo.name == "boom"
            else orig(self, slo))
        reg.gauge("md_energy_drift_ratio").set(3.0)
        ev.step(now=0.0)
        assert [a.name for a in fired] == ["drift"]
        st = ev.status()["boom"]
        assert st["errored"] is True and "bad slo" in st["error"]
        assert reg.counter("repro_obs_health_eval_errors_total",
                           stepper="slo", slo="boom").value == 1.0

    def test_monitor_counts_dead_stepper_instead_of_silence(self):
        reg = MetricsRegistry()

        class Broken:
            registry = reg

            def step(self, now=None):
                raise RuntimeError("stepper died")

        seen = []

        class Healthy:
            def step(self, now=None):
                seen.append(now)
                return []

        mon = HealthMonitor([Broken(), Healthy()], interval_s=1.0)
        mon.step_all(now=0.0)
        assert seen == [0.0]              # later steppers still ran
        assert reg.counter("repro_obs_health_eval_errors_total",
                           stepper="Broken").value == 1.0

    def test_ratio_min_events_zero_empty_window_is_safe(self):
        reg = MetricsRegistry()
        bus, fired = _bus()
        slo = SLO(name="r0", kind="ratio", bad="bad_total",
                  total="req_total", objective=0.01, min_events=0,
                  fast_window_s=10.0, slow_window_s=30.0,
                  allow_partial=True)
        ev = SLOEvaluator([slo], registry=reg, bus=bus)
        reg.counter("req_total")          # instruments exist, never bumped
        reg.counter("bad_total")
        for t in range(5):
            ev.step(now=float(t))         # windowed total == 0
        assert fired == []
        assert ev.status()["r0"].get("errored") is not True

    def test_monitor_thread_steps_and_stops(self):
        """The background thread steps on its interval; ``stop`` joins it
        and runs one final step."""
        steps = []

        class Counting:
            def step(self, now=None):
                steps.append(now)
                return []
        mon = HealthMonitor([Counting()], interval_s=0.02).start()
        deadline = time.monotonic() + 10.0
        while len(steps) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        n = len(steps)
        mon.stop()
        assert n >= 2 and not mon._thread.is_alive()
        assert len(steps) >= n + 1 and mon.n_steps == len(steps)


# -- anomaly statistics -------------------------------------------------------

class TestStats:
    def test_ewma_scores_spike_against_pre_spike_baseline(self):
        z = EwmaZScore(alpha=0.3, min_points=3)
        for x in (10.0, 10.5, 9.5, 10.2, 9.8):
            assert abs(z.score(x)) < 5.0
            z.update(x)
        assert z.score(100.0) > 10.0      # judged before folding in
        assert abs(z.mean - 10.0) < 1.0

    def test_ewma_needs_min_points(self):
        z = EwmaZScore(min_points=3)
        z.update(1.0)
        z.update(1.0)
        assert z.score(1000.0) == 0.0     # not warmed up yet

    @pytest.mark.parametrize("hist,x,want", [
        ([2.0, 2.0, 2.0, 2.0], 2.0, 0.0),
        ([2.0, 2.0, 2.0, 2.0], 9.0, math.inf),
        ([2.0, 2.0, 2.0, 2.0], -9.0, -math.inf),
        ([], 5.0, 0.0),
        ([1.0, 2.0, 3.0, 4.0, 5.0], 3.0, 0.0),       # median 3, MAD 1
        ([1.0, 2.0, 3.0, 4.0, 5.0], 3.0 + 1.4826, 1.0)])
    def test_robust_zscore(self, hist, x, want):
        assert robust_zscore(hist, x) == pytest.approx(want)


# -- anomaly detectors over synthetic registry streams ------------------------

class TestDetectors:
    def test_queue_depth_runaway_fires_on_growth_not_level(self):
        reg = MetricsRegistry()
        bus, fired = _bus()
        mon = AnomalyMonitor([QueueDepthRunaway()], registry=reg, bus=bus)
        g = reg.gauge("cluster_queue_depth", replica="0")
        for t in range(10):               # flat low depth: silent
            g.set(2.0)
            mon.step(now=float(t))
        assert fired == []
        for t, depth in enumerate((10.0, 14.0, 19.0, 25.0, 33.0), 10):
            g.set(depth)
            mon.step(now=float(t))
        assert [a.name for a in fired] == ["queue_depth_runaway"]
        assert fired[0].severity == "page"
        assert fired[0].evidence["depth"] >= 8.0

    def test_queue_depth_high_but_flat_is_silent(self):
        reg = MetricsRegistry()
        bus, fired = _bus()
        mon = AnomalyMonitor([QueueDepthRunaway()], registry=reg, bus=bus)
        g = reg.gauge("cluster_queue_depth", replica="0")
        for t in range(20):               # saturated but stable
            g.set(50.0)
            mon.step(now=float(t))
        assert fired == []

    def test_compile_storm_skips_startup_then_fires(self):
        """On the card a "compile" is a shape's first run, timed by the
        engine's warmup into the same histogram."""
        reg = MetricsRegistry()
        bus, fired = _bus()
        mon = AnomalyMonitor([CompileStorm()], registry=reg, bus=bus)
        h = reg.histogram("engine_warmup_compile_seconds", path="dense")
        h.observe(1.2)                    # startup warmup
        mon.step(now=0.0)
        mon.step(now=1.0)
        for t in range(2, 6):             # steady serving, no warmups
            mon.step(now=float(t))
        assert fired == []
        h.observe(0.8)                    # a warmup mid-serving
        mon.step(now=6.0)
        assert [a.name for a in fired] == ["compile_storm"]
        assert fired[0].evidence["new_compiles"] == 1

    @pytest.mark.parametrize("slow,want", [
        (True, ["replica_latency_skew"]),  # one replica 10x its peers
        (False, [])])                      # mild spread only
    def test_replica_latency_skew(self, slow, want):
        reg = MetricsRegistry()
        bus, fired = _bus()
        mon = AnomalyMonitor([ReplicaLatencySkew(ratio=4.0, min_events=8)],
                             registry=reg, bus=bus)
        mon.step(now=0.0)
        for r in range(4):
            h = reg.histogram("replica_flush_seconds", replica=str(r))
            for _ in range(10):
                h.observe(0.10 if (slow and r == 2)
                          else 0.01 * (1.0 + 0.1 * r))
        mon.step(now=1.0)
        assert [a.name for a in fired] == want
        if slow:
            assert fired[0].evidence["worst_replica"] == "2"

    @pytest.mark.parametrize("broken_first", [False, True])
    def test_escalation_trend_fires_on_break_not_steady_rate(
            self, broken_first):
        """A steady rate is silent, a burst fires; a detector that raises
        before it does not stop it."""
        class Boom(QueueDepthRunaway):
            name = "boom"

            def check(self, window):
                raise RuntimeError("detector bug")
        reg = MetricsRegistry()
        bus, fired = _bus()
        dets = ([Boom()] if broken_first else []) + [EscalationTrend()]
        mon = AnomalyMonitor(dets, registry=reg, bus=bus)
        c = reg.counter("pool_events_total", event="escalated")
        for t in range(8):                # steady 2 escalations/interval
            c.inc(2)
            mon.step(now=float(t))
        assert fired == []
        c.inc(12)                         # the burst
        mon.step(now=8.0)
        assert [a.name for a in fired] == ["escalation_trend"]
        assert fired[0].evidence["delta"] == 12.0
        assert reg.gauge("anomaly_active",
                         detector="escalation_trend").value == 1.0


# -- alert bus ------------------------------------------------------------------

class TestAlertBus:
    def _alert(self, name="a1"):
        return Alert(name=name, severity="page", source="slo", message="m")

    def test_publish_counts_and_metric(self):
        reg = MetricsRegistry()
        bus = AlertBus(registry=reg)
        bus.publish(self._alert())
        bus.publish(self._alert())
        assert bus.n_published == 2 and bus.counts() == {"a1": 2}
        assert reg.counter("repro_obs_alerts_total", alert="a1",
                           severity="page").value == 2.0
        assert [a.name for a in bus.history()] == ["a1", "a1"]

    def test_subscriber_error_swallowed_and_counted(self):
        bus, fired = _bus()

        def bad(alert):
            raise OSError("pager down")
        bus.subscribe(bad)
        bus.publish(self._alert())
        assert len(fired) == 1            # other subscribers still served
        assert bus.n_subscriber_errors == 1

    def test_unsubscribe(self):
        bus, fired = _bus()
        got = []
        unsub = bus.subscribe(got.append)
        bus.publish(self._alert())
        unsub()
        bus.publish(self._alert())
        assert len(got) == 1 and len(fired) == 2

    def test_alert_json_roundtrip(self):
        doc = self._alert().to_json()
        assert json.loads(json.dumps(doc)) == doc
        assert doc["name"] == "a1" and doc["source"] == "slo"


# -- label-cardinality bounding -------------------------------------------------

class TestCardinality:
    def test_overflow_folds_into_catchall(self):
        reg = MetricsRegistry(max_label_sets=4)
        for i in range(10):
            reg.counter("hot", user=str(i)).inc()
        snap = {tuple(sorted(e["labels"].items())): e["value"]
                for e in reg.snapshot()["counters"] if e["name"] == "hot"}
        assert snap[tuple(sorted(OVERFLOW_LABELS.items()))] == 6.0
        assert len(snap) == 5             # 4 kept + the catch-all
        assert reg.counter("repro_obs_label_overflow_total").value == 6.0

    def test_existing_label_sets_unaffected_by_cap(self):
        reg = MetricsRegistry(max_label_sets=2)
        a = reg.counter("hot", user="a")
        b = reg.counter("hot", user="b")
        reg.counter("hot", user="c").inc()          # folded
        assert reg.counter("hot", user="a") is a
        assert reg.counter("hot", user="b") is b
        a.inc(3)
        assert a.value == 3.0

    def test_cap_is_per_metric_name(self):
        reg = MetricsRegistry(max_label_sets=2)
        for i in range(4):
            reg.counter("x", k=str(i)).inc()
            reg.counter("y", k=str(i)).inc()
        assert reg.counter("repro_obs_label_overflow_total").value == 4.0


# -- exporters: exposition, sinks, rotation, shutdown ---------------------------

class TestExport:
    def test_prometheus_text_exposition(self):
        reg = MetricsRegistry()
        reg.counter("serve_requests_total", surface="sched").inc(3)
        reg.gauge("live_replicas").set(4)
        reg.histogram("wait_s").observe(0.01)
        text = prometheus_text(registry=reg)
        for line in ("# TYPE serve_requests_total counter",
                     'serve_requests_total{surface="sched"} 3',
                     "# TYPE live_replicas gauge", "# TYPE wait_s summary",
                     'wait_s{quantile="0.5"}', "wait_s_count 1",
                     "wait_s_sum 0.01"):
            assert line in text

    def test_write_metrics_atomic_with_timestamp(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("n").inc()
        out = tmp_path / "metrics.prom"
        write_metrics(str(out), registry=reg)
        lines = out.read_text().splitlines()
        assert lines[0].startswith("# exported_at ")
        assert "n 1" in lines
        assert not list(tmp_path.glob("*.tmp.*"))

    def test_periodic_exporter_writes_and_final_flush(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("beat").inc()
        out = tmp_path / "m.prom"
        exp = PeriodicExporter(str(out), interval_s=0.05,
                               registry=reg).start()
        deadline = time.monotonic() + 5.0
        while exp.n_exports == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        exp.stop()
        assert exp.n_exports >= 2      # >= 1 periodic + the final flush
        assert "beat 1" in out.read_text()

    def test_exporter_stop_flushes_tracer_then_closes_sink(self, tmp_path):
        calls = []

        class FakeTracer:
            def flush(self, timeout=30.0):
                calls.append("flush")
                return True

        class FakeSink:
            def close(self):
                calls.append("close")
        reg = MetricsRegistry()
        reg.counter("beat").inc()
        exp = PeriodicExporter(str(tmp_path / "m.prom"), interval_s=30.0,
                               registry=reg, tracer=FakeTracer(),
                               trace_sink=FakeSink()).start()
        exp.stop()
        exp.stop()                        # idempotent
        assert calls == ["flush", "close"]
        assert "beat 1" in (tmp_path / "m.prom").read_text()

    def test_jsonl_sink_roundtrip(self, tmp_path):
        path = str(tmp_path / "traces.jsonl")
        with JsonlTraceSink(path) as sink:
            sink.write({"trace_id": "r-1"})
            sink.write({"trace_id": "r-2"})
            assert sink.n_written == 2
        sink.write({"trace_id": "r-3"})    # closed: dropped, no raise
        assert [t["trace_id"] for t in load_traces(path)] == ["r-1", "r-2"]

    def test_sink_rotates_and_keeps_every_line(self, tmp_path):
        path = str(tmp_path / "t.jsonl")
        sink = JsonlTraceSink(path, max_bytes=400, keep=10)
        for i in range(50):
            sink.write({"trace_id": f"r-{i}", "pad": "x" * 40})
        sink.close()
        assert sink.n_rotations > 0
        files = [Path(path)] + sorted(tmp_path.glob("t.jsonl.*"))
        ids = []
        for f in files:
            ids += [json.loads(ln)["trace_id"]
                    for ln in f.read_text().splitlines()]
        assert sorted(ids) == sorted(f"r-{i}" for i in range(50))
        assert all(f.stat().st_size <= 400 + 100 for f in files)

    def test_sink_keep_bound_drops_oldest(self, tmp_path):
        path = str(tmp_path / "t.jsonl")
        sink = JsonlTraceSink(path, max_bytes=120, keep=2)
        for i in range(60):
            sink.write({"trace_id": f"r-{i}", "pad": "x" * 40})
        sink.close()
        rotated = sorted(p.name for p in tmp_path.glob("t.jsonl.*"))
        assert rotated == ["t.jsonl.1", "t.jsonl.2"]   # .3+ dropped


# -- Chrome-trace timeline export -----------------------------------------------

def _request_trace(trace_id="r-1", t0=10.0, replica=2):
    rt = RequestTrace(trace_id, "request", t0=t0)
    rt.begin("serve", t0 + 1.0, replica=replica)
    rt.begin("queue", t0 + 1.5)
    rt.begin("serve", t0 + 2.0, replica=replica + 1)
    rt.finish(t0 + 3.0, status="ok")
    return rt.to_json()


class TestChromeTrace:
    FLUSHES = [{"t_start": 10.2, "reason": "deadline", "batch_size": 3,
                "bucket_capacity": 16, "replica_id": 2,
                "prep_s": 0.001, "dispatch_s": 0.004, "sync_s": 0.002,
                "service_s": 0.007},
               {"t_start": 0.0, "reason": "size", "batch_size": 4,
                "bucket_capacity": 16, "replica_id": 2,
                "prep_s": 0.001, "dispatch_s": 0.004, "sync_s": 0.002,
                "service_s": 0.007}]      # pre-timeline record: skipped
    WARMUP = [{"replica": 0, "path": "dense", "bucket": 16, "batch": 4,
               "seconds": 1.5, "t0": 9.0}]

    def test_export_validates_with_exact_span_sums(self):
        doc = chrome_trace([_request_trace(f"r-{i}") for i in range(3)],
                           flushes=self.FLUSHES, warmup=self.WARMUP)
        verdict = validate_chrome_trace(doc)
        assert verdict["ok"], verdict
        assert verdict["n_async_trees"] == 3
        assert verdict["tiling_violations"] == 0
        assert verdict["sum_violations"] == 0
        assert doc["otherData"]["n_flushes_skipped"] == 1

    def test_replica_lanes_and_router_pids(self):
        doc = chrome_trace([_request_trace()], flushes=self.FLUSHES,
                           warmup=self.WARMUP)
        ev = [e for e in doc["traceEvents"] if e["ph"] != "M"]
        assert {e["pid"] for e in ev if e["ph"] in ("b", "e")} == {1}
        flush = [e for e in ev if e["ph"] == "X"
                 and e["name"].startswith("flush")]
        assert flush and all(e["pid"] == 102 for e in flush)
        segs = [e["name"] for e in ev if e["ph"] == "X"
                and e["name"] in ("prep", "dispatch", "sync")]
        assert sorted(segs) == ["dispatch", "prep", "sync"]
        compiles = [e for e in ev if e["ph"] == "X"
                    and e["name"].startswith("compile")]
        assert compiles and compiles[0]["pid"] == 100
        names = {e["args"]["name"] for e in doc["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "process_name"}
        assert any("router" in n for n in names)
        assert any("replica" in n for n in names)

    @pytest.mark.parametrize("corrupt", ["tiling", "schema"])
    def test_validator_catches_corruption(self, corrupt):
        doc = chrome_trace([_request_trace()])
        if corrupt == "tiling":
            # shift one child boundary: the tiling (and the sum) break
            spans = [e for e in doc["traceEvents"] if e["ph"] in ("b", "e")]
            [e for e in spans if e["ph"] == "e"][1]["ts"] += 40.0
        else:
            del doc["traceEvents"][-1]["ts"]
        verdict = validate_chrome_trace(doc)
        assert not verdict["ok"]
        if corrupt == "tiling":
            assert verdict["tiling_violations"] >= 1
        else:
            assert verdict["n_schema_errors"] >= 1


# -- the JAX package's scripts on the port's files ------------------------------

class TestScripts:
    def test_trace_report_renders_the_ports_timeline(self, tmp_path):
        jsonl = tmp_path / "traces.jsonl"
        with JsonlTraceSink(str(jsonl)) as sink:
            for i in range(3):
                sink.write(_request_trace(f"r-{i}"))
        out = tmp_path / "chrome.json"
        proc = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "trace_report.py"),
             str(jsonl), "--chrome-trace", str(out)],
            capture_output=True, text=True, timeout=120, env=SCRIPT_ENV)
        assert proc.returncode == 0, proc.stderr
        assert "3 trace(s)" in proc.stdout
        doc = json.loads(out.read_text())
        assert validate_chrome_trace(doc)["ok"]
        assert doc["otherData"]["n_traces"] == 3

    def test_obs_top_parses_the_ports_exposition(self, tmp_path):
        reg = MetricsRegistry()
        reg.gauge("cluster_queue_depth", replica="0").set(3)
        reg.counter("serve_requests_total", surface="pool",
                    event="submitted").inc(7)
        reg.gauge("slo_breached", slo="shed_rate").set(1)
        path = tmp_path / "m.prom"
        write_metrics(str(path), registry=reg)
        proc = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "obs_top.py"),
             str(path), "--once"],
            capture_output=True, text=True, timeout=60, env=SCRIPT_ENV)
        assert proc.returncode == 0, proc.stderr
        assert "queue depth" in proc.stdout
        assert "submitted=7" in proc.stdout
        assert "BREACH" in proc.stdout


# -- seeded chaos replay on CPU replicas: every fault class, clean arm silent ---

CHAOS_REQUIRED = {"escalation_rate", "replica_failure", "replica_stall",
                  "md_energy_drift", "session_frame_loss"}
# anomaly detectors reacting to the same injected faults are legitimate
CHAOS_ALLOWED = CHAOS_REQUIRED | {d.name for d in default_detectors()}


class TestChaosReplay:
    @pytest.fixture(scope="class")
    def so3_bits(self):
        from repro_torch.guardrails import ForceEnvelope, GuardrailConfig
        from repro_torch.models import so3krates as so3
        from repro_torch.serving import Graph, QuantizedEngine, ServeConfig
        from repro_torch.serving.qparams import quantize_so3_params
        cfg = so3.So3kratesConfig(feat=16, vec_feat=4, n_layers=1, n_rbf=4,
                                  dir_bits=6, cutoff=3.0)
        params = so3.init_params(cfg, 0, device="cpu")
        qp = {t: quantize_so3_params(params, t) for t in ("w4a8", "w8a8")}
        serve4 = ServeConfig(mode="w4a8", bucket_sizes=(16,), max_batch=4,
                             path="dense")
        serve8 = dataclasses.replace(serve4, mode="w8a8")
        hair = GuardrailConfig(envelope=ForceEnvelope(limits=((16, 1e-9),)))
        return {"cfg": cfg, "qp": qp, "serve4": serve4, "serve8": serve8,
                "hair": hair, "Graph": Graph, "Engine": QuantizedEngine}

    def _graph(self, bits, n=10, seed=0):
        rng = np.random.default_rng(seed)
        side = (n / 0.1) ** (1.0 / 3.0)
        return bits["Graph"](
            species=rng.integers(0, bits["cfg"].n_species, n)
            .astype(np.int32),
            coords=rng.uniform(0, side, size=(n, 3)).astype(np.float32))

    def _engine(self, bits, tier, **kw):
        serve = bits["serve4" if tier == "w4a8" else "serve8"]
        return bits["Engine"].from_quantized(bits["cfg"], bits["qp"][tier],
                                             serve, device="cpu", **kw)

    def _run_arm(self, bits, tmp_path, chaos: bool):
        from repro_torch.cluster import ClusterConfig, ClusterPool
        from repro_torch.md.engine import MDConfig
        from repro_torch.server import RequestHandle
        from repro_torch.sessions import SessionConfig, SessionManager
        REGISTRY.reset()
        if chaos:
            engines = [self._engine(bits, "w4a8", guardrails=bits["hair"])
                       for _ in range(2)]
            engines += [self._engine(bits, "w8a8") for _ in range(2)]
        else:
            engines = [self._engine(bits, "w8a8") for _ in range(4)]
        # warmup=True: every shape runs before serving, so a first run
        # cannot read as a stall
        cluster = ClusterConfig(n_replicas=4, max_batch=4, deadline_ms=2.0,
                                warmup=True, max_escalations=1,
                                max_queue=64, stall_timeout_s=0.3,
                                watchdog_interval_s=0.1, probation_s=0.1)
        pool = ClusterPool(engines, cluster)
        bus = AlertBus(registry=REGISTRY)
        fired = []
        bus.subscribe(fired.append)
        slos = default_slos(fast_window_s=0.6, slow_window_s=1.8,
                            latency_p99_s=30.0, allow_partial=True)
        monitor = HealthMonitor(
            [SLOEvaluator(slos, registry=REGISTRY, bus=bus),
             AnomalyMonitor(default_detectors(), registry=REGISTRY,
                            bus=bus)],
            interval_s=0.1).start()
        pool.watch_alerts(bus)
        try:
            handles = []
            for i in range(12):           # paced background traffic
                handles.append(pool.submit(self._graph(bits, seed=100 + i)))
                time.sleep(0.04)
            if chaos:
                # fault 1: requests pinned to the hair-trigger w4a8
                # replicas re-run a tier up
                for k in range(3):
                    h = RequestHandle(self._graph(bits, seed=500 + k),
                                      time.monotonic(), bucket_capacity=16)
                    assert pool._replicas[0].try_submit(h)
                    handles.append(h)
                # fault 2: an in-flight replica kill -> failover requeue
                rep3 = pool._replicas[3]
                pool.kill_replica(3, mode="in_flight")
                h = RequestHandle(self._graph(bits, seed=600),
                                  time.monotonic(), bucket_capacity=16)
                assert rep3.try_submit(h)
                handles.append(h)
                # fault 3: an engine-lock stall -> watchdog quarantine
                rep1 = pool._replicas[1]
                rep1.inject_stall(1.5)
                h = RequestHandle(self._graph(bits, seed=700),
                                  time.monotonic(), bucket_capacity=16)
                assert rep1.try_submit(h)
                handles.append(h)
            for h in handles:
                h.result(timeout=WAIT_S)
            pool_alerts = pool.stats()["alerts"]
        finally:
            pool.close()

        # fault 4: an MD session, drifting (chaos) or clean, on a
        # watchdog-free pool (a chunk is one long unit of worker time)
        md_pool = ClusterPool([self._engine(bits, "w8a8") for _ in range(2)],
                              ClusterConfig(n_replicas=2, max_batch=4,
                                            warmup=False, max_queue=64))
        try:
            md = MDConfig(mode="w8a8", dt_fs=0.25, record_every=10,
                          drift_limit=1e-12 if chaos else None)
            scfg = SessionConfig(n_steps=40, chunk_steps=20,
                                 record_every=10, checkpoint_every=1,
                                 md=md)
            rng = np.random.default_rng(13)
            n = 10
            side = (n / 0.1) ** (1.0 / 3.0)
            mgr = SessionManager(md_pool, str(tmp_path / ("c" if chaos
                                                          else "clean")))
            s = mgr.start(
                rng.integers(0, bits["cfg"].n_species, n).astype(np.int32),
                rng.uniform(0, side, size=(n, 3)).astype(np.float32),
                np.full(n, 12.0, np.float32), seed=5, config=scfg)
            if chaos:
                with pytest.raises(Exception):   # wait re-raises the
                    s.wait(WAIT_S)               # session's fatal error
                assert s.status == "failed"
            else:
                assert s.wait(WAIT_S) == "done"
            mgr.close()
            time.sleep(0.5)               # let the windows catch up
        finally:
            monitor.stop(final_step=True)
            md_pool.close()
        # no stepper or SLO raised along the way
        assert not [e for e in REGISTRY.snapshot()["counters"]
                    if e["name"] == "repro_obs_health_eval_errors_total"]
        return fired, pool_alerts

    def test_chaos_arm_fires_every_fault_class(self, so3_bits, tmp_path):
        fired, pool_alerts = self._run_arm(so3_bits, tmp_path, chaos=True)
        names = {a.name for a in fired}
        missing = CHAOS_REQUIRED - names
        assert not missing, f"undetected fault classes: {missing}"
        unexpected = names - CHAOS_ALLOWED
        assert not unexpected, f"unattributed alerts: {unexpected}"
        by_name = {a.name: a for a in fired}
        assert by_name["md_energy_drift"].value > 1.0
        assert by_name["replica_stall"].evidence["delta"] >= 1.0
        assert by_name["escalation_rate"].evidence["fast_burn"] >= 1.0
        # the pool saw the one-shot phase's verdicts through watch_alerts
        assert pool_alerts["n_seen"] >= 1
        assert {a["name"] for a in pool_alerts["recent"]} & names

    def test_clean_arm_fires_nothing(self, so3_bits, tmp_path):
        fired, _ = self._run_arm(so3_bits, tmp_path, chaos=False)
        assert fired == [], ("clean-arm false positives: "
                             f"{[a.name for a in fired]}")
