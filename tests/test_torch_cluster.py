"""The port's multi-replica cluster (``repro_torch.cluster``) against the
JAX package's ``repro.cluster``, on the CPU (replicas pinned with
``device="cpu"``; the card's own cases are in ``test_torch_cuda.py``).

* **Routing identity**: molecules through a 4-replica pool equal the
  port's direct engine within 1e-6, and the JAX engine on the same numpy
  params within 1e-5 of the largest |value|, whichever replica served.
* **The semantics of ``tests/test_cluster.py``**: replica tags and load
  spread, bucket affinity, oversize and closed-pool refusals, the
  degenerate single replica, shedding with ``retry_after_s``, a rolling
  swap mid-traffic to a JAX-written artifact with zero drops (bit-exact
  to the port's ``load_engine``, within 1e-5 of the JAX engine on that
  file), the mismatch refusals, and the four failover cases.
* **``pick_devices``**: ``cuda:0..k-1`` round robin with a warning when
  cards are fewer than replicas, an explicit device pins every replica.
* **The cluster cases of ``tests/test_guardrails.py``**: tiered
  escalation (bit-identical to a direct w8a8 call, the budget then a
  typed fatal, the stats), the circuit breaker (waiting for the
  respawn and the probation, the last effects of the quarantine, not
  only the trip) and the stall watchdog.
* **The cluster trace cases of ``tests/test_obs.py``**: the escalation
  hop and the in-flight-kill requeue.
* **The launch counters** keep an exact count under eight threads, and
  tally each thread's launches under its role; a replica's worker names
  its flushes, warmup runs and session chunks so.

Counts and reasons are asserted, never wall-clock margins; every
``result()`` has a timeout.
"""
import ast
import dataclasses
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import so3krates as jso3
from repro.server import load_engine as j_load_engine
from repro.server import save_artifact as j_save_artifact
from repro.serving import QuantizedEngine as JEngine
from repro.serving import ServeConfig as JServe
from repro_torch.cluster import (ClusterConfig, ClusterPool, Replica,
                                 pick_devices)
from repro_torch.guardrails import (EscalationRecord, ForceEnvelope,
                                    GuardrailConfig, GuardrailViolation)
from repro_torch.kernels import _launch
from repro_torch.models import so3krates as tso3
from repro_torch.obs import TRACER, configure_tracing
from repro_torch.server import (ArtifactError, RequestHandle,
                                SchedulerClosed, SchedulerOverloaded,
                                load_engine, save_artifact)
from repro_torch.serving import Graph, QuantizedEngine, ServeConfig
from repro_torch.serving.qparams import quantize_so3_params
from repro_torch.weights import params_from_numpy

CFG_KW = dict(feat=16, vec_feat=4, n_layers=1, n_rbf=4, dir_bits=6,
              cutoff=3.0)
JCFG = jso3.So3kratesConfig(**CFG_KW)
CFG = tso3.So3kratesConfig(**CFG_KW)
SERVE = ServeConfig(mode="w8a8", bucket_sizes=(16, 32), max_batch=8)
SERVE16 = dataclasses.replace(SERVE, bucket_sizes=(16,))
# the dense path carries NaN coordinates (the sparse host edge build
# drops NaN-distance pairs), so the poison cases force it, as JAX's do
SERVE4 = ServeConfig(mode="w4a8", bucket_sizes=(16,), max_batch=4,
                     path="dense")
SERVE8 = dataclasses.replace(SERVE4, mode="w8a8")
# hair-trigger envelope: every finite result flags "force_outlier"
HAIR = GuardrailConfig(envelope=ForceEnvelope(limits=((16, 1e-9),)))
WAIT_S = 120
# the port against the JAX engine on the same params, relative to the
# largest |value| (the serving parity rule)
CROSS_REL = 1e-5


def _graphs(ns, seed=0, density=0.1):
    rng = np.random.default_rng(seed)
    out = []
    for n in ns:
        side = (n / density) ** (1.0 / 3.0)
        out.append(Graph(
            species=rng.integers(0, CFG.n_species, n).astype(np.int32),
            coords=rng.uniform(0, side, (n, 3)).astype(np.float32)))
    return out


def _poison(seed=3):
    (g,) = _graphs([10], seed)
    coords = g.coords.copy()
    coords[0] = np.nan
    return Graph(species=g.species, coords=coords)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _pool(engines=None, n=2, serve=SERVE16, **kw):
    kw.setdefault("deadline_ms", 5.0)
    kw.setdefault("warmup", False)
    if engines is not None:
        return ClusterPool(engines, ClusterConfig(n_replicas=len(engines),
                                                  **kw))
    return ClusterPool.from_config(CFG, serve=serve, device="cpu",
                                   cluster=ClusterConfig(n_replicas=n, **kw))


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jso3.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      JCFG)
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                 "cpu")


@pytest.fixture(scope="module")
def qp(params):
    return {t: quantize_so3_params(params[1], t) for t in ("w4a8", "w8a8")}


@pytest.fixture(scope="module")
def pool(params):
    """4 replicas on the CPU, warmed once, on the JAX params."""
    p = ClusterPool.from_config(
        CFG, params=params[1], serve=SERVE, device="cpu",
        cluster=ClusterConfig(n_replicas=4, deadline_ms=5.0))
    yield p
    p.close()


@pytest.fixture(scope="module")
def ref_engine(params):
    return QuantizedEngine.from_config(CFG, params[1], serve=SERVE,
                                       device="cpu")


@pytest.fixture(scope="module")
def artifacts(params, tmp_path_factory):
    """v1 written by the port from the JAX params, v2 by the JAX package
    from other weights (seed 99)."""
    d = tmp_path_factory.mktemp("cluster_artifacts")
    paths = {"v1": str(d / "v1.npz"), "v2": str(d / "v2.npz")}
    save_artifact(paths["v1"], QuantizedEngine.from_config(
        CFG, params[1], serve=SERVE, device="cpu"))
    j_save_artifact(paths["v2"], JEngine.from_config(
        JCFG, serve=JServe(mode="w8a8", bucket_sizes=(16, 32), max_batch=8),
        seed=99))
    return paths


class TestRoutingIdentity:
    def test_mixed_size_traffic_matches_direct_and_jax(self, pool,
                                                       ref_engine, params):
        graphs = _graphs([5, 30, 12, 7, 25, 16, 9, 32, 11, 28, 6, 19],
                         seed=1)
        results = pool.infer(graphs, timeout_s=WAIT_S)
        jeng = JEngine.from_config(JCFG, params[0], serve=JServe(
            mode="w8a8", bucket_sizes=(16, 32), max_batch=8))
        for g, r in zip(graphs, results):
            (direct,) = ref_engine.infer_batch([g])
            assert abs(r.energy - direct.energy) <= 1e-6
            np.testing.assert_allclose(r.forces, direct.forces, atol=1e-6)
            assert r.n_atoms == g.n_atoms
        jres = jeng.infer_batch(graphs)
        assert _rel([r.energy for r in results],
                    [j.energy for j in jres]) <= CROSS_REL
        assert _rel(np.concatenate([r.forces for r in results]),
                    np.concatenate([np.asarray(j.forces) for j in jres])
                    ) <= CROSS_REL

    def test_replica_id_tagged_into_results_and_stats(self, pool):
        graphs = _graphs([10, 24, 12, 30, 8, 26, 14, 20] * 3, seed=2)
        results = pool.infer(graphs, timeout_s=WAIT_S)
        used = {r.replica_id for r in results}
        assert used <= set(range(pool.n_replicas))
        assert len(used) > 1, "JSQ router never spread load"
        stats = pool.stats()
        assert stats["n_completed"] >= len(graphs)
        assert {int(k) for k in stats["per_replica"]} >= used
        for snap in stats["replicas"]:
            assert snap["alive"] and snap["heartbeat_age_s"] >= 0.0
            assert snap["device"] == "cpu"

    def test_bucket_affinity_prefers_samebucket_queue(self, pool):
        rep = pool._route(16)
        h = pool.submit(_graphs([10], seed=3)[0])
        target = pool._route(16)
        if rep.depth_of(16) > 0:          # not yet flushed
            assert target.replica_id == rep.replica_id
        h.result(timeout=WAIT_S)

    def test_oversize_molecule_raises_at_submit(self, pool):
        with pytest.raises(ValueError, match="exceeds the largest"):
            pool.submit(_graphs([100], seed=4)[0])

    def test_single_replica_pool_is_degenerate_scheduler(self, params,
                                                         ref_engine):
        p = ClusterPool.from_config(
            CFG, params=params[1], serve=SERVE, device="cpu",
            cluster=ClusterConfig(n_replicas=1, deadline_ms=5.0,
                                  warmup=False))
        graphs = _graphs([9, 22, 13], seed=5)
        with p:
            results = p.infer(graphs, timeout_s=WAIT_S)
        for g, r in zip(graphs, results):
            (direct,) = ref_engine.infer_batch([g])
            assert abs(r.energy - direct.energy) <= 1e-6
            assert r.replica_id == 0


class TestPickDevices:
    def test_explicit_device_pins_every_replica(self):
        assert pick_devices(3, "cpu") == [torch.device("cpu")] * 3

    @pytest.mark.parametrize("n_cards,want", [
        (2, [0, 1, 0]), (1, [0, 0, 0]), (4, [0, 1, 2])])
    def test_round_robin_over_the_cards(self, monkeypatch, n_cards, want):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
        if n_cards < 3:
            with pytest.warns(UserWarning, match="share devices"):
                devs = pick_devices(3)
        else:
            devs = pick_devices(3)
        assert devs == [torch.device("cuda", i) for i in want]

    def test_no_card_and_no_device_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pick_devices(2)

    def test_replicas_sit_on_their_devices(self, pool):
        for rep in pool._replicas:
            assert rep.device == torch.device("cpu") and rep.stream is None
            leaf = next(iter(rep.engine.qparams.values()))
            data = leaf.data if hasattr(leaf, "data") else leaf
            assert data.device == rep.device


class TestBoundedAdmission:
    def test_shed_with_retry_after_when_queues_full(self):
        p = _pool(n=2, max_batch=8, deadline_ms=60_000.0, max_queue=2)
        graphs = _graphs([10] * 5, seed=6)
        admitted = [p.submit(g) for g in graphs[:4]]   # 2 per replica
        with pytest.raises(SchedulerOverloaded) as ei:
            p.submit(graphs[4])
        assert ei.value.retry_after_s > 0
        assert p.stats()["n_shed"] == 1
        p.close()                                       # drains the 4
        for h in admitted:
            assert np.isfinite(h.result(timeout=WAIT_S).energy)

    def test_closed_pool_raises_scheduler_closed(self):
        p = _pool(n=1)
        p.close()
        with pytest.raises(SchedulerClosed):
            p.submit(_graphs([8], seed=7)[0])


class TestHotSwap:
    def test_rolling_swap_to_a_jax_artifact_mid_traffic(self, artifacts):
        """v1 -> v2 (written by the JAX package) under live traffic: no
        drops, version-tagged results, post-swap results bit-exact with
        the port's load_engine(v2) and within 1e-5 of the JAX engine."""
        pool = ClusterPool.from_artifact(
            artifacts["v1"], device="cpu",
            cluster=ClusterConfig(n_replicas=2, deadline_ms=5.0))
        v1_tag = pool._replicas[0].engine.artifact_version
        rng = np.random.default_rng(8)
        stop = threading.Event()
        completed, errors = [], []

        def client():
            while not stop.is_set():
                (g,) = _graphs([int(rng.integers(5, 17))],
                               seed=int(rng.integers(1 << 30)))
                try:
                    completed.append(pool.submit(g).result(timeout=WAIT_S))
                except BaseException as e:   # pragma: no cover - fail loud
                    errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(2)]
        for t in threads:
            t.start()
        while len(completed) < 10 and not errors:
            time.sleep(0.01)
        report = pool.swap_artifact(artifacts["v2"])
        n_at_swap = len(completed)
        while len(completed) < n_at_swap + 10 and not errors:
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join()
        assert not errors
        assert [r["replica_id"] for r in report["replicas"]] == [0, 1]
        v2_tag = report["version_tag"]
        assert v2_tag != v1_tag
        assert {r.artifact_version for r in completed} <= {v1_tag, v2_tag}
        assert any(r.artifact_version == v2_tag for r in completed)
        assert pool.stats()["n_engines_retired"] == 2
        ref2 = load_engine(artifacts["v2"], device="cpu")
        jref2 = j_load_engine(artifacts["v2"])
        graphs = _graphs([6, 12, 16], seed=9)
        served = pool.infer(graphs, timeout_s=WAIT_S)
        for g, r in zip(graphs, served):
            (direct,) = ref2.infer_batch([g])
            assert r.energy == direct.energy            # bit-exact
            np.testing.assert_array_equal(r.forces, direct.forces)
            assert r.artifact_version == v2_tag
        jres = jref2.infer_batch(graphs)
        assert _rel([r.energy for r in served],
                    [j.energy for j in jres]) <= CROSS_REL
        pool.close()

    def test_swap_keeps_the_replicas_guardrails(self, artifacts):
        guard = GuardrailConfig(check_finite=True, on_flag="mark")
        art = load_engine(artifacts["v1"], device="cpu")
        pool = _pool([QuantizedEngine.from_quantized(
            CFG, art.qparams, art.serve, device="cpu", guardrails=guard)])
        with pool:
            pool.swap_artifact(artifacts["v2"], warmup=False)
            assert pool._replicas[0].engine.guardrails == guard

    def test_swap_rejects_mode_and_architecture_mismatch(self, artifacts,
                                                         tmp_path):
        pool = ClusterPool.from_artifact(
            artifacts["v1"], device="cpu",
            cluster=ClusterConfig(n_replicas=1, warmup=False))
        other = QuantizedEngine.from_config(
            tso3.So3kratesConfig(feat=8, vec_feat=4, n_layers=1, n_rbf=4,
                                 dir_bits=6, cutoff=3.0),
            serve=SERVE, device="cpu")
        bad_arch = str(tmp_path / "arch.npz")
        save_artifact(bad_arch, other)
        with pytest.raises(ArtifactError, match="model config"):
            pool.swap_artifact(bad_arch)
        w4 = QuantizedEngine.from_config(
            CFG, serve=dataclasses.replace(SERVE, mode="w4a8"), device="cpu")
        bad_mode = str(tmp_path / "mode.npz")
        save_artifact(bad_mode, w4)
        with pytest.raises(ArtifactError, match="mode"):
            pool.swap_artifact(bad_mode)
        pool.close()


class TestFailover:
    def test_killed_replica_requeues_zero_loss(self):
        pool = _pool(n=2, warmup=True)
        graphs = _graphs([8, 12, 15, 9, 11, 14] * 4, seed=10)
        handles = [pool.submit(g) for g in graphs[:12]]
        pool.kill_replica(0, mode="in_flight")
        handles += [pool.submit(g) for g in graphs[12:]]
        results = [h.result(timeout=WAIT_S) for h in handles]
        assert all(np.isfinite(r.energy) for r in results)
        stats = pool.stats()
        assert stats["n_live"] == 1
        assert stats["router"]["n_failures"] == 1
        (g,) = _graphs([11], seed=11)
        assert pool.infer([g], timeout_s=WAIT_S)[0].replica_id == 1
        pool.close()

    def test_poison_request_does_not_cascade_kill(self):
        pool = _pool(n=2)
        rep0 = pool._replicas[0]          # bucket 16's home replica
        real_infer = rep0.engine.infer_batch
        calls = {"n": 0}

        def flaky(graphs, on_flag=None):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient engine failure")
            return real_infer(graphs, on_flag=on_flag)

        rep0.engine.infer_batch = flaky
        (g,) = _graphs([10], seed=13)
        with pytest.raises(RuntimeError, match="transient"):
            pool.submit(g).result(timeout=WAIT_S)
        r = pool.submit(g).result(timeout=WAIT_S)
        assert np.isfinite(r.energy) and r.replica_id == 0
        stats = pool.stats()
        assert stats["n_live"] == 2
        assert stats["router"]["n_failures"] == 0
        assert stats["replicas"][0]["n_errors"] == 1
        pool.close()

    def test_persistently_broken_replica_fails_over(self):
        pool = _pool(n=2)

        def dead(graphs, on_flag=None):
            raise RuntimeError("device lost")

        pool._replicas[0].engine.infer_batch = dead
        (g,) = _graphs([10], seed=14)
        errors = 0
        for _ in range(Replica.MAX_CONSECUTIVE_ERRORS + 2):
            try:
                r = pool.submit(g).result(timeout=WAIT_S)
                assert r.replica_id == 1      # survivor took over
            except RuntimeError:
                errors += 1
        assert errors == Replica.MAX_CONSECUTIVE_ERRORS
        assert pool.stats()["n_live"] == 1
        assert pool.submit(g).result(timeout=WAIT_S).replica_id == 1
        pool.close()

    def test_all_replicas_dead_resolves_not_hangs(self):
        pool = _pool(n=2, deadline_ms=60_000.0, max_requeues=2)
        graphs = _graphs([10, 12, 9], seed=12)
        handles = [pool.submit(g) for g in graphs]
        pool.kill_replica(0)
        pool.kill_replica(1)
        for h in handles:
            with pytest.raises(Exception):
                h.result(timeout=WAIT_S)
        with pytest.raises(SchedulerClosed):
            pool.submit(graphs[0])
        pool.close()

    def test_worker_dying_outside_a_flush_fails_over(self, monkeypatch):
        """A replica whose serving loop raises outside a unit of work
        hands what it holds to the pool, which requeues it: nothing
        hangs (the JAX replica's thread would just die)."""
        plain, go = Replica._serve, threading.Event()

        def broken(self):
            if self.replica_id != 0:
                return plain(self)
            go.wait(WAIT_S)
            raise RuntimeError("serving loop bug")
        monkeypatch.setattr(Replica, "_serve", broken)
        pool = _pool(n=2)
        h = RequestHandle(_graphs([10], seed=15)[0], time.monotonic(),
                          bucket_capacity=16)
        assert pool._replicas[0].try_submit(h)
        go.set()
        assert h.result(timeout=WAIT_S).replica_id == 1
        assert h.n_requeues == 1
        stats = pool.stats()
        assert stats["n_live"] == 1 and stats["router"]["n_failures"] == 1
        pool.close()


# -- guardrails ---------------------------------------------------------------

@pytest.fixture
def tiered_pool(qp):
    """Two hair-trigger w4a8 traffic replicas + one w8a8 escalation
    replica: every finite w4a8 result flags suspect and escalates."""
    engines = [QuantizedEngine.from_quantized(CFG, qp["w4a8"], SERVE4,
                                              device="cpu", guardrails=HAIR)
               for _ in range(2)]
    engines.append(QuantizedEngine.from_quantized(CFG, qp["w8a8"], SERVE8,
                                                  device="cpu"))
    pool = _pool(engines, max_batch=4, deadline_ms=2.0, max_escalations=1)
    yield pool
    pool.close()


class TestTieredEscalation:
    def test_escalated_result_is_bit_identical_to_direct_w8a8(
            self, tiered_pool, qp):
        (g,) = _graphs([10], seed=11)
        r = tiered_pool.submit(g).result(timeout=WAIT_S)
        assert len(r.escalations) == 1
        rec = r.escalations[0]
        assert isinstance(rec, EscalationRecord)
        assert (rec.from_tier, rec.to_tier, rec.reason) == (
            "w4a8", "w8a8", "force_outlier")
        assert r.replica_id == 2 and r.flags == ()
        direct = QuantizedEngine.from_quantized(
            CFG, qp["w8a8"], SERVE8, device="cpu").infer_batch([g])[0]
        assert r.energy == direct.energy
        assert np.array_equal(r.forces, direct.forces)

    def test_escalation_budget_then_typed_fatal(self, tiered_pool):
        h = tiered_pool.submit(_poison(seed=23))
        with pytest.raises(GuardrailViolation) as ei:
            h.result(timeout=WAIT_S)
        assert ei.value.reason == "nonfinite"
        assert ei.value.detail["mode"] == "w8a8"   # failed at the top hop
        assert [e.reason for e in h.escalations] == ["nonfinite"]

    def test_stats_expose_tiers_and_escalations(self, tiered_pool):
        for i in range(2):
            tiered_pool.submit(_graphs([10], seed=30 + i)[0]).result(
                timeout=WAIT_S)
        st = tiered_pool.stats()
        assert st["tiers"] == {"w4a8": 2, "w8a8": 1}
        gr = st["guardrails"]
        assert gr["n_flagged"] == 2 and gr["n_escalated"] == 2
        assert gr["detectors"]["flagged_outlier"] == 2

    def test_from_tiers_orders_replicas_cheapest_first(self, params):
        pool = ClusterPool.from_tiers(
            CFG, params=params[1], serve=SERVE4, device="cpu",
            tier_plan={"fp32": 1, "w4a8": 2, "w8a8": 1},
            cluster=ClusterConfig(max_batch=4, warmup=False))
        with pool:
            assert [r.tier for r in pool._replicas] == [
                "w4a8", "w4a8", "w8a8", "fp32"]
            assert pool.serve.mode == "w4a8"
            r = pool.infer(_graphs([9], seed=2), timeout_s=WAIT_S)[0]
            assert r.replica_id in (0, 1)


class TestCircuitBreaker:
    def test_flag_storm_trips_breaker_and_respawns(self, qp):
        """Every result flags suspect: the breaker quarantines a replica
        and cold-restarts it on probation, and every request resolves.
        The respawn and the probation are the quarantine's last effects,
        so the test waits for them (with a timeout), not for the trip."""
        engines = [QuantizedEngine.from_quantized(CFG, qp["w8a8"], SERVE8,
                                                  device="cpu",
                                                  guardrails=HAIR)
                   for _ in range(2)]
        pool = _pool(engines, max_batch=4, deadline_ms=2.0,
                     breaker_window=8, breaker_flag_rate=0.5,
                     breaker_min_events=4, watchdog_interval_s=0.05,
                     probation_s=30.0, max_quarantines=1)
        try:
            delivered = 0
            for i in range(16):
                if pool.stats()["guardrails"]["n_breaker_trips"] >= 1:
                    break
                try:
                    r = pool.submit(_graphs([10], seed=i)[0]).result(
                        timeout=WAIT_S)
                except (SchedulerOverloaded, SchedulerClosed):
                    time.sleep(0.05)
                    continue
                assert np.isfinite(r.energy)
                assert [f.reason for f in r.flags] == ["force_outlier"]
                delivered += 1
            assert delivered >= 4
            deadline = time.monotonic() + WAIT_S
            while time.monotonic() < deadline:
                st = pool.stats()
                if (st["guardrails"]["n_respawned"] >= 1
                        and any(s["on_probation"] for s in st["replicas"])):
                    break
                time.sleep(0.02)
            gr = pool.stats()["guardrails"]
            assert gr["n_breaker_trips"] >= 1
            assert gr["n_quarantined"] == gr["n_respawned"] >= 1
            assert any(s["on_probation"] for s in pool.stats()["replicas"])
        finally:
            pool.close()


class TestStallWatchdog:
    def test_stalled_worker_quarantined_requests_failover(self, qp):
        pool = _pool([QuantizedEngine.from_quantized(CFG, qp["w8a8"],
                                                     SERVE8, device="cpu")
                      for _ in range(2)],
                     max_batch=4, deadline_ms=2.0, warmup=True,
                     stall_timeout_s=0.4, watchdog_interval_s=0.05,
                     probation_s=0.1)
        try:
            rep0 = pool._replicas[0]
            rep0.inject_stall(30.0)
            pinned = RequestHandle(_graphs([10], seed=41)[0],
                                   time.monotonic(), bucket_capacity=16)
            assert rep0.try_submit(pinned)
            others = [pool.submit(g) for g in _graphs([9, 10, 11], seed=50)]
            results = [pinned.result(timeout=WAIT_S)] + [
                h.result(timeout=WAIT_S) for h in others]
            assert all(np.isfinite(r.energy) for r in results)
            assert pinned.n_requeues >= 1 and pinned.replica_id == 1
            deadline = time.monotonic() + WAIT_S
            while (pool.stats()["guardrails"]["n_respawned"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            gr = pool.stats()["guardrails"]
            assert gr["n_stalls_detected"] >= 1
            assert gr["n_quarantined"] >= 1 and gr["n_respawned"] >= 1
            fresh = pool._replicas[0]
            assert fresh is not rep0 and fresh.device == rep0.device
        finally:
            pool.close()


# -- traces -------------------------------------------------------------------

@pytest.fixture
def traced():
    configure_tracing(enabled=True)
    TRACER.reset()
    yield TRACER
    configure_tracing(enabled=False)
    TRACER.reset()


def _assert_complete(doc):
    """One orphan-free span tree whose children tile [t0, t1] exactly."""
    spans = doc["spans"]
    root, children = spans[0], spans[1:]
    assert root["parent_id"] is None and root["t1"] is not None
    assert children, "trace has no child spans"
    for s in children:
        assert s["parent_id"] == root["span_id"] and s["t1"] is not None
    assert children[0]["t0"] == root["t0"]
    assert children[-1]["t1"] == root["t1"]
    for a, b in zip(children, children[1:]):
        assert a["t1"] == b["t0"]


class TestTraces:
    def test_escalated_request_trace_attributes_the_hop(self, qp, traced):
        engines = [QuantizedEngine.from_quantized(CFG, qp["w4a8"], SERVE4,
                                                  device="cpu",
                                                  guardrails=HAIR)
                   for _ in range(2)]
        engines.append(QuantizedEngine.from_quantized(CFG, qp["w8a8"],
                                                      SERVE8, device="cpu"))
        pool = _pool(engines, max_batch=4, deadline_ms=2.0,
                     max_escalations=1)
        try:
            r = pool.submit(_graphs([10], seed=11)[0]).result(timeout=WAIT_S)
            assert len(r.escalations) == 1 and r.replica_id == 2
            assert r.trace_id
        finally:
            pool.close()
        doc = {d["trace_id"]: d for d in traced.drain()}[r.trace_id]
        _assert_complete(doc)
        assert doc["hops"] == 1 and doc["attrs"]["n_escalations"] == 1
        (esc,) = [e for e in doc["events"] if e["name"] == "escalated"]
        assert esc["attrs"]["from_tier"] == "w4a8"
        assert esc["attrs"]["reason"] == "force_outlier"
        hop1 = [s for s in doc["spans"][1:] if s["attrs"]["hop"] == 1]
        assert [s["name"] for s in hop1] == ["queue", "serve"]
        assert hop1[-1]["attrs"]["tier"] == "w8a8"
        assert hop1[-1]["attrs"]["replica"] == 2

    def test_killed_in_flight_request_traces_the_requeue(self, qp, traced):
        pool = _pool([QuantizedEngine.from_quantized(CFG, qp["w8a8"], SERVE8,
                                                     device="cpu")
                      for _ in range(4)], max_batch=4, deadline_ms=2.0)
        try:
            rep0 = pool._replicas[0]
            pool.kill_replica(0, mode="in_flight")
            h = RequestHandle(_graphs([10], seed=7)[0], time.monotonic(),
                              bucket_capacity=16)
            assert rep0.try_submit(h)
            r = h.result(timeout=WAIT_S)
            assert np.isfinite(r.energy) and r.replica_id != 0
        finally:
            pool.close()
        doc = {d["trace_id"]: d for d in traced.drain()}[h.trace.trace_id]
        _assert_complete(doc)
        assert doc["hops"] >= 1
        requeues = [e for e in doc["events"] if e["name"] == "requeued"]
        assert requeues and requeues[0]["attrs"]["from_replica"] == 0
        last_serve = [s for s in doc["spans"][1:] if s["name"] == "serve"][-1]
        assert last_serve["attrs"]["replica"] == r.replica_id != 0


# -- launch counters ----------------------------------------------------------

class TestLaunchCounters:
    def test_exact_count_under_eight_threads(self):
        def fn():
            pass
        fn.launches = 0
        fn.full_launches = 0
        n = 20_000

        def hammer():
            for _ in range(n):
                _launch.count_launch(fn)
                _launch.count_launch(fn, "full_launches")
        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert fn.launches == fn.full_launches == 8 * n
        fn.launches = 0                      # callers still reset it
        _launch.count_launch(fn)
        assert fn.launches == 1

    def test_roles_tally_each_threads_launches(self):
        def fn():
            pass
        fn.launches = 0
        _launch.reset_role_launches()

        def work(i):
            with _launch.launch_role(f"flush:{i}"):
                for _ in range(1000 * (i + 1)):
                    _launch.count_launch(fn)
                with _launch.launch_role("inner"):
                    _launch.count_launch(fn, "launches")
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _launch.count_launch(fn)             # no role: in no tally
        want = {f"flush:{i}": {"fn": 1000 * (i + 1)} for i in range(8)}
        want["inner"] = {"fn": 8}
        assert _launch.role_launches() == want
        assert fn.launches == 36_000 + 8 + 1
        _launch.reset_role_launches()
        assert _launch.role_launches() == {}

    def test_replica_tallies_flushes_warmups_and_chunks(self, monkeypatch):
        """A replica's worker tallies what it launches under
        ``flush:<tier>``, ``warmup:<tier>`` and ``chunk:<tier>`` (here the
        quantized matmul entry stands in for a launch: CPU calls launch
        nothing)."""
        from repro_torch.kernels import ops
        plain = ops.w8a8_matmul_f32a

        def launching(*args):
            _launch.count_launch(plain)
            return plain(*args)
        monkeypatch.setattr(ops, "w8a8_matmul_f32a", launching)
        _launch.reset_role_launches()
        with _pool(n=1, warmup=True) as pool:
            assert pool._replicas[0].ready.wait(WAIT_S)
            warm = _launch.role_launches()
            pool.infer(_graphs([5, 12]), timeout_s=WAIT_S)
            after = _launch.role_launches()

            def chunk(engine):
                engine.infer_batch(_graphs([7]))
                return "done"
            assert pool.submit_chunk(chunk, 16).result(
                timeout=WAIT_S) == "done"
            done = _launch.role_launches()
        assert set(warm) == {"warmup:w8a8"} and warm["warmup:w8a8"][
            "w8a8_matmul_f32a"] > 0
        assert set(after) == {"warmup:w8a8", "flush:w8a8"}
        assert after["flush:w8a8"]["w8a8_matmul_f32a"] > 0
        assert done == {**after, "chunk:w8a8": done["chunk:w8a8"]}
        assert done["chunk:w8a8"]["w8a8_matmul_f32a"] > 0
        _launch.reset_role_launches()

    def test_every_wrapper_counts_through_the_lock(self):
        """No kernel wrapper adds to a launch counter by itself."""
        root = Path(_launch.__file__).parent
        bare = []
        for path in sorted(root.glob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                if (isinstance(node, ast.AugAssign)
                        and isinstance(node.target, ast.Attribute)
                        and node.target.attr.endswith("launches")):
                    bare.append(f"{path.name}:{node.lineno}")
        assert bare == []


# -- the serve CLI's cluster flags --------------------------------------------

CLI_SMALL = ["--workload", "so3", "--server", "--device", "cpu", "--feat",
             "16", "--vec-feat", "4", "--layers", "1", "--dir-bits", "4",
             "--buckets", "16", "32", "--max-batch", "8", "--min-atoms", "4",
             "--max-atoms", "24", "--density", "0.1", "--requests", "24",
             "--rate", "200", "--deadline-ms", "5"]


class TestServeCLI:
    def test_cluster_swap_session_and_watchdog_flags(self, capsys, tmp_path):
        from repro_torch.launch import serve as cli
        path = str(tmp_path / "m.npz")
        cli.main(CLI_SMALL + ["--mode", "w4a8", "--save-artifact", path])
        capsys.readouterr()
        cli.main(CLI_SMALL + ["--artifact", path, "--replicas", "2",
                              "--swap-artifact", path, "--md-session", "40",
                              "--stall-timeout", "30"])
        out = capsys.readouterr().out
        assert "cluster: 2 replicas on ['cpu', 'cpu']" in out
        assert "open loop: 24 requests" in out
        assert "md session: 40 steps in 1 frames beside the replay" in out
        assert "hot swap -> " in out and "routing: " in out
        assert "quarantined 0, stalls detected 0" in out

    def test_tiers_flag_builds_a_tiered_fleet(self, capsys):
        from repro_torch.launch import serve as cli
        cli.main(CLI_SMALL + ["--mode", "w4a8", "--tiers",
                              "w4a8:2,w8a8:1", "--guardrails"])
        out = capsys.readouterr().out
        assert "cluster: 3 replicas" in out
        assert "tiers: {'w4a8': 2, 'w8a8': 1}" in out
