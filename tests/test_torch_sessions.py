"""The port's streaming MD sessions (``repro_torch.sessions``) against the
JAX package's ``repro.sessions``, on the CPU (replicas on ``device="cpu"``).

* **The cases of ``tests/test_sessions.py``** on the port: config
  validation, frames streamed in order beside one-shot traffic, typed
  retry on sheds, chunk failover after an in-flight kill, resume after a
  simulated restart, and the seeded chaos run (kill + rolling swap +
  stall + corrupted checkpoint + restart) with zero lost frames; on the
  CPU the plain path replays bit for bit, so replayed frames and the
  final state are held equal, not close.
* **Faults**: ``seeded_schedule`` draws the JAX function's schedule from
  the same seed, and ``corrupt_checkpoint`` damages the same byte.
* **Checkpoints cross packages.** A session checkpoint holds the JAX
  tree key for key (the ``rng_key`` leaf is ``jax.random.PRNGKey(seed)``)
  and the same ``extra``; a checkpoint written by the JAX
  ``SessionManager`` resumes in the port, and one written by the port
  resumes in the JAX manager, each continuation within
  ``tests/test_torch_md.py``'s trajectory tolerance (1e-4 on coordinates
  and total energy, w8a8 with MDDQ off) of the other package's.
* **The session cases of ``test_guardrails.py`` and ``test_obs.py``**: a
  drifting chunk escalates one tier then fails typed; a resumed
  session's chunks trace with session and chunk attribution.
"""
import dataclasses
import json
import os
import shutil
import time

import jax
import numpy as np
import pytest

from repro.cluster import ClusterConfig as JClusterConfig
from repro.cluster import ClusterPool as JClusterPool
from repro.md.engine import MDConfig as JMDConfig
from repro.models import so3krates as jso3
from repro.serving import ServeConfig as JServe
from repro.sessions import SessionConfig as JSessionConfig
from repro.sessions import SessionManager as JSessionManager
from repro.sessions import corrupt_checkpoint as j_corrupt_checkpoint
from repro.sessions import seeded_schedule as j_seeded_schedule
from repro_torch.checkpoint import CheckpointManager
from repro_torch.cluster import ClusterConfig, ClusterPool
from repro_torch.guardrails import GuardrailViolation
from repro_torch.md.engine import MDConfig
from repro_torch.models import so3krates as tso3
from repro_torch.obs import TRACER, configure_tracing
from repro_torch.server import SchedulerOverloaded, save_artifact
from repro_torch.serving import Graph, ServeConfig
from repro_torch.sessions import (FaultInjector, FaultSpec, SessionConfig,
                                  SessionManager, corrupt_checkpoint,
                                  prng_key, seeded_schedule)
from repro_torch.weights import params_from_numpy

CFG_KW = dict(feat=16, vec_feat=4, n_layers=1, n_rbf=4, dir_bits=6,
              cutoff=3.0)
JCFG = jso3.So3kratesConfig(**CFG_KW)
CFG = tso3.So3kratesConfig(**CFG_KW)
SERVE = ServeConfig(mode="w8a8", bucket_sizes=(16,), max_batch=4)
CLUSTER = ClusterConfig(n_replicas=2, max_batch=4, warmup=False,
                        max_queue=64)
WAIT_S = 120
TRAJ_ATOL = 1e-4


def _molecule(n=12, seed=17, density=0.1):
    rng = np.random.default_rng(seed)
    side = (n / density) ** (1.0 / 3.0)
    return (rng.integers(0, CFG.n_species, n).astype(np.int32),
            rng.uniform(0, side, size=(n, 3)).astype(np.float32),
            np.full(n, 12.0, np.float32))


def _session_cfg(**kw):
    base = dict(n_steps=100, chunk_steps=20, record_every=10,
                checkpoint_every=2,
                md=MDConfig(mode="w8a8", dt_fs=0.25, record_every=10))
    base.update(kw)
    return SessionConfig(**base)


def _fresh_pool(**kw):
    return ClusterPool.from_config(
        CFG, serve=SERVE, device="cpu",
        cluster=dataclasses.replace(CLUSTER, **kw))


@pytest.fixture(scope="module")
def pool():
    with _fresh_pool() as p:
        yield p


class TestSessionConfig:
    def test_chunk_record_alignment_enforced(self):
        with pytest.raises(ValueError, match="multiple of"):
            SessionConfig(n_steps=100, chunk_steps=25, record_every=10)

    def test_chunk_arithmetic(self):
        cfg = _session_cfg(n_steps=110)
        assert cfg.n_chunks == 6
        assert cfg.frames_per_chunk == 2
        assert [cfg.chunk_len(i) for i in range(6)] == [20] * 5 + [10]


class TestStreaming:
    def test_frames_stream_in_order_with_inference(self, pool, tmp_path):
        sp, co, masses = _molecule()
        mgr = SessionManager(pool, str(tmp_path))
        session = mgr.start(sp, co, masses, config=_session_cfg(), seed=3)
        graphs = [Graph(species=sp, coords=co + 0.01 * i) for i in range(6)]
        handles = [pool.submit(g) for g in graphs]
        assert all(np.isfinite(h.result(timeout=WAIT_S).energy)
                   for h in handles)
        frames = list(session.frames())       # ends at session end
        assert session.wait(WAIT_S) == "done"
        assert [f.index for f in frames] == list(range(10))
        assert [f.step for f in frames] == list(range(10, 101, 10))
        assert all(np.isfinite(f.e_tot).all() for f in frames)
        assert session.n_checkpoints == 3      # chunks 2, 4 and the last
        assert session.steps_done == 100
        st = pool.stats()
        assert st["sessions"]["done"] >= 1
        assert st["chunks"]["n_completed"] >= 5
        assert st["router"]["n_chunks_routed"] >= 5
        mgr.close()

    def test_on_frame_callback(self, pool, tmp_path):
        sp, co, masses = _molecule(seed=5)
        seen = []
        mgr = SessionManager(pool, str(tmp_path))
        s = mgr.start(sp, co, masses, seed=1, on_frame=seen.append,
                      config=_session_cfg(n_steps=40, checkpoint_every=1))
        s.wait(WAIT_S)
        assert [f.index for f in seen] == [0, 1, 2, 3]
        mgr.close()


class TestRetry:
    def test_shed_submissions_retry_with_backoff(self, pool, tmp_path):
        sp, co, masses = _molecule(seed=7)
        mgr = SessionManager(pool, str(tmp_path))
        real = pool.submit_chunk
        sheds = {"left": 3}

        def flaky(*a, **kw):
            if sheds["left"] > 0:
                sheds["left"] -= 1
                raise SchedulerOverloaded("synthetic shed", 0.01)
            return real(*a, **kw)

        pool.submit_chunk = flaky
        try:
            s = mgr.start(sp, co, masses, seed=2,
                          config=_session_cfg(n_steps=40))
            assert s.wait(WAIT_S) == "done"
        finally:
            pool.submit_chunk = real
        assert sheds["left"] == 0
        assert mgr.stats()["shed_retries"] == 3
        mgr.close()

    def test_retry_budget_exhaustion_fails_loudly(self, pool, tmp_path):
        sp, co, masses = _molecule(seed=9)
        mgr = SessionManager(pool, str(tmp_path))
        real = pool.submit_chunk
        pool.submit_chunk = lambda *a, **kw: (_ for _ in ()).throw(
            SchedulerOverloaded("always shed", 0.001))
        try:
            s = mgr.start(sp, co, masses, seed=2,
                          config=_session_cfg(n_steps=40, max_retries=2,
                                              backoff_s=0.001,
                                              backoff_max_s=0.002))
            with pytest.raises(SchedulerOverloaded):
                s.wait(WAIT_S)
            assert s.status == "failed"
        finally:
            pool.submit_chunk = real
        mgr.close()


class TestFailover:
    def test_in_flight_kill_fails_over_chunk(self, tmp_path):
        with _fresh_pool() as pool:
            sp, co, masses = _molecule(seed=11)
            faults = FaultInjector(
                [FaultSpec(kind="kill_replica", at_chunk=2,
                           mode="in_flight")], pool)
            mgr = SessionManager(pool, str(tmp_path), faults=faults)
            s = mgr.start(sp, co, masses, seed=4, config=_session_cfg())
            assert s.wait(WAIT_S) == "done"
            assert [f.index for f in s.collected] == list(range(10))
            assert faults.counts()["kill_replica"] == 1
            st = pool.stats()
            assert st["n_live"] == 1
            assert (st["chunks"]["n_requeued"] + s.n_retries) >= 1
            mgr.close()


class TestResume:
    def test_restart_resumes_from_checkpoint(self, pool, tmp_path):
        sp, co, masses = _molecule(seed=13)
        mgr = SessionManager(pool, str(tmp_path))
        s = mgr.start(sp, co, masses, seed=5, config=_session_cfg())
        while s.chunks_done < 2 and not s.done():
            time.sleep(0.01)
        s.cancel()
        mgr.close()
        assert s.status in ("cancelled", "done")
        pre = {f.index for f in s.collected}

        mgr2 = SessionManager(pool, str(tmp_path))
        resumed = mgr2.resume_all()
        assert [r.session_id for r in resumed] == [s.session_id]
        r = resumed[0]
        assert r.wait(WAIT_S) == "done"
        assert r.n_restores == 1
        assert pre | {f.index for f in r.collected} == set(range(10))
        assert mgr2.stats()["checkpoints_restored"] == 1
        mgr2.close()

    def test_completed_session_resumes_as_done(self, pool, tmp_path):
        sp, co, masses = _molecule(seed=15)
        mgr = SessionManager(pool, str(tmp_path))
        s = mgr.start(sp, co, masses, seed=6,
                      config=_session_cfg(n_steps=40))
        s.wait(WAIT_S)
        mgr.close()
        resumed = SessionManager(pool, str(tmp_path)).resume_all()
        assert len(resumed) == 1 and resumed[0].status == "done"
        assert resumed[0].done()

    def test_empty_root_resumes_nothing(self, pool, tmp_path):
        assert SessionManager(pool, str(tmp_path)).resume_all() == []


class TestSeededChaos:
    def test_zero_frame_loss_and_deterministic_final_state(self, tmp_path):
        """A w8a8 session survives an in-flight replica kill, a rolling
        artifact swap, a stall, a corrupted newest checkpoint and a
        simulated restart with zero lost frames. The CPU plain path
        replays bit for bit: replayed frames equal their first delivery
        and the final state equals an uninterrupted run's."""
        cfg = _session_cfg(n_steps=400, chunk_steps=50, record_every=25,
                           checkpoint_every=2)
        sp, co, masses = _molecule(seed=21)
        n_frames = 16

        with _fresh_pool() as ref_pool:
            ref_mgr = SessionManager(ref_pool, str(tmp_path / "ref"))
            ref = ref_mgr.start(sp, co, masses, seed=8, config=cfg,
                                session_id="traj")
            assert ref.wait(WAIT_S) == "done"
            ref_mgr.close()

        with _fresh_pool() as pool:
            art = str(tmp_path / "weights.npz")
            save_artifact(art, pool._replicas[0].engine)
            faults = FaultInjector(
                [FaultSpec(kind="kill_replica", at_chunk=2,
                           mode="in_flight"),
                 FaultSpec(kind="swap_artifact", at_chunk=4,
                           artifact_path=art, swap_warmup=False),
                 FaultSpec(kind="stall", at_chunk=5, stall_s=0.05),
                 FaultSpec(kind="corrupt_checkpoint", at_chunk=6,
                           corruption="bitflip")], pool, seed=8)
            mgr = SessionManager(pool, str(tmp_path / "chaos"),
                                 faults=faults)
            box = []

            def die_after_chunk_6(frame):
                # simulated process death once chunk 6 (after the
                # corruption fault) streamed: deterministic, where a
                # poll of chunks_done races a fast CPU run to the end
                if frame.index == 13:
                    box[0].cancel()
            s = mgr.start(sp, co, masses, seed=8, config=cfg,
                          session_id="traj", on_frame=die_after_chunk_6)
            box.append(s)
            assert s.wait(WAIT_S) == "cancelled"
            mgr.close()
            pre = {f.index: f for f in s.collected}
            counts = faults.counts()
            assert (counts["kill_replica"], counts["swap_artifact"],
                    counts["stall"], counts["corrupt_checkpoint"]) == (
                        1, 1, 1, 1)

            mgr2 = SessionManager(pool, str(tmp_path / "chaos"))
            (r,) = mgr2.resume_all()
            assert r.wait(WAIT_S) == "done"
            post = {f.index: f for f in r.collected}
            mgr2.close()

        assert set(pre) | set(post) == set(range(n_frames))
        replayed = set(pre) & set(post)
        assert replayed                       # the corruption forced a replay
        for i in replayed:
            np.testing.assert_array_equal(pre[i].e_tot, post[i].e_tot)
        assert r.chunks_done == cfg.n_chunks
        for leaf in ("coords", "veloc", "forces", "e_pot"):
            np.testing.assert_array_equal(getattr(r.state, leaf),
                                          getattr(ref.state, leaf))
        assert len({f.artifact_version for f in list(pre.values())
                    + list(post.values())}) == 2


class TestFaults:
    @pytest.mark.parametrize("seed,n_chunks,n_replicas,n_faults", [
        (0, 8, 2, 4), (3, 20, 4, 6), (11, 3, 1, 4), (42, 10, 3, 2)])
    def test_seeded_schedule_matches_jax(self, seed, n_chunks, n_replicas,
                                         n_faults):
        ours = seeded_schedule(seed, n_chunks, n_replicas,
                               n_faults=n_faults)
        theirs = j_seeded_schedule(seed, n_chunks, n_replicas,
                                   n_faults=n_faults)
        assert ([dataclasses.asdict(f) for f in ours]
                == [dataclasses.asdict(f) for f in theirs])

    @pytest.mark.parametrize("corruption", ["bitflip", "truncate"])
    def test_corrupt_checkpoint_damages_the_same_byte(self, tmp_path,
                                                      corruption):
        dirs = [tmp_path / "a", tmp_path / "b"]
        for d in dirs:
            CheckpointManager(str(d)).save(3, {"x": np.arange(64.0),
                                               "y": np.ones(9, np.int32)})
        got = corrupt_checkpoint(str(dirs[0]), corruption, seed=5)
        want = j_corrupt_checkpoint(str(dirs[1]), corruption, seed=5)
        assert os.path.basename(got) == os.path.basename(want)
        assert open(got, "rb").read() == open(want, "rb").read()
        assert CheckpointManager(str(dirs[0])).latest_step() is None


# -- checkpoints across packages ----------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 8, 2 ** 31 - 1, -1])
def test_prng_key_leaf_is_jax_key(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    got = prng_key(seed)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


MD_CROSS = dict(mode="w8a8", dt_fs=0.25, record_every=10,
                quant_vectors=False)


@pytest.fixture(scope="module")
def twin_pools():
    """A JAX pool and a port pool, one CPU replica each, on the same
    weights (the JAX init, handed over as numpy)."""
    jp = jax.jit(jso3.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      JCFG)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    jpool = JClusterPool.from_config(
        JCFG, params=jp, serve=JServe(mode="w8a8", bucket_sizes=(16,),
                                      max_batch=4),
        cluster=JClusterConfig(n_replicas=1, max_batch=4, warmup=False))
    tpool = ClusterPool.from_config(
        CFG, params=tp, serve=SERVE, device="cpu",
        cluster=dataclasses.replace(CLUSTER, n_replicas=1))
    yield jpool, tpool
    jpool.close()
    tpool.close()


def _manifest(root, sid, step):
    with open(os.path.join(root, sid, f"step_{step}",
                           "manifest.json")) as f:
        return json.load(f)


class TestCheckpointsAcrossPackages:
    def test_sessions_resume_in_the_other_package(self, twin_pools,
                                                  tmp_path):
        """Each package writes a 2-chunk session with a checkpoint after
        every chunk; the newest is dropped and the other package resumes
        the session from chunk 1. Its re-run of chunk 2 matches the
        writer's own within 1e-4, and both checkpoint trees agree key for
        key (the rng_key leaf included)."""
        jpool, tpool = twin_pools
        root = str(tmp_path)
        sp, co, masses = _molecule(seed=19)
        jmgr = JSessionManager(jpool, root)
        tmgr = SessionManager(tpool, root)
        kw = dict(n_steps=40, chunk_steps=20, record_every=10,
                  checkpoint_every=1)
        js = jmgr.start(sp, co, masses, seed=7, session_id="jax",
                        config=JSessionConfig(md=JMDConfig(**MD_CROSS),
                                              **kw))
        ts = tmgr.start(sp, co, masses, seed=7, session_id="port",
                        config=SessionConfig(md=MDConfig(**MD_CROSS), **kw))
        assert js.wait(WAIT_S) == ts.wait(WAIT_S) == "done"

        mj, mt = _manifest(root, "jax", 2), _manifest(root, "port", 2)
        assert list(mj["arrays"]) == list(mt["arrays"])
        for k in mj["arrays"]:
            assert mj["arrays"][k]["file"] == mt["arrays"][k]["file"]
            assert mj["arrays"][k]["dtype"] == mt["arrays"][k]["dtype"], k
            assert mj["arrays"][k]["shape"] == mt["arrays"][k]["shape"], k
        assert mj["arrays"]["rng_key"]["sha256"] == \
            mt["arrays"]["rng_key"]["sha256"]
        assert set(mj["extra"]) == set(mt["extra"])
        assert mj["extra"]["config"] == mt["extra"]["config"]

        for sid in ("jax", "port"):
            shutil.rmtree(os.path.join(root, sid, "step_2"))
        tmgr.close()
        jmgr.close()
        (t_of_j,) = tmgr.resume_all()        # the JAX-written session
        (j_of_t,) = jmgr.resume_all()        # the port-written session
        assert (t_of_j.session_id, j_of_t.session_id) == ("jax", "port")
        assert t_of_j.wait(WAIT_S) == j_of_t.wait(WAIT_S) == "done"
        for first, again in ((js, t_of_j), (ts, j_of_t)):
            assert again.n_restores == 1
            assert [f.index for f in again.collected] == [2, 3]
            for a, b in zip(again.collected, first.collected[2:]):
                np.testing.assert_allclose(a.e_tot, b.e_tot, atol=TRAJ_ATOL)
            np.testing.assert_allclose(np.asarray(again.state.coords),
                                       np.asarray(first.state.coords),
                                       atol=TRAJ_ATOL)
        tmgr.close()
        jmgr.close()


# -- guardrails and traces ----------------------------------------------------

class TestSessionEscalation:
    def test_drifting_chunk_escalates_then_fails_typed(self, tmp_path):
        """drift_limit=1e-12 fails every tier: the manager re-runs the
        chunk once at w8a8 (min_tier routing), then surfaces the typed
        error of the escalated tier."""
        pool = ClusterPool.from_tiers(
            CFG, serve=ServeConfig(mode="w4a8", bucket_sizes=(16,),
                                   max_batch=4, path="dense"),
            tier_plan={"w4a8": 1, "w8a8": 1}, device="cpu",
            cluster=ClusterConfig(max_batch=4, deadline_ms=2.0,
                                  warmup=False))
        try:
            mgr = SessionManager(pool, str(tmp_path))
            sp, co, masses = _molecule(n=10, seed=13)
            session = mgr.start(sp, co, masses, seed=7, config=SessionConfig(
                n_steps=20, chunk_steps=20, record_every=5,
                max_escalations=1,
                md=MDConfig(mode="w4a8", dt_fs=0.5, record_every=5,
                            drift_limit=1e-12)))
            with pytest.raises(GuardrailViolation) as ei:
                session.wait(WAIT_S)
            assert ei.value.reason == "energy_drift"
            assert ei.value.detail["mode"] == "w8a8"   # the escalated tier
            assert session.status == "failed"
            assert session.n_escalations == 1
            st = pool.stats()
            assert st["sessions"]["chunk_escalations"] == 1
            assert st["sessions"]["failed"] == 1
            mgr.close()
        finally:
            pool.close()


class TestChunkTrace:
    def test_resumed_session_chunks_trace_with_attribution(self, tmp_path):
        configure_tracing(enabled=True)
        TRACER.reset()
        try:
            with _fresh_pool() as pool:
                sp, co, masses = _molecule(seed=13)
                scfg = _session_cfg()
                mgr = SessionManager(pool, str(tmp_path))
                s = mgr.start(sp, co, masses, seed=5, config=scfg)
                while s.chunks_done < 2 and not s.done():
                    time.sleep(0.01)
                s.cancel()
                mgr.close()
                mgr2 = SessionManager(pool, str(tmp_path))
                (resumed,) = mgr2.resume_all()
                assert resumed.wait(WAIT_S) == "done"
                assert resumed.n_restores == 1
                mgr2.close()
            docs = [d for d in TRACER.drain() if d["kind"] == "chunk"]
        finally:
            configure_tracing(enabled=False)
            TRACER.reset()
        assert len(docs) >= scfg.n_chunks      # both incarnations trace
        for doc in docs:
            assert doc["status"] == "ok" and doc["t1"] is not None
            assert doc["attrs"]["session_id"] == s.session_id
            assert doc["attrs"]["chunk_idx"] >= 0
            children = doc["spans"][1:]
            assert children[0]["t0"] == doc["spans"][0]["t0"]
            assert children[-1]["t1"] == doc["spans"][0]["t1"]
