"""The port's online serving layer (``repro_torch.server``) against the JAX
package's ``repro.server``, on the CPU.

* **Artifacts cross packages.** A file written by
  ``repro.server.save_artifact`` loads in the port with every leaf byte
  for byte, the same version tag, fp32 bytes and configs, and the port
  serves it within 1e-5 of the largest |value| of the JAX engine on the
  same file (w8a8 and w4a8); a port-written file loads in the JAX
  package with the same tag. The port's own round trip is bit-exact and
  its refusals are the JAX package's (``tests/test_server.py``).
* **The scheduler keeps the JAX package's semantics**: request identity
  within 1e-6 of direct ``infer_batch([g])`` (also through the dense
  fallback), full/deadline/drain flushes, shedding with a retry hint,
  anti-starvation, no new shape under traffic. Flush reasons and counts
  are asserted, never wall-clock margins, and every ``result()`` has a
  timeout.
* **Traffic and stats** draw and sum exactly as the JAX package's.
* **The sampled LEE probe**, under the JAX package's rotation, flags the
  same molecules with the same LEE to 1e-5 relative.
* **The CLI** (``--workload so3``) runs on ``--device cpu``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.lee import random_rotation as j_random_rotation
from repro.guardrails import GuardrailConfig as JGuard
from repro.models import so3krates as jso3
from repro.server import FlushRecord as JFlushRecord
from repro.server import RateStage as JRateStage
from repro.server import SizeClass as JSizeClass
from repro.server import TrafficConfig as JTrafficConfig
from repro.server import flush_summary as j_flush_summary
from repro.server import latency_summary as j_latency_summary
from repro.server import load_artifact as j_load_artifact
from repro.server import load_engine as j_load_engine
from repro.server import make_step_traffic as j_make_step_traffic
from repro.server import make_traffic as j_make_traffic
from repro.server import save_artifact as j_save_artifact
from repro.serving import QuantizedEngine as JEngine
from repro.serving import ServeConfig as JServe
from repro_torch.guardrails import GuardrailConfig, GuardrailViolation
from repro_torch.launch import serve as cli
from repro_torch.models import so3krates as tso3
from repro_torch.obs import REGISTRY
from repro_torch.server import (ARTIFACT_VERSION, ArtifactError, BatchQueue,
                                FlushRecord, MicroBatchScheduler, RateStage,
                                RequestHandle, SchedulerClosed,
                                SchedulerConfig, SchedulerOverloaded,
                                SizeClass, TrafficConfig, flush_summary,
                                latency_summary, load_artifact, load_engine,
                                make_step_traffic, make_traffic,
                                run_closed_loop, run_open_loop, save_artifact,
                                stage_summaries)
from repro_torch.serving import Graph, QuantizedEngine, ServeConfig
from repro_torch.serving import bucketing as tb
from repro_torch.weights import params_from_numpy

CFG_KW = dict(feat=16, vec_feat=4, n_layers=1, n_rbf=4, dir_bits=4,
              cutoff=3.0)
JCFG = jso3.So3kratesConfig(**CFG_KW)
TCFG = tso3.So3kratesConfig(**CFG_KW)
MODES = ["w8a8", "w4a8"]
# the port against the JAX engine on one artifact, relative to the
# largest |value| (measured: ~5e-7)
CROSS_REL = 1e-5
RESULT_TIMEOUT = 120


def _graphs(ns, seed=0, density=0.1):
    rng = np.random.default_rng(seed)
    out = []
    for n in ns:
        side = (n / density) ** (1.0 / 3.0)
        out.append(Graph(
            species=rng.integers(0, TCFG.n_species, n).astype(np.int32),
            coords=rng.uniform(0, side, (n, 3)).astype(np.float32)))
    return out


def _parity_graphs():
    """Six molecules of one shape class (bucket 16), so the JAX engine
    compiles once per mode."""
    return tb.random_graphs(6, 2, 14, TCFG.n_species, seed=0)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jso3.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      JCFG)
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                 "cpu")


@pytest.fixture(scope="module")
def jax_artifacts(params, tmp_path_factory):
    """Per mode: (path of a JAX-written artifact, the JAX source engine,
    the JAX engine loaded from that file)."""
    jp, _ = params
    root = tmp_path_factory.mktemp("jax_artifacts")
    out = {}
    for mode in MODES:
        src = JEngine.from_config(
            JCFG, params=jp,
            serve=JServe(mode=mode, bucket_sizes=(16,), max_batch=8))
        path = str(root / f"{mode}.npz")
        j_save_artifact(path, src)
        out[mode] = (path, src, j_load_engine(path))
    return out


@pytest.fixture(scope="module")
def engine(params):
    """A port engine on the CPU with two buckets, for the scheduler."""
    _, tp = params
    return QuantizedEngine.from_config(
        TCFG, params=tp, device="cpu",
        serve=ServeConfig(mode="w8a8", bucket_sizes=(16, 32), max_batch=8))


def _port_engine(tp, mode="w8a8", **serve_kw):
    kw = dict(mode=mode, bucket_sizes=(16,), max_batch=8)
    kw.update(serve_kw)
    return QuantizedEngine.from_config(TCFG, params=tp, device="cpu",
                                       serve=ServeConfig(**kw))


# -- (a) artifacts across the two packages -------------------------------------

class TestCrossPackageArtifacts:
    @pytest.mark.parametrize("mode", MODES)
    def test_jax_artifact_loads_in_port_byte_for_byte(self, jax_artifacts,
                                                      mode):
        path, src, _ = jax_artifacts[mode]
        art, jart = load_artifact(path), j_load_artifact(path)
        assert art.version_tag == jart.version_tag != ""
        assert art.fp32_bytes == jart.fp32_bytes
        assert art.file_bytes == jart.file_bytes
        assert dataclasses.asdict(art.model_cfg) == \
            dataclasses.asdict(jart.model_cfg)
        assert dataclasses.asdict(art.serve) == dataclasses.asdict(jart.serve)
        assert set(art.qparams) == set(src.qparams)
        for name, jv in src.qparams.items():
            tv = art.qparams[name]
            if hasattr(jv, "kind"):
                assert tv.kind == jv.kind
                pairs = [(tv.data, jv.data)]
                if jv.scale is not None:
                    pairs.append((tv.scale, jv.scale))
            else:
                pairs = [(tv, jv)]
            for t, j in pairs:
                j = np.asarray(j)
                assert t.dtype == j.dtype and t.shape == j.shape, name
                assert t.tobytes() == j.tobytes(), name
        eng = load_engine(path, device="cpu")
        assert eng.artifact_version == jart.version_tag
        assert eng.memory_report() == src.memory_report()
        data = eng.qparams["layer0/wq"].data
        assert data.dtype == torch.int8 and data.device.type == "cpu"

    @pytest.mark.parametrize("mode", MODES)
    def test_port_serves_jax_artifact(self, jax_artifacts, mode):
        path, _, jeng = jax_artifacts[mode]
        graphs = _parity_graphs()
        jr = jeng.infer_batch(graphs)
        tr = load_engine(path, device="cpu").infer_batch(graphs)
        assert [(r.bucket_capacity, r.batch_size, r.path) for r in tr] == \
            [(r.bucket_capacity, r.batch_size, r.path) for r in jr]
        assert _rel([r.energy for r in tr], [r.energy for r in jr]) \
            <= CROSS_REL
        assert _rel(np.concatenate([r.forces for r in tr]),
                    np.concatenate([r.forces for r in jr])) <= CROSS_REL
        assert {r.artifact_version for r in tr} == \
            {r.artifact_version for r in jr}

    @pytest.mark.parametrize("mode", MODES)
    def test_port_artifact_loads_in_jax(self, params, tmp_path, mode):
        _, tp = params
        eng = _port_engine(tp, mode)
        path = str(tmp_path / "port.npz")
        save_artifact(path, eng)
        jart = j_load_artifact(path)
        assert jart.version_tag == load_artifact(path).version_tag
        assert jart.fp32_bytes == eng.memory_report()["fp32_bytes"]
        assert dataclasses.asdict(jart.serve) == dataclasses.asdict(eng.serve)
        for name, v in eng.qparams.items():
            jv = jart.qparams[name]
            t = v.data if hasattr(v, "kind") else v
            j = jv.data if hasattr(jv, "kind") else jv
            assert _np(t).tobytes() == np.asarray(j).tobytes(), name


# -- (b) the port's own artifact semantics -------------------------------------

def _rewrite(path, out, edit):
    """Copy the .npz at ``path`` to ``out`` member by member, passing
    ``{name: bytes}`` through ``edit`` (zip CRCs are rebuilt, so only
    the artifact's own checks can catch the change)."""
    with zipfile.ZipFile(path) as z:
        members = {n: z.read(n) for n in z.namelist()}
    edit(members)
    with zipfile.ZipFile(out, "w") as z:
        for n, b in members.items():
            z.writestr(n, b)
    return out


def _npy_u8_header(n: int) -> bytes:
    """Minimal .npy v1 header for a (n,) uint8 array."""
    head = (f"{{'descr': '|u1', 'fortran_order': False, "
            f"'shape': ({n},), }}").encode()
    pad = 64 - (10 + len(head) + 1) % 64
    head += b" " * pad + b"\n"
    return b"\x93NUMPY\x01\x00" + len(head).to_bytes(2, "little") + head


def _flip_payload(members):
    victim = next(n for n in members
                  if n.startswith("q/") and n.endswith("/data.npy"))
    body = bytearray(members[victim])
    body[-1] ^= 0xFF
    members[victim] = bytes(body)


def _bump_version(members):
    raw = members["__manifest__.npy"]
    manifest = json.loads(raw[raw.index(b"\n") + 1:].decode())
    manifest["version"] = ARTIFACT_VERSION + 1
    body = json.dumps(manifest).encode()
    members["__manifest__.npy"] = _npy_u8_header(len(body)) + body


@pytest.fixture(scope="module")
def saved(params, tmp_path_factory):
    """A w8a8 port artifact and its source engine."""
    _, tp = params
    src = _port_engine(tp)
    path = str(tmp_path_factory.mktemp("port_artifact") / "model.npz")
    save_artifact(path, src)
    return path, src


class TestArtifact:
    @pytest.mark.parametrize("mode", MODES)
    def test_round_trip_bit_exact(self, params, tmp_path, mode):
        _, tp = params
        src = _port_engine(tp, mode)
        path = str(tmp_path / f"model_{mode}.npz")
        nbytes = save_artifact(path, src)
        assert nbytes == os.path.getsize(path)
        loaded = load_engine(path, device="cpu")
        assert loaded.model_cfg == TCFG and loaded.serve == src.serve
        for name, v in src.qparams.items():
            w = loaded.qparams[name]
            if hasattr(v, "kind"):
                assert torch.equal(v.data, w.data)
                assert (v.scale is None and w.scale is None) or \
                    torch.equal(v.scale, w.scale)
            else:
                assert torch.equal(v, w)
        graphs = _graphs([6, 12, 16], seed=11)
        for a, b in zip(src.infer_batch(graphs), loaded.infer_batch(graphs)):
            assert a.energy == b.energy                  # bit-exact
            np.testing.assert_array_equal(a.forces, b.forces)
            assert b.artifact_version == loaded.artifact_version != ""
        assert loaded.memory_report() == src.memory_report()
        # the tag is the weights' content: a second save carries it too
        again = str(tmp_path / "again.npz")
        save_artifact(again, loaded)
        assert load_artifact(again).version_tag == loaded.artifact_version

    @pytest.mark.parametrize("case,match", [
        ("truncated_half", "truncated or corrupt"),
        ("truncated_10", "truncated or corrupt"),
        ("bitflip", "checksum|corrupt"),
        ("version", "version"),
        ("not_an_artifact", "manifest"),
    ])
    def test_bad_artifact_is_refused(self, saved, tmp_path, case, match):
        path, _ = saved
        bad = str(tmp_path / "bad.npz")
        if case.startswith("truncated"):
            data = open(path, "rb").read()
            cut = len(data) // 2 if case == "truncated_half" else 10
            with open(bad, "wb") as f:
                f.write(data[:cut])
        elif case == "bitflip":
            _rewrite(path, bad, _flip_payload)
        elif case == "version":
            _rewrite(path, bad, _bump_version)
        else:
            np.savez(bad, x=np.zeros(3))
        with pytest.raises(ArtifactError, match=match):
            load_artifact(bad)
        with pytest.raises(ArtifactError, match=match):
            load_engine(bad, device="cpu")

    def test_mode_override_rejected(self, saved):
        path, src = saved
        with pytest.raises(ArtifactError, match="mode"):
            load_engine(path, serve=dataclasses.replace(src.serve,
                                                        mode="w4a8"),
                        device="cpu")
        eng = load_engine(path, device="cpu", serve=dataclasses.replace(
            src.serve, bucket_sizes=(16, 32), path="dense"))
        assert eng.serve.bucket_sizes == (16, 32)

    def test_artifact_is_smaller_than_fp32(self, tmp_path):
        # tests/test_server.py's width: at the tiny one the zip members'
        # headers and the manifest outweigh the weights
        cfg = tso3.So3kratesConfig(feat=32, vec_feat=8, n_layers=2, n_rbf=8,
                                   dir_bits=6, cutoff=3.0)
        src = QuantizedEngine.from_config(
            cfg, device="cpu",
            serve=ServeConfig(mode="w4a8", bucket_sizes=(16,), max_batch=8))
        nbytes = save_artifact(str(tmp_path / "m.npz"), src)
        assert nbytes < src.memory_report()["fp32_bytes"]

    def test_engine_needs_exactly_one_weight_tree(self, params):
        _, tp = params
        src = _port_engine(tp)
        with pytest.raises(ValueError, match="exactly one"):
            QuantizedEngine(TCFG, tp, src.serve, qparams=src.qparams,
                            device="cpu")
        with pytest.raises(ValueError, match="exactly one"):
            QuantizedEngine(TCFG, None, src.serve, device="cpu")
        eng = QuantizedEngine.from_quantized(TCFG, src.qparams, src.serve,
                                             device="cpu")
        # no fp32 tree: the footprint is the logical element count
        assert eng.memory_report() == src.memory_report()


# -- (c) scheduler semantics ----------------------------------------------------

def _direct(engine, g):
    (r,) = engine.infer_batch([g])
    return r


class TestSchedulerIdentity:
    def test_mixed_size_traffic_matches_direct_calls(self, engine):
        graphs = _graphs([5, 30, 12, 7, 25, 16, 9, 32, 11], seed=1)
        cfg = SchedulerConfig(max_batch=4, deadline_ms=5.0, warmup=False)
        with MicroBatchScheduler(engine, cfg) as sched:
            handles = [sched.submit(g) for g in graphs]
            results = [h.result(timeout=RESULT_TIMEOUT) for h in handles]
        for g, r in zip(graphs, results):
            d = _direct(engine, g)
            assert abs(r.energy - d.energy) <= 1e-6
            np.testing.assert_allclose(r.forces, d.forces, atol=1e-6)
            assert r.n_atoms == g.n_atoms
            assert r.replica_id == 0 and r.trace_id == ""
            assert r.escalations == ()

    def test_identity_through_dense_fallback(self, params):
        _, tp = params
        eng = _port_engine(tp, bucket_sizes=(16, 32), path="sparse",
                           edge_capacity=128)
        rng = np.random.default_rng(3)
        # a tight 16-atom cluster: 240 directed edges > 128 slots
        dense_g = Graph(
            rng.integers(0, TCFG.n_species, 16).astype(np.int32),
            (rng.normal(size=(16, 3)) * 0.5).astype(np.float32))
        graphs = [dense_g] + _graphs([10, 24], seed=4, density=0.02)
        cfg = SchedulerConfig(max_batch=2, deadline_ms=5.0, warmup=False)
        with MicroBatchScheduler(eng, cfg) as sched:
            handles = [sched.submit(g) for g in graphs]
            results = [h.result(timeout=RESULT_TIMEOUT) for h in handles]
        assert eng.dispatch_stats["sparse_fallback"] > 0
        assert {r.path for r in results} == {"dense", "sparse"}
        for g, r in zip(graphs, results):
            d = _direct(eng, g)
            assert abs(r.energy - d.energy) <= 1e-6
            np.testing.assert_allclose(r.forces, d.forces, atol=1e-6)

    def test_results_resolve_to_their_own_handles(self, engine):
        graphs = _graphs([12, 12, 12, 12, 12], seed=5)
        cfg = SchedulerConfig(max_batch=5, deadline_ms=50.0, warmup=False)
        with MicroBatchScheduler(engine, cfg) as sched:
            handles = [sched.submit(g) for g in graphs]
            energies = [h.result(timeout=RESULT_TIMEOUT).energy
                        for h in handles]
        direct = [_direct(engine, g).energy for g in graphs]
        np.testing.assert_allclose(energies, direct, atol=1e-6)
        assert len({round(e, 6) for e in direct}) > 1

    def test_concurrent_clients_get_their_own_results(self, engine):
        """More client threads than cores submit at once under a short
        switch interval: every request resolves to its own molecule and
        the scheduler's counters add up."""
        graphs = _graphs([4 + (7 * i) % 29 for i in range(48)], seed=15)
        n_threads = (os.cpu_count() or 1) + 2
        out = [None] * len(graphs)
        errors = []
        cfg = SchedulerConfig(max_batch=8, deadline_ms=1.0, warmup=False)

        def client(k, sched):
            try:
                for i in range(k, len(graphs), n_threads):
                    out[i] = sched.submit(graphs[i]).result(
                        timeout=RESULT_TIMEOUT)
            except BaseException as exc:      # reported below
                errors.append(exc)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            with MicroBatchScheduler(engine, cfg) as sched:
                threads = [threading.Thread(target=client, args=(k, sched))
                           for k in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=RESULT_TIMEOUT)
                assert not any(t.is_alive() for t in threads)
                stats = sched.stats()
        finally:
            sys.setswitchinterval(interval)
        assert errors == []
        assert stats["n_submitted"] == stats["n_completed"] == len(graphs)
        for g, r, d in zip(graphs, out, engine.infer_batch(graphs)):
            assert r.n_atoms == g.n_atoms
            assert abs(r.energy - d.energy) <= 1e-6

    def test_worker_serves_forces_under_callers_no_grad(self, engine):
        """Grad mode is per thread: a scheduler made and fed under
        ``no_grad`` still returns the autograd forces."""
        (g,) = _graphs([12], seed=6)
        cfg = SchedulerConfig(max_batch=1, deadline_ms=0.0, warmup=False)
        with torch.no_grad():
            with MicroBatchScheduler(engine, cfg) as sched:
                r = sched.submit(g).result(timeout=RESULT_TIMEOUT)
        np.testing.assert_allclose(r.forces, _direct(engine, g).forces,
                                   atol=1e-6)
        assert np.abs(r.forces).max() > 0


class TestSchedulerBatching:
    def test_full_queue_flushes_as_one_batch(self, engine):
        graphs = _graphs([10, 11, 12, 13], seed=6)
        cfg = SchedulerConfig(max_batch=4, deadline_ms=600_000.0,
                              warmup=False)
        with MicroBatchScheduler(engine, cfg) as sched:
            for h in [sched.submit(g) for g in graphs]:
                h.result(timeout=RESULT_TIMEOUT)
            stats = sched.stats()
        assert stats["flush_reasons"] == {"full": 1}
        assert stats["n_flushes"] == 1 and stats["max_batch"] == 4

    def test_deadline_flushes_partial_batch(self, engine):
        (g,) = _graphs([9], seed=7)
        cfg = SchedulerConfig(max_batch=8, deadline_ms=30.0, warmup=False)
        with MicroBatchScheduler(engine, cfg) as sched:
            r = sched.submit(g).result(timeout=RESULT_TIMEOUT)
            stats = sched.stats()
        assert r.n_atoms == 9
        assert stats["flush_reasons"] == {"deadline": 1}
        assert stats["mean_batch"] == 1.0

    def test_close_drains_pending_requests(self, engine):
        graphs = _graphs([8, 14, 22], seed=8)
        cfg = SchedulerConfig(max_batch=8, deadline_ms=600_000.0,
                              warmup=False)
        sched = MicroBatchScheduler(engine, cfg)
        handles = [sched.submit(g) for g in graphs]
        sched.close()
        for h in handles:
            assert h.done()
            assert np.isfinite(h.result(timeout=0).energy)
        assert sched.stats()["flush_reasons"] == {"drain": 2}
        with pytest.raises(SchedulerClosed, match="closed"):
            sched.submit(graphs[0])

    def test_bounded_admission_sheds_with_retry_hint(self, engine):
        graphs = _graphs([10, 11, 12], seed=30)
        cfg = SchedulerConfig(max_batch=8, deadline_ms=600_000.0,
                              warmup=False, max_queue=2)
        sched = MicroBatchScheduler(engine, cfg)
        admitted = [sched.submit(g) for g in graphs[:2]]
        with pytest.raises(SchedulerOverloaded) as ei:
            sched.submit(graphs[2])
        assert ei.value.retry_after_s > 0
        assert sched.stats()["n_shed"] == 1
        sched.close()
        for h in admitted:
            assert np.isfinite(h.result(timeout=RESULT_TIMEOUT).energy)

    def test_deadline_expired_queue_not_starved_by_full_queue(self, engine):
        cfg = SchedulerConfig(max_batch=2, deadline_ms=10.0, warmup=False)
        queue = BatchQueue(engine.serve.buckets(), cfg)
        (g16,) = _graphs([8], seed=20)
        (g32,) = _graphs([24], seed=21)
        old = RequestHandle(g32, 0.0, bucket_capacity=32)
        queue.append(old)                       # deadline long expired
        for _ in range(2):                      # full 16-atom queue
            queue.append(RequestHandle(g16, 1.0, bucket_capacity=16))
        assert queue.pick_flush(1.0, drain=False) == (32, [old], "deadline")
        cap, handles, reason = queue.pick_flush(1.0, drain=False)
        assert (cap, len(handles), reason) == (16, 2, "full")
        assert queue.depth() == 0 and queue.pick_flush(1.0, True) is None

    def test_worker_that_cannot_start_fails_its_requests(self, engine):
        """A worker that dies before its loop (here: no card to select)
        stops admission and fails what it admitted: no request hangs."""
        if torch.cuda.is_available():
            pytest.skip("this host has a card: the worker would start")

        class OnMissingCard:
            serve = engine.serve
            device = torch.device("cuda", 0)

            def stats_snapshot(self):
                return {}
        sched = MicroBatchScheduler(OnMissingCard(), SchedulerConfig(
            max_batch=1, deadline_ms=0.0, warmup=False))
        (g,) = _graphs([8], seed=14)
        try:
            admitted = sched.submit(g)
        except SchedulerClosed:
            admitted = None
        sched._worker.join(timeout=RESULT_TIMEOUT)
        assert not sched._worker.is_alive()
        if admitted is not None:
            with pytest.raises(Exception):      # what set_device raised
                admitted.result(timeout=RESULT_TIMEOUT)
        with pytest.raises(SchedulerClosed):
            sched.submit(g)
        sched.close()

    @pytest.mark.parametrize("case", ["oversize", "max_batch"])
    def test_submit_and_config_refusals(self, engine, case):
        if case == "oversize":
            cfg = SchedulerConfig(warmup=False)
            with MicroBatchScheduler(engine, cfg) as sched:
                with pytest.raises(ValueError, match="exceeds the largest"):
                    sched.submit(_graphs([100], seed=9)[0])
                assert sched.stats()["n_submitted"] == 0
        else:
            with pytest.raises(ValueError, match="exceeds ServeConfig"):
                MicroBatchScheduler(
                    engine, SchedulerConfig(max_batch=99, warmup=False))

    def test_no_new_shape_under_traffic_after_warmup(self, params):
        _, tp = params
        eng = _port_engine(tp, "w4a8", bucket_sizes=(16, 32), path="sparse",
                           mddq_kernel=True)
        cfg = SchedulerConfig(max_batch=4, deadline_ms=2.0)
        traffic = make_traffic(TrafficConfig(
            rate_rps=400.0, n_requests=24, seed=2,
            size_mix=(SizeClass(4, 16, 0.5), SizeClass(17, 32, 0.5))))
        with MicroBatchScheduler(eng, cfg) as sched:
            seen = set(eng.shapes_seen)
            report = list(eng.warmup_report)
            res = run_open_loop(sched, traffic, result_timeout=RESULT_TIMEOUT)
        assert eng.shapes_seen == seen
        assert {(r["bucket"], r["batch_size"], r["path"]) for r in report} \
            == {(16, 8, "dense"), (16, 8, "sparse"), (32, 4, "dense"),
                (32, 4, "sparse"), (32, 8, "dense"), (32, 8, "sparse")}
        assert res.summary()["n_requests"] == 24 and res.n_shed == 0
        flushes = sched._flushes
        assert sum(f.n_requests for f in flushes) == 24
        for f in flushes:
            assert 0 < f.prep_s + f.dispatch_s + f.sync_s <= f.service_s
        assert set(eng.last_infer_breakdown) == {
            "prep_s", "dispatch_s", "sync_s", "n_plans", "total_s"}


class TestEngineStats:
    def test_reset_and_snapshot(self, engine):
        engine.infer_batch(_graphs([10], seed=10))
        before = engine.stats_snapshot()
        guard = engine.guard_snapshot()
        assert sum(before.values()) > 0 and guard["checked"] > 0
        assert engine.reset_stats() == before
        assert sum(engine.dispatch_stats.values()) == 0
        assert sum(engine.guard_stats.values()) == 0
        snap, gsnap = engine.stats_snapshot(), engine.guard_snapshot()
        engine.infer_batch(_graphs([10], seed=10))
        assert sum(snap.values()) == 0 and sum(gsnap.values()) == 0
        assert engine.guard_stats["checked"] == 1

    def test_registry_carries_the_jax_names(self, params):
        from repro_torch.obs.metrics import REGISTRY
        _, tp = params
        eng = _port_engine(tp, "w4a8")
        eng.guardrails = GuardrailConfig(lee_probe_every=1, on_flag="mark")
        dispatch = REGISTRY.counter("engine_dispatch_total", mode="w4a8",
                                    path="dense")
        checked = REGISTRY.counter("engine_guard_total", mode="w4a8",
                                   event="checked")
        d0, c0 = dispatch.value, checked.value
        eng.warmup()
        eng.infer_batch(_graphs([6, 9], seed=12))
        # the probe's re-run dispatches too
        assert dispatch.value - d0 == 2 and checked.value - c0 == 2
        assert REGISTRY.gauge("engine_lee_probe_level",
                              mode="w4a8").value > 0
        assert REGISTRY.counter("engine_warmup_seconds_total",
                                mode="w4a8").value > 0
        assert REGISTRY.histogram("engine_warmup_compile_seconds",
                                  mode="w4a8", path="dense").count >= 1


# -- (d) traffic and stats -----------------------------------------------------

class TestTrafficAndStats:
    @pytest.mark.parametrize("density", [0.1, None])
    def test_make_traffic_matches_jax(self, density):
        kw = dict(rate_rps=50.0, n_requests=40, density=density, seed=3)
        mix = ((6, 12, 1.0), (20, 30, 2.0))
        t = make_traffic(TrafficConfig(
            size_mix=tuple(SizeClass(*m) for m in mix), **kw))
        j = j_make_traffic(JTrafficConfig(
            size_mix=tuple(JSizeClass(*m) for m in mix), **kw))
        assert [a for a, _ in t] == [a for a, _ in j]
        for (_, a), (_, b) in zip(t, j):
            np.testing.assert_array_equal(a.species, b.species)
            np.testing.assert_array_equal(a.coords, b.coords)

    def test_make_step_traffic_matches_jax(self):
        stages = [(50.0, 1.0), (400.0, 0.5), (50.0, 1.0)]
        t = make_step_traffic([RateStage(*s) for s in stages], seed=5)
        j = j_make_step_traffic([JRateStage(*s) for s in stages], seed=5)
        assert len(t) == len(j) > 0
        assert [a for a, _ in t] == [a for a, _ in j]
        for (_, a), (_, b) in zip(t, j):
            np.testing.assert_array_equal(a.coords, b.coords)
        with pytest.raises(ValueError):
            make_step_traffic([])

    def test_latency_and_flush_summaries_match_jax(self):
        lat = np.random.default_rng(0).exponential(0.02, 101).tolist()
        assert latency_summary(lat, span_s=2.5) == \
            j_latency_summary(lat, span_s=2.5)
        rows = [dict(capacity=c, n_requests=n, reason=r, queue_depth=d,
                     wait_s=0.01 * n, service_s=0.02, path="sparse",
                     batch_size=8, prep_s=1e-3, dispatch_s=5e-3,
                     sync_s=1e-2)
                for c, n, r, d in [(16, 3, "deadline", 4), (32, 4, "full", 6),
                                   (16, 8, "full", 9), (32, 1, "drain", 1)]]
        assert flush_summary([FlushRecord(**r) for r in rows]) == \
            j_flush_summary([JFlushRecord(**r) for r in rows])
        assert flush_summary([]) == {"n_flushes": 0}

    def test_open_and_closed_loop_end_to_end(self, engine):
        stages = [RateStage(200.0, 0.05), RateStage(200.0, 0.05)]
        traffic = make_step_traffic(stages, size_mix=(SizeClass(6, 16, 1.0),),
                                    seed=6)
        cfg = SchedulerConfig(max_batch=4, deadline_ms=5.0, warmup=False)
        with MicroBatchScheduler(engine, cfg) as sched:
            res = run_open_loop(sched, traffic, rate_rps=200.0,
                                result_timeout=RESULT_TIMEOUT)
            closed = run_closed_loop(sched, [g for _, g in traffic[:6]],
                                     concurrency=3)
        s = res.summary()
        assert s["n_requests"] == len(traffic) and s["n_shed"] == 0
        assert s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"] <= s["max_ms"]
        rows = stage_summaries(res, stages)
        assert sum(r["n_offered"] for r in rows) == len(traffic)
        assert closed.summary()["n_requests"] == 6
        assert res.scheduler_stats["per_replica"]["0"]["n_requests"] == \
            len(traffic)


# -- (e) the sampled LEE probe --------------------------------------------------

class TestLEEProbe:
    @pytest.mark.parametrize("mode", MODES)
    def test_probe_flags_the_same_molecules_as_jax(self, jax_artifacts,
                                                   mode):
        """Both engines probe every call under R = the JAX package's
        rotation for ``lee_seed + n``; with the limit below every LEE
        each molecule's flag value (its LEE) agrees to 1e-5 relative,
        and with the limit inside the largest gap between them both
        engines flag the same molecules and count alike."""
        path, _, jeng = jax_artifacts[mode]
        teng = load_engine(path, device="cpu")
        teng._probe_rotation = lambda n: np.asarray(
            j_random_rotation(jax.random.PRNGKey(7 + n)))
        graphs = _parity_graphs()

        def probe(limit):
            out = []
            for eng, cfg in ((jeng, JGuard), (teng, GuardrailConfig)):
                eng.guardrails = cfg(lee_probe_every=1, lee_limit=limit,
                                     lee_seed=7, on_flag="mark")
                eng._n_infer_calls = 0
                eng.reset_stats()
                res = eng.infer_batch(graphs)
                out.append(([[f.value for f in r.flags if f.reason == "lee"]
                             for r in res], eng.guard_snapshot()))
            return out

        (jv, jg), (tv, tg) = probe(1e-12)
        assert all(len(v) == 1 for v in jv + tv)
        jv, tv = np.ravel(jv), np.ravel(tv)
        assert np.abs(tv - jv).max() <= 1e-5 * jv.max()
        assert np.all(np.abs(tv - jv) <= 1e-5 * jv)
        assert tg == jg == {"checked": 6, "flagged_nonfinite": 0,
                            "flagged_outlier": 0, "flagged_lee": 6,
                            "lee_probes": 1}
        s = np.sort(jv)
        i = int(np.argmax(s[1:] / s[:-1]))
        limit = float(np.sqrt(s[i] * s[i + 1]))
        (jv, jg), (tv, tg) = probe(limit)
        assert [len(v) for v in tv] == [len(v) for v in jv]
        assert tg == jg and tg["flagged_lee"] == len(s) - i - 1

    def test_probe_runs_every_nth_call_and_is_delivered_marked(self, params):
        _, tp = params
        eng = _port_engine(tp, "w4a8")
        eng.guardrails = GuardrailConfig(lee_probe_every=3, lee_limit=1e-12,
                                         on_flag="mark")
        graphs = _graphs([6, 9], seed=13)
        for _ in range(7):
            res = eng.infer_batch(graphs)
        assert eng.guard_stats["lee_probes"] == 7 // 3
        assert eng.dispatch_stats["dense"] == 7 + 7 // 3
        assert all(f.reason != "lee" for r in res for f in r.flags)
        eng.guardrails = dataclasses.replace(eng.guardrails,
                                             lee_probe_every=1)
        res = eng.infer_batch(graphs)
        assert all(r.flags and r.flags[0].severity == "suspect"
                   for r in res)
        with pytest.raises(GuardrailViolation, match="lee"):
            eng.infer_batch(graphs, on_flag="raise")

    def test_probe_call_breakdown_covers_both_runs(self, params):
        _, tp = params
        eng = _port_engine(tp, "w4a8")
        graphs = _graphs([6, 9], seed=13)
        eng.infer_batch(graphs)
        assert eng.last_infer_breakdown["n_plans"] == 1
        eng.guardrails = GuardrailConfig(lee_probe_every=1, on_flag="mark")
        t0 = time.monotonic()
        eng.infer_batch(graphs)
        wall = time.monotonic() - t0
        bd = eng.last_infer_breakdown
        assert bd["n_plans"] == 2
        assert 0 < bd["prep_s"] + bd["dispatch_s"] + bd["sync_s"] \
            <= bd["total_s"] <= wall


# -- (g) the CLI -----------------------------------------------------------------

SMALL = ["--workload", "so3", "--device", "cpu", "--feat", "16",
         "--vec-feat", "4", "--layers", "1", "--dir-bits", "4",
         "--buckets", "16", "32", "--max-batch", "8", "--min-atoms", "4",
         "--max-atoms", "24", "--density", "0.1"]
REPO = Path(__file__).resolve().parents[1]


class TestCLI:
    def test_one_shot(self, capsys):
        cli.main(SMALL + ["--graphs", "6", "--mode", "w4a8", "--path",
                          "sparse", "--lee"])
        out = capsys.readouterr().out
        assert "mode=w4a8 device=cpu" in out
        assert "infer_batch: 6 molecules" in out and "served-model LEE" in out

    def test_server_save_then_artifact(self, tmp_path, capsys):
        path = str(tmp_path / "m.npz")
        cli.main(SMALL + ["--graphs", "2", "--save-artifact", path])
        assert "packed artifact" in capsys.readouterr().out
        cli.main(SMALL + ["--server", "--artifact", path, "--requests", "12",
                          "--rate", "200", "--deadline-ms", "5",
                          "--guardrails"])
        out = capsys.readouterr().out
        assert "cold start from" in out and "guardrails:" in out
        assert "open loop: 12 requests" in out and "latency: p50" in out
        assert "batching:" in out and "dispatch:" in out
        with pytest.raises(ArtifactError, match="mode"):
            cli.main(SMALL + ["--artifact", path, "--mode", "w4a8"])

    def test_artifact_keeps_its_serving_knobs(self, params, tmp_path,
                                              monkeypatch):
        _, tp = params
        path = str(tmp_path / "sparse.npz")
        save_artifact(path, _port_engine(tp, "w4a8", path="sparse",
                                         mddq_kernel=True, edge_capacity=1024))
        engines = []

        def loading(*args, **kw):
            engines.append(load_engine(*args, **kw))
            return engines[-1]
        monkeypatch.setattr(cli, "load_engine", loading)
        cli.main(SMALL + ["--graphs", "4", "--artifact", path])
        cli.main(SMALL + ["--graphs", "4", "--artifact", path, "--path",
                          "dense"])
        first, second = engines
        assert (first.serve.path, first.serve.mddq_kernel,
                first.serve.edge_capacity) == ("sparse", True, 1024)
        assert first.serve.bucket_sizes == (16, 32) \
            and first.serve.max_batch == 8
        assert first.dispatch_stats["sparse"] > 0 \
            and first.dispatch_stats["dense"] == 0
        assert (second.serve.path, second.serve.mddq_kernel) \
            == ("dense", True)
        assert second.dispatch_stats["sparse"] == 0

    @pytest.mark.parametrize("flag", [["--metrics-out", "m.prom"],
                                      ["--alerts-out", "a.jsonl"],
                                      ["--trace-out", "t.jsonl"]])
    def test_unported_flags_exit_naming_roadmap(self, capsys, tmp_path,
                                                monkeypatch, flag):
        """The JAX launcher's obs flags, once refused, now write their
        files: the metrics exposition counts the replay's requests, the
        trace file holds one trace per request, and the health plane runs
        beside a cluster replay with the pool subscribed to its alerts."""
        out = str(tmp_path / flag[1])
        # the process registry outlives each run: count this run's writes
        submitted = REGISTRY.counter("serve_requests_total",
                                     surface="scheduler", event="submitted")
        before = int(submitted.value)
        cluster = ["--replicas", "2"] if flag[0] == "--alerts-out" else []
        from repro_torch.cluster import ClusterPool
        watched = []
        plain = ClusterPool.watch_alerts

        def watch(pool, bus):
            watched.append(bus)
            return plain(pool, bus)
        monkeypatch.setattr(ClusterPool, "watch_alerts", watch)
        args = cli.main(SMALL + ["--server", "--requests", "12", "--rate",
                                 "200", "--deadline-ms", "5",
                                 "--export-interval", "0.05",
                                 "--health-interval", "0.05", flag[0], out]
                        + cluster)
        text = Path(out).read_text()
        if flag[0] == "--metrics-out":
            assert text.startswith("# exported_at ")
            assert 'serve_requests_total{event="submitted",' \
                f'surface="scheduler"}} {before + 12}' in text.splitlines()
            assert args._exporter.n_exports >= 1
        elif flag[0] == "--trace-out":
            docs = [json.loads(ln) for ln in text.splitlines()]
            assert len(docs) == 12 and all(d["kind"] == "request"
                                           and d["status"] == "ok"
                                           for d in docs)
        else:
            # every line an alert; the pool subscribed to the bus (it hears
            # the alerts published while it serves, none before it is
            # built: the process registry may page at the first step)
            for ln in text.splitlines():
                assert set(json.loads(ln)) >= {"name", "severity", "source"}
            assert args._health.n_steps >= 1
            assert watched == [args._alert_bus]
            assert args._pool.stats()["alerts"]["n_seen"] \
                <= len(text.splitlines()) == args._alert_bus.n_published
        assert "health plane:" in capsys.readouterr().out \
            or flag[0] != "--alerts-out"

    def test_obs_flag_defaults_are_the_jax_launchers(self):
        args = cli.parser().parse_args(["--workload", "so3"])
        assert (args.metrics_out, args.trace_out, args.alerts_out,
                args.export_interval, args.health_interval) \
            == (None, None, None, 5.0, 1.0)

    def test_jax_scripts_read_the_clis_files(self, tmp_path):
        """``scripts/obs_top.py`` and ``scripts/trace_report.py
        --chrome-trace`` of the JAX package read the port's CLI output
        unchanged (a tiered cluster with an MD session: request and chunk
        traces)."""
        paths = {k: str(tmp_path / k) for k in ("m.prom", "t.jsonl",
                                                  "a.jsonl", "c.json")}
        cli.main(SMALL + ["--server", "--requests", "12", "--rate", "200",
                          "--deadline-ms", "5", "--mode", "w4a8", "--tiers",
                          "w4a8:1,w8a8:1", "--guardrails", "--md-session",
                          "20", "--metrics-out", paths["m.prom"],
                          "--trace-out", paths["t.jsonl"], "--alerts-out",
                          paths["a.jsonl"], "--export-interval", "0.05",
                          "--health-interval", "0.05"])
        env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
        top = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "obs_top.py"),
             paths["m.prom"], "--once"],
            capture_output=True, text=True, timeout=60, env=env)
        assert top.returncode == 0, top.stderr
        assert "requests:" in top.stdout and "SLOs:" in top.stdout
        report = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "trace_report.py"),
             paths["t.jsonl"], "--chrome-trace", paths["c.json"]],
            capture_output=True, text=True, timeout=120, env=env)
        assert report.returncode == 0, report.stderr
        assert "13 trace(s)" in report.stdout      # 12 requests, 1 chunk
        doc = json.loads(Path(paths["c.json"]).read_text())
        assert doc["otherData"]["n_traces"] == 13
