"""The port's MD slice against the JAX package's, on the CPU.

Same small config as ``tests/test_md_engine.py``; both packages get the
same weights (the JAX ``init_params``, handed over as numpy) and the same
molecules and initial velocities. Tolerances: the device edge list and
the refined mask bit for bit; the refined sparse forward under
``test_torch_serving``'s rule (1e-5 in fp32, 1e-4 of the largest |value|
in the quantized modes); 20-step trajectories to 1e-4 on coordinates and
total energy in fp32 and in w8a8 with MDDQ off, where the two packages
round the same A8 codes (measured: <= 5e-7). Then the semantics of
``tests/test_md_engine.py`` on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.md import MDConfig as JMDConfig
from repro.md import MDEngine as JMDEngine
from repro.md import energy_drift_rate as j_drift_rate
from repro.md import nve_trajectory as j_nve_trajectory
from repro.md.nve import MDState as JMDState
from repro.models import so3krates as jso3
from repro.serving import qparams as jqp
from repro.serving.bucketing import device_edge_list as j_device_edge_list
from repro.serving.forward import \
    sparse_energy_and_forces as j_sparse_energy_and_forces
from repro_torch.guardrails import GuardrailViolation
from repro_torch.kernels import ops
from repro_torch.md import (MDConfig, MDEngine, MDState, energy_drift_rate,
                            nve_trajectory, pad_replicas)
from repro_torch.md.neighbor import build_neighbor_list, needs_rebuild
from repro_torch.models import so3krates as tso3
from repro_torch.obs.metrics import REGISTRY
from repro_torch.serving import QuantizedEngine, ServeConfig
from repro_torch.serving import bucketing as tb
from repro_torch.serving import qparams as tqp
from repro_torch.serving.forward import sparse_energy_and_forces
from repro_torch.weights import params_from_numpy

CFG_KW = dict(feat=16, vec_feat=4, n_layers=1, n_rbf=4, dir_bits=6,
              cutoff=3.0)
JCFG = jso3.So3kratesConfig(**CFG_KW)
TCFG = tso3.So3kratesConfig(**CFG_KW)
QUANT_REL = 1e-4
TRAJ_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jso3.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      JCFG)
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                 "cpu")


def _padded_batch(ns, cap, seed=0, spread=2.0):
    rng = np.random.default_rng(seed)
    B = len(ns)
    species = np.zeros((B, cap), np.int32)
    coords = np.zeros((B, cap, 3), np.float32)
    mask = np.zeros((B, cap), bool)
    for b, n in enumerate(ns):
        species[b, :n] = rng.integers(0, JCFG.n_species, n)
        coords[b, :n] = rng.normal(size=(n, 3)) * spread
        mask[b, :n] = True
    return species, coords, mask


def _molecule(n, seed=0, density=0.1):
    rng = np.random.default_rng(seed)
    side = (n / density) ** (1.0 / 3.0)
    return (rng.integers(0, JCFG.n_species, n).astype(np.int32),
            rng.uniform(0, side, size=(n, 3)).astype(np.float32))


def _both_edge_lists(coords, mask, cutoff, ec):
    j = j_device_edge_list(jnp.asarray(coords), jnp.asarray(mask), cutoff,
                           ec)
    t = tb.device_edge_list(_t(coords), _t(mask), cutoff, ec)
    return [np.asarray(a) for a in j], [_np(a) for a in t]


class TestDeviceEdgeList:
    @pytest.mark.parametrize("ns,cap,ec", [([5, 16, 1, 9], 16, 256),
                                           ([12, 30, 7], 32, 512)])
    @pytest.mark.parametrize("seed", [10, 11, 12])
    def test_bit_for_bit_with_jax_and_the_host_builder(self, ns, cap, ec,
                                                       seed):
        _, coords, mask = _padded_batch(ns, cap, seed=seed)
        j, t = _both_edge_lists(coords, mask, JCFG.cutoff, ec)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b, a)
        assert t[0].dtype == t[1].dtype == np.int32 and t[2].dtype == bool
        host = tb.build_edge_list(coords, mask, JCFG.cutoff, ec)
        np.testing.assert_array_equal(t[0], host.senders)
        np.testing.assert_array_equal(t[1], host.receivers)
        np.testing.assert_array_equal(t[2], host.edge_mask)
        assert int(t[3].sum()) == host.n_real

    def test_overflow_counts(self):
        """Where the host builder returns None, both device builders
        return the per-molecule counts above the capacity."""
        _, coords, mask = _padded_batch([16, 16], 16, seed=2, spread=0.4)
        assert tb.build_edge_list(coords, mask, JCFG.cutoff, 128) is None
        j, t = _both_edge_lists(coords, mask, JCFG.cutoff, 128)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(
            t[3], tb.count_edges(coords, mask, JCFG.cutoff))
        assert (t[3] > 128).any()

    def test_capacity_beyond_complete_graph(self):
        """ec > cap^2: every real edge fits, the surplus slots are padding
        self-loops on the molecule's first atom."""
        _, coords, mask = _padded_batch([4, 3], 4, seed=1, spread=0.5)
        j, t = _both_edge_lists(coords, mask, JCFG.cutoff, 128)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b, a)
        assert t[2].sum() == 12 + 6
        np.testing.assert_array_equal(t[1][128 + 16:], 4)
        np.testing.assert_array_equal(t[0][128 + 16:], 4)


def _skin_problem(seed=7, skin=0.8):
    """A skin list at cutoff + skin and coordinates moved by < skin / 2."""
    _, coords, mask = _padded_batch([14, 9], 16, seed=seed)
    rng = np.random.default_rng(seed + 1)
    delta = rng.normal(size=coords.shape).astype(np.float32)
    delta *= 0.3 / np.linalg.norm(delta, axis=-1, keepdims=True)
    moved = coords + delta * mask[..., None]
    nl = build_neighbor_list(_t(coords), _t(mask), TCFG.cutoff, skin, 256)
    return coords, moved, mask, nl


class TestRefinedMask:
    def test_identical_to_jax_and_to_a_fresh_list(self):
        _, moved, mask, nl = _skin_problem()
        assert not bool(needs_rebuild(nl, _t(moved), _t(mask), 0.8))
        flat = moved.reshape(-1, 3)
        em = _np(ops.refine_edge_mask(_t(flat), nl.senders, nl.receivers,
                                      nl.edge_mask, TCFG.cutoff))
        jem = np.asarray(jops.refine_edge_mask(
            jnp.asarray(flat), jnp.asarray(_np(nl.senders)),
            jnp.asarray(_np(nl.receivers)), jnp.asarray(_np(nl.edge_mask)),
            JCFG.cutoff))
        np.testing.assert_array_equal(em, jem)
        # holes inside receivers' runs: what the edge softmax must take
        assert (em != _np(nl.edge_mask)).any()
        s2, r2, m2, _ = tb.device_edge_list(_t(moved), _t(mask),
                                            TCFG.cutoff, 256)
        s, r = _np(nl.senders), _np(nl.receivers)
        assert set(zip(s[em], r[em])) == set(zip(_np(s2)[_np(m2)],
                                                 _np(r2)[_np(m2)]))

    @pytest.mark.parametrize("mode", ["fp32", "w8a8", "w4a8"])
    def test_refined_sparse_forward_matches_jax(self, params, mode):
        """``sparse_energy_and_forces(refine_cutoff=True)`` on a skin list
        against the JAX function (its K3 Pallas kernel in interpret mode,
        its quantized products through the integer oracle); the port's
        MDDQ goes through the encode kernel's plain version, as on the
        MD path."""
        jp, tp = params
        species, _, _ = _padded_batch([14, 9], 16, seed=7)
        _, moved, mask, nl = _skin_problem()
        qv = mode != "fp32"
        lists = [_np(a) for a in (nl.senders, nl.receivers, nl.edge_mask)]
        je, jf = jax.jit(lambda c: j_sparse_energy_and_forces(
            jqp.quantize_so3_params(jp, mode), JCFG, jnp.asarray(species),
            c, jnp.asarray(mask), *(jnp.asarray(a) for a in lists),
            quant_vectors=qv, use_kernels=False, edge_kernel=True,
            refine_cutoff=True))(jnp.asarray(moved))
        te, tf = sparse_energy_and_forces(
            tqp.quantize_so3_params(tp, mode), TCFG, _t(species), _t(moved),
            _t(mask), *(_t(a) for a in lists), quant_vectors=qv,
            mddq_kernel=True, refine_cutoff=True)
        for a, b, what in ((te, je, "energies"), (tf, jf, "forces")):
            a, b = _np(a), np.asarray(b)
            if mode == "fp32":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                           err_msg=what)
            else:
                err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
                assert err <= QUANT_REL, f"{what}: {err}"
        assert (_np(tf)[~mask] == 0).all()


def _md_config(mode="fp32", **kw):
    return dict(mode=mode, dt_fs=0.25, record_every=10, **kw)


def _engine(params, mode="fp32", **kw):
    return MDEngine(TCFG, params[1], md=MDConfig(**_md_config(mode, **kw)),
                    device="cpu")


class TestMDEngineMatchesJax:
    @pytest.mark.parametrize("mode,quant_vectors,skin", [
        ("fp32", None, 0.02),      # a few skin rebuilds inside the run
        ("w8a8", False, 0.0)])     # a rebuild every step
    def test_trajectory(self, params, mode, quant_vectors, skin):
        jp, tp = params
        sp, co = _molecule(20, seed=3)
        spec, coords, mask = pad_replicas(sp, co, 2)
        masses = np.full(20, 12.0, np.float32)
        kw = _md_config(mode, skin=skin, quant_vectors=quant_vectors)
        jeng = JMDEngine(JCFG, jp, md=JMDConfig(**kw))
        j0 = jeng.init_state(jax.random.PRNGKey(5), spec, coords, mask,
                             masses, 300.0, edge_capacity=640)
        v0 = np.asarray(j0.veloc)
        js, jrec = jeng.run(j0, spec, mask, masses, n_steps=20)
        teng = MDEngine(TCFG, tp, md=MDConfig(**kw), device="cpu")
        t0 = teng.init_state(0, spec, coords, mask, masses, 300.0,
                             edge_capacity=640, veloc=v0)
        np.testing.assert_allclose(_np(t0.forces), np.asarray(j0.forces),
                                   rtol=1e-5, atol=1e-6)
        ts, trec = teng.run(t0, spec, mask, masses, n_steps=20)
        np.testing.assert_allclose(_np(ts.coords), np.asarray(js.coords),
                                   atol=TRAJ_ATOL)
        np.testing.assert_allclose(trec["e_tot"], jrec["e_tot"],
                                   atol=TRAJ_ATOL)
        assert trec["e_tot"].shape == jrec["e_tot"].shape == (2, 2)
        assert trec["n_rebuilds"] == jrec["n_rebuilds"] > 0
        assert trec["missed_edges"] == jrec["missed_edges"] == 0

    def test_nve_trajectory_and_drift_rate(self):
        c0 = np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)
        v0 = np.random.default_rng(1).normal(size=(3, 3)).astype(np.float32)
        masses = np.ones(3, np.float32)
        js, je = j_nve_trajectory(
            JMDState(jnp.asarray(c0), jnp.asarray(v0), -jnp.asarray(c0)),
            jnp.asarray(masses), lambda c: -c,
            lambda c: 0.5 * jnp.sum(c ** 2), dt_fs=0.5, n_steps=11,
            record_every=4)
        ts, te = nve_trajectory(
            MDState(_t(c0), _t(v0), -_t(c0)), _t(masses), lambda c: -c,
            lambda c: 0.5 * (c ** 2).sum(), dt_fs=0.5, n_steps=11,
            record_every=4)
        np.testing.assert_allclose(_np(ts.coords), np.asarray(js.coords),
                                   atol=1e-6)
        np.testing.assert_allclose(_np(te), np.asarray(je), atol=1e-6)
        e = np.asarray(je)[:2]
        assert energy_drift_rate(e, 0.5, 4, 3) == pytest.approx(
            j_drift_rate(jnp.asarray(e), 0.5, 4, 3), rel=1e-4)


class TestMDSemantics:
    def test_skin_trajectory_matches_fresh_rebuild(self, params):
        sp, co = _molecule(20, seed=3)
        spec, coords, mask = pad_replicas(sp, co, 1)
        masses = np.full(20, 12.0, np.float32)
        results = []
        for skin in (0.0, 0.6):
            eng = _engine(params, skin=skin)
            st = eng.init_state(5, spec, coords, mask, masses, 300.0,
                                edge_capacity=640)
            st, rec = eng.run(st, spec, mask, masses, n_steps=40)
            results.append((_np(st.coords), rec))
        (c_fresh, r_fresh), (c_skin, r_skin) = results
        assert r_fresh["n_rebuilds"] == 40
        assert r_skin["n_rebuilds"] < 40
        np.testing.assert_allclose(c_skin, c_fresh, atol=1e-4)
        np.testing.assert_allclose(r_skin["e_tot"], r_fresh["e_tot"],
                                   atol=1e-4)

    def test_conservative_over_1000_steps(self, params):
        """Zero missed cutoff edges over 1,100 steps, audited every step
        on the device, with rebuilds deferred yet taken."""
        sp, co = _molecule(20, seed=4)
        spec, coords, mask = pad_replicas(sp, co, 1)
        masses = np.full(20, 12.0, np.float32)
        eng = _engine(params, skin=0.5, track_missed=True)
        st = eng.init_state(6, spec, coords, mask, masses, 250.0,
                            edge_capacity=640)
        st, rec = eng.run(st, spec, mask, masses, n_steps=1100,
                          record_every=100)
        assert rec["missed_edges"] == 0
        assert 0 < rec["n_rebuilds"] < 1100
        assert np.isfinite(rec["e_tot"]).all()

    def test_count_missed_sees_a_stale_list(self, params):
        """The audit itself: a list built at the true cutoff with no skin,
        kept while atoms move, misses the edges that have closed."""
        coords, moved, mask, _ = _skin_problem()
        eng = _engine(params)
        nl = build_neighbor_list(_t(coords), _t(mask), TCFG.cutoff, 0.0,
                                 256)

        def pairs(el):
            return set(zip(el.senders[el.edge_mask],
                           el.receivers[el.edge_mask]))
        closed = (pairs(tb.build_edge_list(moved, mask, TCFG.cutoff, 256))
                  - pairs(tb.build_edge_list(coords, mask, TCFG.cutoff,
                                             256)))
        missed = int(eng._count_missed(_t(moved), _t(mask), nl))
        assert missed == len(closed) > 0
        nl_new = build_neighbor_list(_t(moved), _t(mask), TCFG.cutoff, 0.0,
                                     256)
        assert int(eng._count_missed(_t(moved), _t(mask), nl_new)) == 0

    def test_replica_batch_matches_single(self, params):
        sp, co = _molecule(12, seed=13)
        masses = np.full(16, 12.0, np.float32)
        eng = _engine(params, mode="w8a8")
        spec1, co1, mask1 = pad_replicas(sp, co, 1, capacity=16)
        st0 = eng.init_state(4, spec1, co1, mask1, masses, 200.0,
                             edge_capacity=256)
        st1, rec1 = eng.run(st0, spec1, mask1, masses, n_steps=20)
        specB, coB, maskB = pad_replicas(sp, co, 3, capacity=16)
        stB = eng.init_state(4, specB, coB, maskB,
                             np.broadcast_to(masses, (3, 16)), 200.0,
                             edge_capacity=256,
                             veloc=np.broadcast_to(_np(st0.veloc),
                                                   (3, 16, 3)))
        stB, recB = eng.run(stB, specB, maskB, masses, n_steps=20)
        for b in range(3):
            np.testing.assert_allclose(_np(stB.coords)[b],
                                       _np(st1.coords)[0], atol=1e-5)
        np.testing.assert_allclose(recB["e_tot"][:, 0], rec1["e_tot"][:, 0],
                                   atol=1e-5)
        # padded atoms never move and feel no force
        assert (_np(stB.coords)[~maskB] == 0).all()
        assert (_np(stB.forces)[~maskB] == 0).all()

    def test_overflow_raises(self, params):
        sp, co = _molecule(16, seed=15, density=2.0)
        spec, coords, mask = pad_replicas(sp, co, 1)
        with pytest.raises(ValueError, match="overflow"):
            _engine(params).init_state(0, spec, coords, mask,
                                       np.full(16, 12.0, np.float32), 300.0,
                                       edge_capacity=128)

    def test_remainder_steps_are_integrated(self, params):
        """25 steps at record_every 10: three records, the last after 5
        steps, and the same end state as one 25-step segment."""
        sp, co = _molecule(12, seed=17)
        spec, coords, mask = pad_replicas(sp, co, 1)
        masses = np.full(12, 12.0, np.float32)
        eng = _engine(params)
        st0 = eng.init_state(1, spec, coords, mask, masses, 200.0)
        st_a, rec_a = eng.run(st0, spec, mask, masses, n_steps=25)
        st_b, rec_b = eng.run(st0, spec, mask, masses, n_steps=25,
                              record_every=25)
        assert rec_a["e_tot"].shape == (3, 1) and rec_b["e_tot"].shape == (1,
                                                                          1)
        np.testing.assert_allclose(_np(st_a.coords), _np(st_b.coords),
                                   atol=1e-6)
        np.testing.assert_allclose(rec_a["e_tot"][-1], rec_b["e_tot"][-1],
                                   atol=1e-6)

    def test_guardrails_at_checkpoints(self, params):
        sp, co = _molecule(12, seed=19)
        spec, coords, mask = pad_replicas(sp, co, 1)
        masses = np.full(12, 12.0, np.float32)
        eng = _engine(params, drift_limit=1e-12)
        st = eng.init_state(2, spec, coords, mask, masses, 300.0)
        with pytest.raises(GuardrailViolation) as exc:
            eng.run(st, spec, mask, masses, n_steps=30)
        assert exc.value.reason == "energy_drift"
        gauge = REGISTRY.gauge("md_energy_drift_ratio", mode="fp32")
        assert gauge.value > 1.0
        bad = st._replace(veloc=torch.full_like(st.veloc, float("nan")))
        with pytest.raises(GuardrailViolation) as exc:
            _engine(params).run(bad, spec, mask, masses, n_steps=10)
        assert exc.value.reason == "nonfinite"

    def test_serving_engine_bridge(self, params):
        _, tp = params
        serve = QuantizedEngine(TCFG, tp, ServeConfig(
            mode="w8a8", bucket_sizes=(16,), max_batch=4), device="cpu")
        eng = serve.md_engine()
        assert eng.qparams is serve.qparams and eng.device == serve.device
        sp, co = _molecule(12, seed=17)
        spec, coords, mask = pad_replicas(sp, co, 1, capacity=16)
        masses = np.full(16, 12.0, np.float32)
        st = eng.init_state(0, spec, coords, mask, masses, 200.0)
        st, rec = eng.run(st, spec, mask, masses, n_steps=10)
        assert np.isfinite(rec["e_tot"]).all()
        with pytest.raises(ValueError, match="mode"):
            serve.md_engine(MDConfig(mode="fp32"))
        occ = serve.edge_occupancy([tb.Graph(sp, co)])
        assert occ["molecules_overflowing"] == 0
        assert 0 < occ["max_occupancy"] <= 1.0

    def test_raises_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MDEngine(TCFG, md=MDConfig(mode="fp32"))
