"""The port's serving slice against the JAX package's, on the CPU.

Both packages get the same weights (the JAX package's ``init_params``,
handed over as numpy through ``params_from_numpy``) and the same
molecules. Host builders must agree exactly, quantized parameters
exactly, ``qmatmul`` to 1e-6 with identical A8 codes. The whole engine
is held to 1e-5 in ``fp32`` mode; in ``w8a8``/``w4a8`` to 1e-4 relative
to the largest |value|, because there an ulp of summation-order
difference before an A8 rounding or a codebook argmax can move one
whole code, which moves the result by far more than an ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lee import random_rotations as j_random_rotations
from repro.models import so3krates as jso3
from repro.serving import QuantizedEngine as JEngine
from repro.serving import ServeConfig as JServe
from repro.serving import bucketing as jb
from repro.serving import qparams as jqp
from repro_torch.core import lee as tlee
from repro_torch.guardrails import GuardrailConfig, GuardrailViolation
from repro_torch.models import so3krates as tso3
from repro_torch.serving import QuantizedEngine, ServeConfig
from repro_torch.serving import bucketing as tb
from repro_torch.serving import qparams as tqp
from repro_torch.serving.forward import (batched_energy_and_forces,
                                         sparse_energy_and_forces)
from repro_torch.weights import params_from_numpy

CFG_KW = dict(feat=16, vec_feat=4, n_layers=2, n_rbf=4, dir_bits=6,
              cutoff=3.0)
JCFG = jso3.So3kratesConfig(**CFG_KW)
TCFG = tso3.So3kratesConfig(**CFG_KW)
# the tolerance of the quantized modes, relative to the largest |value|
QUANT_REL = 1e-4


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jso3.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      JCFG)
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                 "cpu")


def _graphs(seed=0, n=6):
    gs = tb.random_graphs(n, 1, 14, TCFG.n_species, seed=seed)
    gs[0] = tb.Graph(np.array([3], np.int32), np.zeros((1, 3), np.float32))
    return gs


def _serve_kw(mode, path):
    return dict(mode=mode, path=path, bucket_sizes=(16,), max_batch=8)


@pytest.fixture(scope="module")
def jax_served(params):
    """The JAX engine's results on ``_graphs()`` per (mode, path), each
    computed once for the module (one jit compile each) and shared by the
    forward and engine tests."""
    jp, _ = params
    cache = {}

    def get(mode, path):
        if (mode, path) not in cache:
            cache[mode, path] = JEngine.from_config(
                JCFG, params=jp, serve=JServe(**_serve_kw(mode, path))) \
                .infer_batch(_graphs())
        return cache[mode, path]
    return get


def _assert_close(a, b, mode, what):
    a, b = np.asarray(a), np.asarray(b)
    if mode == "fp32":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=what)
    else:
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert err <= QUANT_REL, f"{what}: {err} relative to max |value|"


class TestHostBuilders:
    def test_graphs_plans_padding_and_edge_lists_identical(self):
        tg = tb.random_graphs(12, 1, 30, 20, seed=3, density=0.05)
        jg = jb.random_graphs(12, 1, 30, 20, seed=3, density=0.05)
        for a, b in zip(tg, jg):
            np.testing.assert_array_equal(a.species, b.species)
            np.testing.assert_array_equal(a.coords, b.coords)
        tspec = [tb.BucketSpec(c, max_batch=4) for c in (16, 32)]
        jspec = [jb.BucketSpec(c, max_batch=4) for c in (16, 32)]
        tplans = tb.plan_batches(tg, tspec)
        jplans = jb.plan_batches(jg, jspec)
        assert [(p.bucket.capacity, p.batch_size, p.graph_indices)
                for p in tplans] == [(p.bucket.capacity, p.batch_size,
                                      p.graph_indices) for p in jplans]
        for tp, jp in zip(tplans, jplans):
            for a, b in zip(tb.pad_graphs(tg, tp), jb.pad_graphs(jg, jp)):
                np.testing.assert_array_equal(a, b)
            _, coords, mask = tb.pad_graphs(tg, tp)
            np.testing.assert_array_equal(tb.count_edges(coords, mask, 3.0),
                                          jb.count_edges(coords, mask, 3.0))
            ec = tp.bucket.edges
            assert ec == jp.bucket.edges
            te = tb.build_edge_list(coords, mask, 3.0, ec)
            je = jb.build_edge_list(coords, mask, 3.0, ec)
            for f in ("senders", "receivers", "edge_mask"):
                np.testing.assert_array_equal(getattr(te, f), getattr(je, f))
            assert (te.edge_capacity, te.n_real) == (je.edge_capacity,
                                                     je.n_real)
        for cap in (16, 32, 64, 128):
            assert tb.default_edge_capacity(cap) == \
                jb.default_edge_capacity(cap)


class TestQParams:
    @pytest.mark.parametrize("mode", ["fp32", "w8a8", "w4a8"])
    def test_quantized_params_exact(self, params, mode):
        jp, tp = params
        jq = jqp.quantize_so3_params(jp, mode)
        tq = tqp.quantize_so3_params(tp, mode)
        assert set(jq) == set(tq)
        for name, j in jq.items():
            t = tq[name]
            if isinstance(j, jqp.QTensor):
                assert t.kind == j.kind, name
                np.testing.assert_array_equal(_np(t.data), np.asarray(j.data))
                if j.scale is not None:
                    np.testing.assert_array_equal(_np(t.scale),
                                                  np.asarray(j.scale))
                np.testing.assert_array_equal(_np(t.dequantize()),
                                              np.asarray(j.dequantize()))
            else:
                np.testing.assert_array_equal(_np(t), np.asarray(j))
        assert tqp.serving_bytes(tq) == jqp.serving_bytes(jq)

    @pytest.mark.parametrize("kind_mode", ["w8a8", "w4a8"])
    def test_qmatmul_and_straight_through_backward(self, params, kind_mode):
        jp, tp = params
        name = "layer0/wa"                      # w4 in w4a8, w8 in w8a8
        jqt = jqp.quantize_so3_params(jp, kind_mode)[name]
        tqt = tqp.quantize_so3_params(tp, kind_mode)[name]
        x = np.random.default_rng(1).normal(size=(40, 16)).astype(np.float32)
        g = np.random.default_rng(2).normal(size=(40, 4)).astype(np.float32)
        for jfn, tfn in ((jqp.qmatmul, tqp.qmatmul),
                         (jqp.ref_qmatmul, tqp.ref_qmatmul)):
            jy, vjp = jax.vjp(lambda a: jfn(a, jqt), jnp.asarray(x))
            xt = _t(x).requires_grad_()
            ty = tfn(xt, tqt)
            np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-6,
                                       atol=1e-6)
            (gx,) = torch.autograd.grad(ty, xt, _t(g))
            np.testing.assert_allclose(_np(gx),
                                       np.asarray(vjp(jnp.asarray(g))[0]),
                                       rtol=1e-5, atol=1e-6)

    def test_concat_is_exact_column_split(self, params):
        _, tp = params
        q = tqp.quantize_so3_params(tp, "w4a8")
        parts = [q["layer0/wa"], q["layer0/wb"]]
        fused = tqp.concat_qtensors(parts)
        x = torch.randn(9, 16)
        np.testing.assert_array_equal(
            _np(tqp.qmatmul(x, fused)),
            _np(torch.cat([tqp.qmatmul(x, p) for p in parts], 1)))
        with pytest.raises(ValueError):
            tqp.concat_qtensors([q["layer0/wa"], q["layer0/wq"]])


def _batch(graphs, cap=16):
    """The engine's one padded batch for ``graphs``, its edge list and the
    graph index of each batch row."""
    plan = jb.plan_batches(graphs, [jb.BucketSpec(cap, max_batch=8)])[0]
    species, coords, mask = jb.pad_graphs(graphs, plan)
    el = jb.build_edge_list(coords, mask, JCFG.cutoff,
                            jb.default_edge_capacity(cap))
    return species, coords, mask, el, plan.graph_indices


class TestForward:
    @pytest.mark.parametrize("mode", ["fp32", "w8a8", "w4a8"])
    def test_forward_functions_match_jax_reference(self, params, jax_served,
                                                   mode):
        """The port's forward functions on the engine's padded batch
        against the JAX engine's results for the same molecules (the JAX
        forwards under jit, the quantized products through the Pallas
        kernels in interpret mode, within 1e-6 of their plain reference).
        The port's CPU path is its plain path."""
        _, tp = params
        tq = tqp.quantize_so3_params(tp, mode)
        graphs = _graphs()
        species, coords, mask, el, rows = _batch(graphs)
        qv = mode != "fp32"
        dense = batched_energy_and_forces(
            tq, TCFG, _t(species), _t(coords), _t(mask), quant_vectors=qv)
        sparse = sparse_energy_and_forces(
            tq, TCFG, *(_t(a) for a in (species, coords, mask, el.senders,
                                        el.receivers, el.edge_mask)),
            quant_vectors=qv, mddq_kernel=True)
        for path, (te, tf) in (("dense", dense), ("sparse", sparse)):
            jr = jax_served(mode, path)
            te, tf = _np(te), _np(tf)
            _assert_close([te[row] for row in range(len(rows))],
                          [jr[g].energy for g in rows], mode,
                          f"{path} energies")
            _assert_close(
                np.concatenate([tf[row, :graphs[g].n_atoms]
                                for row, g in enumerate(rows)]),
                np.concatenate([jr[g].forces for g in rows]), mode,
                f"{path} forces")
            # padded atoms: exactly zero force on both paths
            assert (tf[~mask] == 0).all()

    def test_padded_and_isolated_atoms(self, params):
        _, tp = params
        tq = tqp.quantize_so3_params(tp, "w4a8")
        species, coords, mask, el, _ = _batch(_graphs(seed=4))
        coords[1, 0] = 100.0                      # an isolated real atom
        el = tb.build_edge_list(coords, mask, TCFG.cutoff, el.edge_capacity)
        outs = [batched_energy_and_forces(tq, TCFG, _t(species), _t(coords),
                                          _t(mask), mddq_kernel=True),
                sparse_energy_and_forces(
                    tq, TCFG, *(_t(a) for a in (
                        species, coords, mask, el.senders, el.receivers,
                        el.edge_mask)), mddq_kernel=True)]
        for e, f in outs:
            f = _np(f)
            assert np.isfinite(_np(e)).all() and np.isfinite(f).all()
            assert (f[~mask] == 0).all()
            assert (f[1, 0] == 0).all()           # no neighbour, no force
        np.testing.assert_allclose(_np(outs[0][1]), _np(outs[1][1]),
                                   rtol=1e-5, atol=1e-5)


class TestEngine:
    @pytest.mark.parametrize("mode", ["fp32", "w8a8", "w4a8"])
    @pytest.mark.parametrize("path", ["dense", "sparse"])
    def test_engine_matches_jax_engine(self, params, jax_served, mode, path):
        _, tp = params
        jr = jax_served(mode, path)
        eng = QuantizedEngine.from_config(
            TCFG, params=tp, serve=ServeConfig(**_serve_kw(mode, path)),
            device="cpu")
        tr = eng.infer_batch(_graphs())
        assert eng.dispatch_stats[path] == 1
        assert [r.path for r in tr] == [r.path for r in jr]
        _assert_close([r.energy for r in tr], [r.energy for r in jr], mode,
                      "energies")
        _assert_close(np.concatenate([r.forces for r in tr]),
                      np.concatenate([r.forces for r in jr]), mode, "forces")
        for t, j in zip(tr, jr):
            assert t.forces.shape == j.forces.shape
            assert (t.bucket_capacity, t.batch_size) == (j.bucket_capacity,
                                                         j.batch_size)

    def test_dispatch_fallback_warmup_and_diagnostics(self, params):
        _, tp = params
        eng = QuantizedEngine.from_config(
            TCFG, params=tp, device="cpu",
            serve=ServeConfig(mode="w4a8", path="sparse", bucket_sizes=(16,),
                              max_batch=4, edge_capacity=128,
                              mddq_kernel=True))
        assert eng.warmup() > 0
        dense_mol = tb.Graph(np.zeros(16, np.int32),
                             (np.random.default_rng(0).normal(size=(16, 3))
                              * 0.3).astype(np.float32))
        res = eng.infer_batch([dense_mol])        # 240 edges > 128 slots
        assert res[0].path == "dense"
        assert eng.dispatch_stats["sparse_fallback"] == 1
        assert eng.infer_batch([]) == []
        lee = eng.lee_diagnostic(_graphs(), seed=0, n_rotations=2)
        assert np.isfinite(lee["lee_max"]) and lee["n_rotations"] == 2
        rep = eng.memory_report()
        assert rep["served_bytes"] < rep["fp32_bytes"]
        with pytest.raises(ValueError):
            eng.infer_batch([tb.Graph(np.zeros(17, np.int32),
                                      np.zeros((17, 3), np.float32))])

    def test_guardrail_raises_on_nonfinite(self, params):
        _, tp = params
        bad = tb.Graph(np.zeros(3, np.int32),
                       np.array([[0, 0, 0], [1, 0, 0], [np.nan, 0, 0]],
                                np.float32))
        kw = dict(params=tp, device="cpu",
                  serve=ServeConfig(mode="w8a8", bucket_sizes=(16,),
                                    max_batch=8))
        with pytest.raises(GuardrailViolation):
            QuantizedEngine.from_config(TCFG, **kw).infer_batch([bad])
        marked = QuantizedEngine.from_config(TCFG, **kw).infer_batch(
            [bad], on_flag="mark")
        assert marked[0].flags[0].reason == "nonfinite"
        # the sampled LEE probe skips a non-finite molecule (already fatal)
        probed = QuantizedEngine.from_config(
            TCFG, guardrails=GuardrailConfig(lee_probe_every=1), **kw)
        marked = probed.infer_batch([bad], on_flag="mark")
        assert [f.reason for f in marked[0].flags] == ["nonfinite"]
        assert probed.guard_stats["lee_probes"] == 1
        assert probed.guard_stats["flagged_nonfinite"] == 1


def _recording(engine):
    """Wrap ``engine._infer_raw`` to keep every batch of graphs it is
    given and its results."""
    calls, raw = [], engine._infer_raw

    def infer(graphs):
        out = raw(graphs)
        calls.append((graphs, out))
        return out
    engine._infer_raw = infer
    return calls


class TestLEE:
    @pytest.mark.parametrize("mode", ["fp32", "w4a8"])
    @pytest.mark.parametrize("path", ["dense", "sparse"])
    def test_lee_matches_jax_under_the_same_rotations(self, params, mode,
                                                      path):
        """The JAX engine's ``lee_diagnostic(key)`` and the port's
        ``lee_diagnostic(rotations=R)`` with R the JAX package's float32
        rotations for that key: the rotated inputs are bit-identical, the
        rotated forces agree under ``_assert_close``, and the LEE values
        agree to 1e-4 of themselves in w4a8 (measured: ~1e-7), and in
        fp32, where the LEE is float32 roundoff (~3e-8), to 1e-5 of the
        largest |force|."""
        jp, tp = params
        key = jax.random.PRNGKey(3)
        rots = np.asarray(j_random_rotations(key, 3))
        assert rots.dtype == np.float32
        jeng = JEngine.from_config(JCFG, params=jp,
                                   serve=JServe(**_serve_kw(mode, path)))
        teng = QuantizedEngine.from_config(
            TCFG, params=tp, serve=ServeConfig(**_serve_kw(mode, path)),
            device="cpu")
        jcalls, tcalls = _recording(jeng), _recording(teng)
        jl = jeng.lee_diagnostic(_graphs(), key, n_rotations=3)
        tl = teng.lee_diagnostic(_graphs(), rotations=rots)
        assert len(jcalls) == len(tcalls) == 4
        for (jg, jr), (tg, tr) in zip(jcalls, tcalls):
            for a, b in zip(tg, jg):
                assert a.coords.dtype == b.coords.dtype == np.float32
                np.testing.assert_array_equal(a.coords, b.coords)
            _assert_close(np.concatenate([r.forces for r in tr]),
                          np.concatenate([r.forces for r in jr]), mode,
                          "rotated forces")
        f_scale = max(float(np.abs(r.forces).max()) for r in tcalls[0][1])
        for k in ("lee_mean", "lee_max"):
            if mode == "fp32":
                assert abs(tl[k] - jl[k]) <= 1e-5 * f_scale, k
            else:
                assert abs(tl[k] - jl[k]) <= 1e-4 * jl[k], k
        assert (tl["n_rotations"], tl["n_graphs"]) == (3, len(_graphs()))

    def test_rotations_are_float32_haar(self):
        """``core.lee.random_rotations``: float32, orthonormal, det +1,
        reproducible from the seed; ``lee`` of an equivariant map is 0."""
        rots = tlee.random_rotations(0, 16)
        assert rots.dtype == np.float32 and rots.shape == (16, 3, 3)
        eye = np.einsum("nij,nkj->nik", rots, rots)
        np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape),
                                   atol=1e-6)
        np.testing.assert_allclose(np.linalg.det(rots), 1.0, atol=1e-6)
        np.testing.assert_array_equal(rots, tlee.random_rotations(0, 16))
        coords = torch.randn(5, 3)
        R = torch.from_numpy(rots[0])
        assert float(tlee.lee(lambda c: -2.0 * c, coords, R)) < 1e-5
        assert float(tlee.lee(lambda c: c * torch.tensor([1.0, 0, 0]),
                              coords, R)) > 1e-2
