"""Parity of the port's core maths with the JAX package on the CPU.

The same numpy inputs (from a seed) go through each ``repro`` function
and its ``repro_torch`` counterpart: quantizers, packing and the
codebook must agree exactly; MDDQ to 1e-6 (a code may differ only at a
near-tie, where the two packages' last-ulp differences can pick the
other codeword) with Geometric-STE gradients to 1e-4 rel / 1e-5 abs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codebook as jcb
from repro.core import mddq as jmddq
from repro.core import quantizers as jq
from repro.core.attention_norm import l2_normalize as j_l2
from repro.core.ste import geometric_ste_direction as j_geo
from repro.models import so3krates as jso3
from repro_torch.core import codebook as tcb
from repro_torch.core import mddq as tmddq
from repro_torch.core import quantizers as tq
from repro_torch.core.attention_norm import l2_normalize as t_l2
from repro_torch.core.ste import geometric_ste_direction as t_geo
from repro_torch.models import so3krates as tso3
from repro_torch.weights import params_from_numpy


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _vectors(seed, shape, spread=2.0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=shape + (3,)) * np.exp(spread * rng.normal(
        size=shape + (1,)))
    return v.astype(np.float32)


def _near_tie(u, codebook, i_a, i_b, tol=1e-6):
    """True where two chosen codewords score within ``tol`` of each other."""
    s_a = np.sum(u * codebook[i_a], -1)
    s_b = np.sum(u * codebook[i_b], -1)
    return np.abs(s_a - s_b) < tol


class TestQuantizers:
    @pytest.mark.parametrize("bits,axis", [(8, None), (8, 1), (4, 1),
                                           (8, 0)])
    def test_scale_and_codes_exact(self, bits, axis):
        x = np.random.default_rng(bits).normal(size=(33, 20)) \
            .astype(np.float32) * 3
        js = jq.abs_max_scale(jnp.asarray(x), bits, channel_axis=axis)
        ts = tq.abs_max_scale(_t(x), bits, channel_axis=axis)
        np.testing.assert_array_equal(_np(ts), np.asarray(js))
        np.testing.assert_array_equal(
            _np(tq.quantize(_t(x), ts, bits)),
            np.asarray(jq.quantize(jnp.asarray(x), js, bits)))

    def test_pack_unpack_int4_exact(self):
        q = np.random.default_rng(0).integers(-8, 8, (7, 12)).astype(np.int8)
        jp = jq.pack_int4(jnp.asarray(q))
        tp = tq.pack_int4(_t(q))
        assert tp.dtype == torch.uint8
        np.testing.assert_array_equal(_np(tp), np.asarray(jp))
        np.testing.assert_array_equal(_np(tq.unpack_int4(tp)), q)
        with pytest.raises(ValueError):
            tq.pack_int4(_t(q[:, :3]))

    def test_log_magnitude_codec(self):
        m = np.exp(np.random.default_rng(1).uniform(-16, 8, 2000)) \
            .astype(np.float32)
        for bits, lo, hi in ((8, 1e-6, 1e3), (4, 1e-3, 10.0)):
            jc = jq.quantize_log_magnitude(jnp.asarray(m), bits, lo, hi)
            tc = tq.quantize_log_magnitude(_t(m), bits, lo, hi)
            np.testing.assert_array_equal(_np(tc), np.asarray(jc))
            np.testing.assert_allclose(
                _np(tq.dequantize_log_magnitude(tc, bits, lo, hi)),
                np.asarray(jq.dequantize_log_magnitude(jc, bits, lo, hi)),
                rtol=1e-6)


class TestCodebook:
    @pytest.mark.parametrize("bits", [4, 6, 16])
    def test_bit_identical(self, bits):
        np.testing.assert_array_equal(_np(tcb.make_codebook(bits)),
                                      np.asarray(jcb.make_codebook(bits)))
        assert tcb.make_codebook(bits) is tcb.make_codebook(bits)

    @pytest.mark.parametrize("bits", [6, 13])   # 13: chunked (> 4096)
    def test_nearest_code(self, bits):
        cb = np.asarray(jcb.make_codebook(bits))
        v = _vectors(bits, (3000,), spread=0.0)
        u = v / np.linalg.norm(v, axis=-1, keepdims=True)
        ji = np.asarray(jcb.nearest_code(jnp.asarray(u), jnp.asarray(cb)))
        ti = _np(tcb.nearest_code(_t(u), _t(cb)))
        diff = ji != ti
        assert diff.mean() < 1e-3
        assert _near_tie(u[diff], cb, ji[diff], ti[diff]).all()

    def test_first_index_wins_on_ties(self):
        cb = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0]])
        u = torch.tensor([[1.0, 0, 0], [0, 0, 1.0]])
        np.testing.assert_array_equal(_np(tcb.nearest_code(u, cb)), [0, 0])


def test_geometric_ste_gradient():
    rng = np.random.default_rng(3)
    u = rng.normal(size=(50, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    q = rng.normal(size=(50, 3)).astype(np.float32)
    g = rng.normal(size=(50, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: j_geo(a, jnp.asarray(q)), jnp.asarray(u))
    ut = _t(u).requires_grad_()
    out = t_geo(ut, _t(q))
    np.testing.assert_array_equal(_np(out), q)
    (gt,) = torch.autograd.grad(out, ut, _t(g))
    np.testing.assert_allclose(_np(gt), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-7)


def test_l2_normalize():
    x = np.random.default_rng(4).normal(size=(9, 16)).astype(np.float32)
    x[0] = 0.0
    np.testing.assert_allclose(_np(t_l2(_t(x))),
                               np.asarray(j_l2(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


class TestMDDQ:
    CFG = dict(direction_bits=6, magnitude_bits=8)

    def _pair(self, **kw):
        return jmddq.MDDQConfig(**kw), tmddq.MDDQConfig(**kw)

    @pytest.mark.parametrize("geometric", [True, False])
    def test_fake_quant_and_gradients(self, geometric):
        jc, tc = self._pair(geometric_ste=geometric, **self.CFG)
        v = _vectors(5, (64, 4))
        v[0, 0] = 0.0                              # zero vector
        g = np.random.default_rng(6).normal(size=v.shape).astype(np.float32)
        # the forward eager, as held to 1e-6; the gradient under jit
        jout = jmddq.mddq_fake_quant(jnp.asarray(v), jc)
        jgrad = jax.jit(lambda a, ga: jax.vjp(
            lambda b: jmddq.mddq_fake_quant(b, jc), a)[1](ga)[0])(
            jnp.asarray(v), jnp.asarray(g))
        vt = _t(v).requires_grad_()
        tout = tmddq.mddq_fake_quant(vt, tc)
        (gt,) = torch.autograd.grad(tout, vt, _t(g))
        np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=1e-6)
        np.testing.assert_array_equal(_np(tout)[0, 0], 0.0)
        np.testing.assert_allclose(_np(gt), np.asarray(jgrad), rtol=1e-4,
                                   atol=1e-5)
        assert np.isfinite(_np(gt)).all() and (_np(gt)[0, 0] == 0).all()

    def test_linear_magnitude_domain(self):
        jc, tc = self._pair(magnitude_domain="linear", **self.CFG)
        v = _vectors(7, (40,), spread=0.5)
        np.testing.assert_allclose(
            _np(tmddq.mddq_fake_quant(_t(v), tc)),
            np.asarray(jmddq.mddq_fake_quant(jnp.asarray(v), jc)),
            rtol=1e-5, atol=1e-6)

    def test_encode_decode(self):
        jc, tc = self._pair(**self.CFG)
        v = _vectors(8, (500,))
        ji, jm = jax.jit(lambda a: jmddq.mddq_encode(a, jc))(jnp.asarray(v))
        ti, tm = tmddq.mddq_encode(_t(v), tc)
        np.testing.assert_array_equal(_np(ti), np.asarray(ji))
        np.testing.assert_array_equal(_np(tm), np.asarray(jm))
        np.testing.assert_allclose(
            _np(tmddq.mddq_decode(ti, tm, tc)),
            np.asarray(jmddq.mddq_decode(ji, jm, jc)), rtol=1e-6)


class TestModelHelpers:
    CFG = dict(feat=16, vec_feat=4, n_layers=2, n_rbf=4, dir_bits=6,
               cutoff=3.0)

    def test_layernorm_uses_population_variance(self):
        # torch.var defaults to the unbiased estimator; jnp.var does not
        assert float(torch.var(torch.tensor([1.0, 2.0, 3.0]))) == 1.0
        x = np.random.default_rng(9).normal(size=(6, 16)).astype(np.float32)
        g = np.linspace(0.5, 1.5, 16).astype(np.float32)
        b = np.linspace(-1, 1, 16).astype(np.float32)
        np.testing.assert_allclose(
            _np(tso3._layernorm(_t(x), _t(g), _t(b))),
            np.asarray(jso3._layernorm(jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(b))),
            rtol=1e-5, atol=1e-6)

    def test_geometry_and_logits(self):
        jc = jso3.So3kratesConfig(**self.CFG)
        tc = tso3.So3kratesConfig(**self.CFG)
        rng = np.random.default_rng(10)
        coords = (rng.normal(size=(2, 7, 3)) * 1.5).astype(np.float32)
        mask = np.ones((2, 7), bool)
        mask[1, 5:] = False
        for a, b in zip(tso3.pair_geometry(_t(coords), tc, _t(mask)),
                        jso3.pair_geometry(jnp.asarray(coords), jc,
                                           jnp.asarray(mask))):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        v = rng.normal(size=(2, 7, 4, 3)).astype(np.float32)
        np.testing.assert_allclose(_np(tso3._vnorm(_t(v))),
                                   np.asarray(jso3._vnorm(jnp.asarray(v))),
                                   rtol=1e-6)
        q, k = (rng.normal(size=(2, 7, 16)).astype(np.float32)
                for _ in range(2))
        bias = rng.normal(size=(2, 7, 7)).astype(np.float32)
        for robust in (True, False):
            np.testing.assert_allclose(
                _np(tso3.cosine_logits(_t(q), _t(k), _t(bias), tc, robust)),
                np.asarray(jso3.cosine_logits(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(bias), jc, robust)),
                rtol=1e-5, atol=1e-5)

    def test_init_params_layout_and_numpy_handover(self):
        jc = jso3.So3kratesConfig(**self.CFG)
        tc = tso3.So3kratesConfig(**self.CFG)
        jp = jax.jit(jso3.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), jc)
        tp = tso3.init_params(tc, seed=0, device="cpu")
        assert set(tp) == set(jp)
        for name in jp:
            assert tuple(tp[name].shape) == jp[name].shape, name
            assert tp[name].dtype == torch.float32
        # same scale: per-matrix rms within sampling noise of JAX's
        for name in ("layer0/wq", "ro_w1", "embed"):
            a, b = float(tp[name].std()), float(jnp.std(jp[name]))
            assert abs(a - b) < 0.25 * b, name
        np.testing.assert_array_equal(_np(tso3.init_params(tc, 0, "cpu")
                                          ["layer1/wk"]),
                                      _np(tp["layer1/wk"]))
        moved = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                  "cpu")
        for name in jp:
            np.testing.assert_array_equal(_np(moved[name]),
                                          np.asarray(jp[name]))
