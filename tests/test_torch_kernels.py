"""The port's kernel entry points against the JAX package's, on the CPU.

On CPU tensors each wrapper runs its kernel's plain PyTorch version; the
JAX side runs its Pallas kernels in interpret mode (as
``tests/test_kernels.py`` does) or its pure-jnp oracles. Tolerances:
the quantized matmuls agree bit for bit with the JAX oracle (exact
integer accumulation, the same epilogue order) and to 1e-6 with the
Pallas kernel in interpret mode; the MDDQ codes agree except at a
near-tie (the port normalizes by division, the TPU kernel by a
reciprocal multiply);
the edge softmax to 1e-5, its gradients to 1e-4 rel / 1e-5 abs.

``tests/test_torch_cuda.py`` holds the CUDA kernels themselves against
their plain versions on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_codebook as j_make_codebook
from repro.core.mddq import MDDQConfig as JMDDQConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.codebook import make_codebook
from repro_torch.core.mddq import MDDQConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.edge_softmax import edge_softmax_fused
from repro_torch.kernels.mddq_kernel import mddq_encode_kernel
from repro_torch.kernels.quant_matmul import w4a8_matmul, w8a8_matmul
from repro_torch.serving.bucketing import build_edge_list


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


# An interpret-mode Pallas kernel called eagerly runs its grid op by op;
# under jit it compiles once and runs about ten times faster here. Float
# outputs held to 1e-6 stay eager: jit fuses the decode's exp with its
# product, which rounds a value or two in 1e6 differently.
_j_encode = jax.jit(jops.mddq_encode)
_j_edge_softmax = jax.jit(jops.edge_softmax, static_argnames=("cap",
                                                              "use_kernel"))


# --- quantized matmul --------------------------------------------------------

class TestQuantMatmul:
    @pytest.mark.parametrize("m,k,n,w4", [(37, 80, 64, False),
                                          (256, 64, 192, False),
                                          (20, 16, 64, False),
                                          (37, 64, 32, True)])
    def test_matches_oracle_bit_for_bit(self, m, k, n, w4):
        """Bit for bit with the JAX oracle; within 1e-6 of the Pallas
        kernel, whose interpret-mode epilogue rounds an ulp differently
        from its own oracle in a few entries."""
        rng = np.random.default_rng(m + k + n)
        x = rng.normal(size=(m, k)).astype(np.float32) * 2
        w = rng.normal(size=(k, n)).astype(np.float32)
        prep_j, prep_t = ((jops.prepare_w4, ops.prepare_w4) if w4 else
                          (jops.prepare_w8, ops.prepare_w8))
        jw, js = prep_j(jnp.asarray(w))
        tw, ts = prep_t(_t(w))
        np.testing.assert_array_equal(_np(tw), np.asarray(jw))
        np.testing.assert_array_equal(_np(ts), np.asarray(js))
        ja, jas = jops.quantize_activations(jnp.asarray(x))
        ta, tas = ops.quantize_activations(_t(x))
        np.testing.assert_array_equal(_np(ta), np.asarray(ja))
        np.testing.assert_array_equal(_np(tas), np.asarray(jas))
        jmm, tmm = ((jops.matmul_w4a8, ops.matmul_w4a8) if w4 else
                    (jops.matmul_w8a8, ops.matmul_w8a8))
        pallas = np.asarray(jmm(jnp.asarray(x), jw, js))  # interpret mode
        out = _np(tmm(_t(x), tw, ts))
        np.testing.assert_allclose(out, pallas, rtol=1e-6, atol=1e-6)
        oracle = jref.w4a8_matmul_ref if w4 else jref.w8a8_matmul_ref
        plain = ref.w4a8_matmul_ref if w4 else ref.w8a8_matmul_ref
        want = np.asarray(oracle(ja, jas, jw, js))
        np.testing.assert_array_equal(_np(plain(ta, tas, tw, ts)), want)
        np.testing.assert_array_equal(out, want)

    def test_cpu_calls_do_not_count_as_launches(self):
        before = (w8a8_matmul.launches, w4a8_matmul.launches,
                  edge_softmax_fused.launches, mddq_encode_kernel.launches)
        x = torch.randn(8, 16)
        ops.matmul_w8a8(x, *ops.prepare_w8(torch.randn(16, 4)))
        ops.matmul_w4a8(x, *ops.prepare_w4(torch.randn(16, 4)))
        mddq_encode_kernel(torch.randn(5, 3), make_codebook(4))
        after = (w8a8_matmul.launches, w4a8_matmul.launches,
                 edge_softmax_fused.launches, mddq_encode_kernel.launches)
        assert after == before


# --- MDDQ encode -------------------------------------------------------------

def _near_tie(u, codebook, i_a, i_b, tol=1e-6):
    return np.abs(np.sum(u * codebook[i_a], -1)
                  - np.sum(u * codebook[i_b], -1)) < tol


class TestMDDQEncode:
    def test_codebook_is_stored_in_the_kernel_layout(self):
        """The codebook equals the JAX package's bit for bit, and its
        transpose, the planar (3, C) layout the encode kernel reads, is
        the stored tensor itself: no copy per call."""
        for bits in (4, 6, 8):
            cb = make_codebook(bits)
            np.testing.assert_array_equal(_np(cb),
                                          np.asarray(j_make_codebook(bits)))
            assert cb.T.is_contiguous()
            assert cb.T.contiguous().data_ptr() == cb.data_ptr()

    @pytest.mark.parametrize("bits", [6, 8])
    def test_codes_match_pallas(self, bits):
        rng = np.random.default_rng(bits)
        v = (rng.normal(size=(7, 150, 3))
             * np.exp(2 * rng.normal(size=(7, 150, 1)))).astype(np.float32)
        v[0, :3] = 0.0
        ji, jm = _j_encode(jnp.asarray(v),
                           jops.pad_codebook(j_make_codebook(bits)))
        ti, tm = ops.mddq_encode(_t(v), make_codebook(bits))
        assert ti.shape == (7, 150) and tm.shape == (7, 150)
        ji, ti = np.asarray(ji).ravel(), _np(ti).ravel()
        np.testing.assert_array_equal(_np(tm), np.asarray(jm))
        diff = ji != ti
        u = v.reshape(-1, 3)
        u = u / np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
        cb = np.asarray(j_make_codebook(bits))
        assert diff.mean() < 1e-3
        assert _near_tie(u[diff], cb, ji[diff], ti[diff]).all()

    def test_unpadded_codebook_gives_jax_padded_codes(self):
        """The JAX wrapper pads a 64-word codebook to 128 with copies of
        codeword 0; the port searches the 64 words alone. Vectors on
        codeword 0, which every padding copy ties, get index 0 in both,
        and the magnitude codes agree."""
        cb = make_codebook(6)
        v = torch.randn(300, 3, generator=torch.Generator().manual_seed(0))
        v[:64] = cb[:1] * 3.0                       # exact ties with cw 0
        idx, mag = ops.mddq_encode(v, cb)
        ji, jm = _j_encode(jnp.asarray(_np(v)),
                           jops.pad_codebook(j_make_codebook(6)))
        assert int(idx.max()) < 64
        assert (idx[:64] == 0).all()
        np.testing.assert_array_equal(_np(idx[:64]), np.asarray(ji)[:64])
        np.testing.assert_array_equal(_np(mag), np.asarray(jm))

    def test_qdq_matches_jax_with_gradients(self):
        jc = JMDDQConfig(direction_bits=6, magnitude_bits=8)
        tc = MDDQConfig(direction_bits=6, magnitude_bits=8)
        rng = np.random.default_rng(11)
        v = (rng.normal(size=(64, 8, 3)) * 2).astype(np.float32)
        v[0, 0] = 0.0
        g = rng.normal(size=v.shape).astype(np.float32)
        cb_j = j_make_codebook(6)
        jout = jops.mddq_qdq_kernel(jnp.asarray(v), jc, cb_j)
        jgrad = jax.jit(lambda a, ga: jax.vjp(
            lambda b: jops.mddq_qdq_kernel(b, jc, cb_j), a)[1](ga)[0])(
            jnp.asarray(v), jnp.asarray(g))
        vt = _t(v).requires_grad_()
        tout = ops.mddq_qdq_kernel(vt, tc, make_codebook(6))
        (gt,) = torch.autograd.grad(tout, vt, _t(g))
        np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=1e-6)
        assert (_np(tout)[0, 0] == 0).all() and (_np(gt)[0, 0] == 0).all()
        np.testing.assert_allclose(_np(gt), np.asarray(jgrad), rtol=1e-4,
                                   atol=1e-5)

    def test_qdq_respects_magnitude_config(self):
        cfg = MDDQConfig(direction_bits=6, magnitude_bits=4, m_min=1e-3,
                         m_max=10.0)
        jcfg = JMDDQConfig(direction_bits=6, magnitude_bits=4, m_min=1e-3,
                           m_max=10.0)
        v = np.random.default_rng(12).normal(size=(32, 4, 3)) \
            .astype(np.float32)
        out = _np(ops.mddq_qdq_kernel(_t(v), cfg, make_codebook(6)))
        np.testing.assert_allclose(
            out, np.asarray(jops.mddq_qdq_kernel(jnp.asarray(v), jcfg,
                                                 j_make_codebook(6))),
            atol=1e-6)
        with pytest.raises(NotImplementedError):
            ops.mddq_qdq_kernel(_t(v), MDDQConfig(direction_bits=6,
                                                  magnitude_domain="linear"),
                                make_codebook(6))


# --- edge softmax ------------------------------------------------------------

def _edge_problem(seed, B, cap, ec, F, W, cutoff=3.0, isolated=False):
    """Padded batch + edge list + features (the JAX tests' recipe)."""
    rng = np.random.default_rng(seed)
    side = (cap / 0.05) ** (1.0 / 3.0)
    coords = rng.uniform(0, side, size=(B, cap, 3)).astype(np.float32)
    mask = np.ones((B, cap), bool)
    mask[0, cap // 2:] = False
    if isolated:                  # molecule 1: atoms far apart, no edges
        coords[1] = np.arange(cap)[:, None] * 10.0 * cutoff
    el = build_edge_list(coords, mask, cutoff, ec)
    assert el is not None
    N, E = B * cap, B * ec
    arrays = [rng.normal(size=(N, F)), rng.normal(size=(N, F)),
              rng.normal(size=(E,)), rng.normal(size=(E, W))]
    q, k, bias, vals = (a.astype(np.float32) for a in arrays)
    return q, k, bias, vals, el


class TestEdgeSoftmax:
    @pytest.mark.parametrize("B,cap,ec,F,W", [(2, 16, 256, 32, 56),
                                              (4, 32, 128, 64, 112)])
    def test_matches_jax(self, B, cap, ec, F, W):
        q, k, bias, vals, el = _edge_problem(B, B, cap, ec, F, W)
        jargs = [jnp.asarray(a) for a in (q, k, bias, vals, el.senders,
                                          el.receivers, el.edge_mask)]
        pallas = np.asarray(_j_edge_softmax(*jargs, cap=cap,
                                            use_kernel=True))
        oracle = np.asarray(jref.edge_softmax_ref(
            jargs[0], jargs[1], jargs[2], jargs[4], jargs[5], jargs[6],
            jargs[3], B * cap))
        out = _np(ops.edge_softmax(
            _t(q), _t(k), _t(bias), _t(vals), _t(el.senders),
            _t(el.receivers), _t(el.edge_mask), cap=cap))
        np.testing.assert_allclose(out, oracle, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-5)

    def test_gradients_match_jax(self):
        q, k, bias, vals, el = _edge_problem(7, 2, 16, 256, 32, 40,
                                             isolated=True)
        s, r, m = el.senders, el.receivers, el.edge_mask

        def jloss(q_, k_, b_, v_):
            return jnp.sum(jops.edge_softmax(q_, k_, b_, v_, s, r, m, cap=16,
                                             use_kernel=True) ** 2)
        jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
            *(jnp.asarray(a) for a in (q, k, bias, vals)))
        ins = [_t(a).requires_grad_() for a in (q, k, bias, vals)]
        loss = (ops.edge_softmax(*ins, _t(s), _t(r), _t(m), cap=16) ** 2).sum()
        tg = torch.autograd.grad(loss, ins)
        for a, b in zip(tg, jg):
            assert np.isfinite(_np(a)).all()
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)

    def test_receivers_without_edges_are_exact_zero(self):
        q, k, bias, vals, el = _edge_problem(3, 2, 16, 128, 32, 24,
                                             isolated=True)
        out = _np(ops.edge_softmax(
            _t(q), _t(k), _t(bias), _t(vals), _t(el.senders),
            _t(el.receivers), _t(el.edge_mask), cap=16))
        has_edge = np.zeros(32, bool)
        has_edge[el.receivers[el.edge_mask]] = True
        assert (~has_edge[16:]).all()              # the isolated molecule
        np.testing.assert_array_equal(out[~has_edge], 0.0)

    def test_segment_layout_the_kernel_relies_on(self):
        """The kernel finds node i's edges by binary search over its
        molecule's slots keyed (mask ? receiver : INT_MAX). The padding
        self-loops sit on the molecule's first atom, out of receiver
        order, so only that key (not the raw receivers) is sorted, and
        its [i, i+1) range is exactly node i's real edges."""
        _, _, _, _, el = _edge_problem(5, 3, 16, 256, 8, 8)
        ec, cap = el.edge_capacity, 16
        key = np.where(el.edge_mask, el.receivers, np.iinfo(np.int32).max)
        raw_sorted = True
        for b in range(3):
            kb = key[b * ec:(b + 1) * ec]
            assert (np.diff(kb.astype(np.int64)) >= 0).all()
            raw_sorted &= bool((np.diff(el.receivers[b * ec:(b + 1) * ec])
                                >= 0).all())
            for i in range(b * cap, (b + 1) * cap):
                lo, hi = np.searchsorted(kb, [i, i + 1])
                real = np.nonzero(el.edge_mask & (el.receivers == i))[0]
                np.testing.assert_array_equal(np.arange(lo, hi) + b * ec,
                                              real)
        assert not raw_sorted
