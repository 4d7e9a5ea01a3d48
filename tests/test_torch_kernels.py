"""The port's kernel entry points against the JAX package's, on the CPU.

On CPU tensors each wrapper runs its kernel's plain PyTorch version; the
JAX side runs its Pallas kernels in interpret mode (as
``tests/test_kernels.py`` does) or its pure-jnp oracles. Tolerances:
the quantized matmuls agree bit for bit with the JAX oracle (exact
integer accumulation, the same epilogue order) and to 1e-6 with the
Pallas kernel in interpret mode; the MDDQ codes agree except at a
near-tie (the port normalizes by division, the TPU kernel by a
reciprocal multiply);
the edge softmax to 1e-5, its gradients to 1e-4 rel / 1e-5 abs; the
activation quantizer's codes exactly and its scales exactly against the
JAX formula (to one float32 ulp against the interpret-mode Pallas kernel,
which XLA rewrites to multiply by 1/127); the int8 KV write's whole cache
byte for byte against the JAX decode's write; the int8-KV decode attention to
2e-4 against the Pallas kernel and its oracle (the JAX gate) and to 1e-6
against the JAX decode's masked formula.

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
from repro.kernels.act_quant import act_quant as j_act_quant
from repro.kernels.attention_int8kv import \
    decode_attention_int8kv as j_decode_attention_int8kv
from repro_torch.core.codebook import make_codebook
from repro_torch.core.mddq import MDDQConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.act_quant import act_quant, kv_append_int8
from repro_torch.kernels.attention_int8kv import (decode_attention_int8kv,
                                                 n_splits)
from repro_torch.kernels.edge_softmax import (chunked_softmax_model,
                                              edge_softmax_fused,
                                              segment_bounds_model)
from repro_torch.kernels.mddq_kernel import mddq_encode_kernel
from repro_torch.kernels.quant_matmul import (w4a8_matmul, w4a8_matmul_f32a,
                                              w8a8_matmul, w8a8_matmul_f32a)
from repro_torch.serving.bucketing import build_edge_list, device_edge_list


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

    @pytest.mark.parametrize("m,k,n,w4", [(1, 3, 2, False), (1, 3, 2, True),
                                          (255, 17, 66, False),
                                          (255, 17, 66, True),
                                          (256, 80, 1, False)])
    def test_f32a_entries_match_oracle_bit_for_bit(self, m, k, n, w4):
        """The f32-A entries (the A8 step inside the matmul launch) equal
        the JAX package's quantize-then-multiply oracle bit for bit, an
        all-zero row (the 1e-8 floor) included."""
        rng = np.random.default_rng(m * k + n)
        x = rng.normal(size=(m, k)).astype(np.float32) * 3
        x[0] = 0.0
        w = rng.normal(size=(k, n)).astype(np.float32)
        prep_j, prep_t = ((jops.prepare_w4, ops.prepare_w4) if w4 else
                          (jops.prepare_w8, ops.prepare_w8))
        jw, js = prep_j(jnp.asarray(w))
        tw, ts = prep_t(_t(w))
        oracle = jref.w4a8_matmul_ref if w4 else jref.w8a8_matmul_ref
        want = np.asarray(oracle(*jops.quantize_activations(jnp.asarray(x)),
                                 jw, js))
        entry = w4a8_matmul_f32a if w4 else w8a8_matmul_f32a
        np.testing.assert_array_equal(_np(entry(_t(x), tw, ts)), want)

    def test_cpu_calls_do_not_count_as_launches(self):
        counters = (w8a8_matmul, w4a8_matmul, w8a8_matmul_f32a,
                    w4a8_matmul_f32a, edge_softmax_fused, mddq_encode_kernel,
                    act_quant)
        before = [c.launches for c in counters]
        x = torch.randn(8, 16)
        ops.matmul_w8a8(x, *ops.prepare_w8(torch.randn(16, 4)))
        ops.matmul_w4a8(x, *ops.prepare_w4(torch.randn(16, 4)))
        w8a8_matmul(*ops.quantize_activations(x),
                    *ops.prepare_w8(torch.randn(16, 4)))
        w4a8_matmul(*ops.quantize_activations(x),
                    *ops.prepare_w4(torch.randn(16, 4)))
        mddq_encode_kernel(torch.randn(5, 3), make_codebook(4))
        assert [c.launches for c in counters] == before


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


def _refined_skin_problem(layout, seed=0, F=16, W=28):
    """A skin list (``device_edge_list`` at an enlarged radius) refined to
    a smaller cutoff, which masks edges in the middle of receivers' runs,
    with every listed edge of three receivers masked as well. "md": the
    MD smoke's layout, 2 x 24 atoms at 0.1 per cubic Angstrom, listed at
    10.45 A and refined to 5 A; "every_pair": four 64-atom molecules
    inside one 10 A list (two 32-edge chunks per receiver), refined to
    3 A."""
    rng = np.random.default_rng(seed)
    if layout == "md":
        B, cap, ec, skin_cut, cut = 2, 24, 640, 10.45, 5.0
        coords = rng.uniform(0, (cap / 0.1) ** (1 / 3), size=(B, cap, 3))
    else:
        B, cap, ec, skin_cut, cut = 4, 64, 4096, 10.0, 3.0
        coords = rng.uniform(0, 5.0, size=(B, cap, 3))
    coords = torch.from_numpy(coords.astype(np.float32))
    s, r, layout_mask, _ = device_edge_list(
        coords, torch.ones((B, cap), dtype=torch.bool), skin_cut, ec)
    m = ops.refine_edge_mask(coords.reshape(-1, 3), s, r, layout_mask, cut)
    emptied = torch.tensor([1, cap + 5, B * cap - 1])
    m &= ~torch.isin(r, emptied.to(torch.int32))
    N, E = B * cap, B * ec
    q, k = (torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32))
            for _ in range(2))
    bias = torch.from_numpy(rng.normal(size=E).astype(np.float32))
    vals = torch.from_numpy(rng.normal(size=(E, W)).astype(np.float32))
    return q, k, bias, vals, s, r, m, layout_mask, cap, emptied


class TestEdgeSoftmaxRefinedMask:
    """K3 on an MD skin list refined to the true cutoff: holes inside
    receivers' runs, and receivers whose every listed edge is masked."""

    @pytest.mark.parametrize("layout", ["md", "every_pair"])
    def test_kernel_models_match_the_plain_version(self, layout):
        q, k, bias, vals, s, r, m, lay, cap, emptied = \
            _refined_skin_problem(layout)
        assert (m != lay).any() and (m & ~lay).sum() == 0
        want = ref.edge_softmax_ref(q, k, bias, s, r, m, vals, q.shape[0])
        got = chunked_softmax_model(q, k, bias, vals, s, r, m, cap,
                                    layout_mask=lay)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(_np(got)[_np(emptied)], 0.0)
        np.testing.assert_array_equal(_np(want)[_np(emptied)], 0.0)

    @pytest.mark.parametrize("layout", ["md", "every_pair"])
    def test_segments_come_from_the_layout(self, layout):
        """Searched on the layout mask, node i's segment is exactly its
        listed edges, the refined-away ones included."""
        q, _, _, _, _, r, _, lay, cap, _ = _refined_skin_problem(layout)
        recv, lay = _np(r), _np(lay)
        ec = lay.shape[0] // (q.shape[0] // cap)
        for node in range(0, recv.max() + 1, 7):
            start, end, _ = segment_bounds_model(recv, lay, node, cap, ec)
            listed = np.nonzero(lay & (recv == node))[0]
            np.testing.assert_array_equal(np.arange(start, end), listed)

    def test_wrapper_matches_jax_on_the_refined_mask(self):
        """``ops.edge_softmax(layout_mask=...)`` (the plain version on CPU
        tensors) against the JAX package's Pallas kernel in interpret
        mode, which folds the mask into the bias and takes any mask."""
        q, k, bias, vals, s, r, m, lay, cap, emptied = \
            _refined_skin_problem("md", seed=1)
        out = _np(ops.edge_softmax(q, k, bias, vals, s, r, m, cap=cap,
                                   layout_mask=lay))
        pallas = np.asarray(_j_edge_softmax(
            *(jnp.asarray(_np(a)) for a in (q, k, bias, vals, s, r, m)),
            cap=cap, use_kernel=True))
        np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(out[_np(emptied)], 0.0)


# --- activation quantization (K5) ---------------------------------------------

def _rows(seed, m, k, spread=1.0):
    """Rows of very different magnitudes, the first one all zero."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)) * np.exp(spread * rng.normal(size=(m, 1)))
    x[0] = 0.0
    return x.astype(np.float32)


def _jax_kv_write(k):
    """``repro/models/lm/attention.py``'s int8 KV write, evaluated op by op
    (eagerly) in k's dtype, as written."""
    k_s = (jnp.maximum(jnp.max(jnp.abs(k), -1), 1e-8) / 127.0
           ).astype(jnp.float32)
    k_q = jnp.clip(jnp.round(k / k_s[..., None]), -127, 127).astype(jnp.int8)
    return np.asarray(k_q), np.asarray(k_s)


class TestActQuant:
    @pytest.mark.parametrize("m,k", [(256, 64), (256, 80), (256, 16),
                                     (64, 896)])
    def test_matches_jax(self, m, k):
        """Codes and scales bit for bit with the JAX formula
        (``ops.quantize_activations``); against the Pallas kernel in
        interpret mode the codes are equal and the scales within one
        float32 ulp, because XLA rewrites its ``/ 127`` into a multiply
        by ``1/127`` (about 4% of the scales move by an ulp)."""
        x = _rows(m + k, m, k)
        tq, ts = act_quant(_t(x))
        jq, js = jops.quantize_activations(jnp.asarray(x))
        np.testing.assert_array_equal(_np(tq), np.asarray(jq))
        np.testing.assert_array_equal(_np(ts), np.asarray(js))
        pq, ps = j_act_quant(jnp.asarray(x), interpret=True)
        np.testing.assert_array_equal(_np(tq), np.asarray(pq))
        np.testing.assert_allclose(_np(ts), np.asarray(ps), rtol=1.2e-7,
                                   atol=0)
        assert _np(ts)[0, 0] == np.float32(1e-8) / np.float32(127)
        aq, as_ = ops.quantize_activations(_t(x))
        assert torch.equal(aq, tq) and torch.equal(as_, ts)
        assert act_quant.launches == 0

    def test_bf16_scale_is_rounded_to_bf16(self):
        """The LM decode's KV write takes the scale in bf16 (floor, max and
        division rounded to bf16), then divides in float32: the port's
        bf16 path equals that formula exactly, and a float32 scale would
        not (most scales and some codes would move)."""
        x = jnp.asarray(_rows(3, 4096, 64), jnp.bfloat16)
        want_q, want_s = _jax_kv_write(x)
        xt = _t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
        tq, ts = act_quant(xt)
        np.testing.assert_array_equal(_np(tq), want_q)
        np.testing.assert_array_equal(_np(ts)[:, 0], want_s)
        assert want_s[0] == np.float32(jnp.bfloat16(1e-8) / 127)
        fq, fs = act_quant(xt.to(torch.float32))
        assert (_np(fs)[:, 0] != want_s).sum() > 1000
        assert (_np(fq) != want_q).sum() > 0

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_prepare_kv_int8_matches_jax(self, dtype):
        rng = np.random.default_rng(5)
        k, v = (jnp.asarray(rng.normal(size=(4, 40, 64)) * 2, dtype)
                for _ in range(2))
        got = ops.prepare_kv_int8(*(_t(np.asarray(a.astype(jnp.float32)))
                                    .to(torch.float32 if dtype == jnp.float32
                                        else torch.bfloat16) for a in (k, v)))
        if dtype == jnp.float32:
            want = [np.asarray(a) for a in jops.prepare_kv_int8(k, v)]
        else:
            (kq, ks), (vq, vs) = _jax_kv_write(k), _jax_kv_write(v)
            want = [kq, ks, vq, vs]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), w)


# --- the int8 KV write (K5's KV entry) -------------------------------------------

def _kv_cache(rng, L, B, H, S, hd):
    """A stacked (L, ...) int8 cache filled with random codes, -128 (never
    a code) at every other position, and scales with NaNs among them: a
    write outside its slot shows in the bytes."""
    q = rng.integers(-127, 128, size=(2, L, B, H, S, hd)).astype(np.int8)
    q[..., ::2, :] = -128
    s = rng.uniform(0.01, 1.0, size=(2, L, B, H, S)).astype(np.float32)
    s[..., 1::3] = np.nan
    return q, s


def _kv_new(rng, B, nkv, hd, dtype):
    """The new token's K and V as strided views of one (B, 2, nkv, hd)
    projection, rows of very different magnitudes, K's first row zero."""
    x = (rng.normal(size=(B, 2, nkv, hd))
         * np.exp(rng.normal(size=(B, 2, nkv, 1)))).astype(np.float32)
    x[0, 0, 0] = 0.0
    if dtype == "bf16":         # the values bf16 can hold, in both packages
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


class TestKVAppend:
    @pytest.mark.parametrize("replicate", [1, 3])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_ref_matches_the_jax_decode_write(self, dtype, replicate):
        """``kv_append_int8_ref`` on a layer view of a stacked cache equals
        the JAX decode's KV write (``_jax_kv_write`` on the repeated rows,
        then ``dynamic_update_index_in_dim`` on each cache tensor) byte for
        byte over the whole cache, the untouched positions included."""
        rng = np.random.default_rng(11 + replicate)
        L, B, nkv, S, hd, layer = 3, 2, 2, 5, 64, 1
        H = nkv * replicate
        cq, cs = _kv_cache(rng, L, B, H, S, hd)
        x = _kv_new(rng, B, nkv, hd, dtype)
        jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                    else (jnp.bfloat16, torch.bfloat16))
        for cur in (0, 3, S - 1):
            tq, ts = _t(cq), _t(cs)
            xt = _t(x).to(tdt)
            ref.kv_append_int8_ref(xt[:, 0], xt[:, 1], tq[0, layer],
                                   ts[0, layer], tq[1, layer], ts[1, layer],
                                   cur, replicate)
            jq, js = cq.copy(), cs.copy()
            for t in range(2):
                rows = jnp.repeat(jnp.asarray(x[:, t], jdt), replicate,
                                  axis=1)
                codes, scales = _jax_kv_write(rows)
                jq[t, layer] = np.asarray(jax.lax.dynamic_update_index_in_dim(
                    jnp.asarray(cq[t, layer]), codes, cur, 2))
                js[t, layer] = np.asarray(jax.lax.dynamic_update_index_in_dim(
                    jnp.asarray(cs[t, layer]), scales, cur, 2))
            np.testing.assert_array_equal(_np(tq), jq)
            np.testing.assert_array_equal(_bits(_np(ts)), _bits(js))
            assert (jq[:, layer, :, :, cur] != -128).all()

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_cpu_tensors_run_the_plain_version(self, dtype):
        """On CPU tensors the wrapper is the plain version, launch count
        unchanged, and ``ops.append_kv_int8`` is the wrapper."""
        rng = np.random.default_rng(3)
        cq, cs = _kv_cache(rng, 2, 3, 6, 4, 8)
        x = _t(_kv_new(rng, 3, 2, 8, "f32")).to(dtype)
        got = [_t(cq), _t(cs)]
        want = [_t(cq), _t(cs)]
        before = kv_append_int8.launches
        kv_append_int8(x[:, 0], x[:, 1], got[0][0, 1], got[1][0, 1],
                       got[0][1, 1], got[1][1, 1], 2, 3)
        ref.kv_append_int8_ref(x[:, 0], x[:, 1], want[0][0, 1],
                               want[1][0, 1], want[0][1, 1], want[1][1, 1],
                               2, 3)
        via_ops = [_t(cq), _t(cs)]
        ops.append_kv_int8(x[:, 0], x[:, 1], via_ops[0][0, 1],
                           via_ops[1][0, 1], via_ops[0][1, 1],
                           via_ops[1][1, 1], 2, 3)
        for a in (got, via_ops):
            assert torch.equal(a[0], want[0])
            assert torch.equal(a[1].view(torch.int32),
                               want[1].view(torch.int32))
        assert kv_append_int8.launches == before
        assert act_quant.launches == 0

    def test_rejects_a_slot_outside_the_cache_or_mismatched_shapes(self):
        """Checked on every device, before the plain version or the kernel
        runs (a negative index would otherwise write the last slot)."""
        rng = np.random.default_rng(4)
        cq, cs = (_t(a) for a in _kv_cache(rng, 1, 2, 2, 4, 8))
        x = _t(_kv_new(rng, 2, 2, 8, "f32"))
        kv = (cq[0, 0], cs[0, 0], cq[1, 0], cs[1, 0])
        before = (cq.clone(), cs.clone())
        for bad in (4, 5, -1):
            with pytest.raises(ValueError, match="cur_index"):
                kv_append_int8(x[:, 0], x[:, 1], *kv, bad)
        with pytest.raises(ValueError, match="k_q"):     # replicate 2: H=4
            kv_append_int8(x[:, 0], x[:, 1], *kv, 0, 2)
        with pytest.raises(ValueError, match="v_new"):
            kv_append_int8(x[:, 0], x[:, 1, :1], *kv, 0)
        with pytest.raises(ValueError, match="replicate"):
            kv_append_int8(x[:, 0], x[:, 1], *kv, 0, 0)
        assert torch.equal(cq, before[0])
        assert torch.equal(cs.view(torch.int32), before[1].view(torch.int32))


# --- int8-KV decode attention (K6) ----------------------------------------------

def _kv_problem(seed, bh, s, d, g=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bh, g, d)).astype(np.float32)
    k = rng.normal(size=(bh, s, d)).astype(np.float32)
    v = rng.normal(size=(bh, s, d)).astype(np.float32)
    return q, k, v


class TestInt8KVDecode:
    @pytest.mark.parametrize("bh,s,d,bs", [(4, 512, 128, 256),
                                           (2, 512, 64, 128)])
    def test_matches_pallas_and_oracle(self, bh, s, d, bs):
        """g = 1 and n_valid = S is the TPU kernel's function: held to its
        interpret-mode Pallas run and its oracle at the JAX gate (2e-4)."""
        q, k, v = _kv_problem(bh + s, bh, s, d)
        jk = jops.prepare_kv_int8(jnp.asarray(k), jnp.asarray(v))
        scale = 1.0 / d ** 0.5
        out = decode_attention_int8kv(_t(q), *(_t(np.asarray(a)) for a in jk),
                                      s, scale)
        pallas = j_decode_attention_int8kv(jnp.asarray(q[:, 0]), *jk, bs=bs,
                                           interpret=True)
        oracle = jref.decode_attention_int8kv_ref(
            jnp.asarray(q[:, 0]), *jk, softmax_scale=scale)
        np.testing.assert_allclose(_np(out)[:, 0], np.asarray(pallas),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(_np(out)[:, 0], np.asarray(oracle),
                                   rtol=2e-4, atol=2e-4)
        assert decode_attention_int8kv.launches == 0

    @pytest.mark.parametrize("n_valid", [1, 37, 96])
    def test_grouped_layout_matches_the_masked_decode(self, n_valid):
        """Grouped query heads over a truncated cache equal the JAX
        decode's formula, which attends over the whole cache with the
        tokens past ``cur_index`` masked to -1e30 (attention.py:157-175)."""
        B, nkv, g, S, d = 2, 2, 7, 96, 64
        q, k, v = _kv_problem(n_valid, B * nkv, S, d, g)
        k_q, k_s, v_q, v_s = ops.prepare_kv_int8(_t(k), _t(v))
        scale = d ** -0.5
        out = decode_attention_int8kv(_t(q), k_q, k_s, v_q, v_s, n_valid,
                                      scale)
        jq = jnp.asarray(q).reshape(B, nkv, g, d)
        kk = (jnp.asarray(_np(k_q)) * jnp.asarray(_np(k_s))[..., None]
              ).reshape(B, nkv, S, d)
        vv = (jnp.asarray(_np(v_q)) * jnp.asarray(_np(v_s))[..., None]
              ).reshape(B, nkv, S, d)
        logits = jnp.einsum("bkgd,bksd->bkgs", jq, kk) * scale
        valid = jnp.arange(S)[None, None, None, :] <= n_valid - 1
        w = jax.nn.softmax(jnp.where(valid, logits, -1e30), -1)
        want = jnp.einsum("bkgs,bksd->bkgd", w, vv).reshape(B * nkv, g, d)
        np.testing.assert_allclose(_np(out), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        if n_valid == 1:      # one token: its value row, for every head
            np.testing.assert_allclose(
                _np(out), np.broadcast_to(np.asarray(vv).reshape(
                    B * nkv, S, d)[:, :1], out.shape), rtol=1e-6, atol=1e-6)

    def test_rejects_an_empty_or_overlong_window(self):
        q, k, v = _kv_problem(0, 2, 8, 16)
        kv = ops.prepare_kv_int8(_t(k), _t(v))
        for n_valid in (0, 9):
            with pytest.raises(ValueError, match="n_valid"):
                decode_attention_int8kv(_t(q), *kv, n_valid, 0.25)

    def test_sequence_split_fills_the_card(self):
        """About two blocks per SM at the decode's 16 rows, never a split
        shorter than one 32-token step for each of its block's 4 warps:
        the decode's first 128 positions take one block per row."""
        assert n_splits(16, 1) == 1
        assert n_splits(16, 64) == 1
        assert n_splits(16, 2048) == 16
        assert n_splits(300, 2048) == 1
