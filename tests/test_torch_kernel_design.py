"""What the MDDQ encode (K4) and int8-KV decode attention (K6) kernels
decide, held on the CPU.

The CUDA kernels cannot run here (``tests/test_torch_cuda.py`` holds them
to their plain versions on a card). What their host side and algorithms
decide can: the band search's plain model (seed window, certificate,
rescan of the z-band) must give the full search's codes exactly, and
K6's split arithmetic must cover every valid token once, with the
kernel's decomposition (per-warp online softmax, warps merged in order,
splits combined in order) within 1e-5 of the plain version, K6's gate on
the card.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.codebook import fibonacci_sphere, is_z_sorted, \
    make_codebook
from repro_torch.kernels import ops, ref
from repro_torch.kernels.attention_int8kv import (n_splits, split_plan,
                                                  warp_token_ranges)
from repro_torch.kernels.mddq_kernel import (band_search_model,
                                             probe_vectors, seed_half_width,
                                             z_band)

KINDS = ("gaussian", "codewords", "poles", "equator", "index_midpoints",
         "spiral_midpoints", "zero", "tiny")


def _unit(v):
    return v / torch.clamp(ref._norm3(v), min=1e-12)[:, None]


# --- K4: the band search ------------------------------------------------------

class TestBandSearch:
    @pytest.mark.parametrize("bits", [8, 12, 16])
    @pytest.mark.parametrize("kind", KINDS)
    def test_gives_the_full_search_codes(self, bits, kind):
        cb = make_codebook(bits)
        v = probe_vectors(cb, seed=bits)[kind]
        idx, scored, certified = band_search_model(v, cb)
        np.testing.assert_array_equal(idx.numpy(),
                                      ref.nearest_code_ref(_unit(v), cb)
                                      .numpy())
        assert (scored <= cb.shape[0] + 2 * seed_half_width(cb.shape[0])
                + 1).all()
        if kind == "zero":
            assert (idx == 0).all() and (scored == 0).all()
        else:
            # the band is taken around u / |u|, so the seed alone
            # certifies its answer, for short vectors too
            assert certified.all()
            assert (scored <= 2 * seed_half_width(cb.shape[0]) + 1).all()

    def test_half_zero_batch_at_16_bits(self):
        """The serving shape's mix: every probe kind, then as many exact
        zeros (padded atoms), which score nothing."""
        cb = make_codebook(16)
        v = torch.cat(list(probe_vectors(cb, seed=3).values()))
        v = torch.cat([v, torch.zeros_like(v)])
        idx, scored, _ = band_search_model(v, cb)
        want, _ = ref.mddq_encode_ref(v, cb)
        assert torch.equal(idx, want)
        assert (scored[v.shape[0] // 2:] == 0).all()

    @pytest.mark.parametrize("bits", [8, 16])
    def test_band_holds_every_maximizer(self, bits):
        """The z-band at the best score holds the answer, and is narrow:
        ~400 of 65,536 codewords at 16 bits."""
        cb = make_codebook(bits)
        g = torch.Generator().manual_seed(bits)
        u = _unit(torch.randn(512, 3, generator=g))
        idx = ref.nearest_code_ref(u, cb).long()
        c = cb[idx]
        best = (u[:, 0] * c[:, 0] + u[:, 1] * c[:, 1]) + u[:, 2] * c[:, 2]
        lo, hi = z_band(u, cb[:, 2], best)
        assert ((lo <= idx) & (idx <= hi)).all()
        width = (hi - lo + 1).float()
        assert float(width.max()) < 2 * seed_half_width(cb.shape[0]) + 1

    @pytest.mark.parametrize("bits", [8, 16])
    def test_subnormal_vectors(self, bits):
        """Vectors whose squares underflow: u = v / 1e-12 is short and its
        own squares underflow too, so |u| is taken from u scaled by a
        power of two."""
        cb = make_codebook(bits)
        v = torch.tensor([[1e-45, 0.0, 0.0], [1e-45, -1e-45, 3e-45],
                          [0.0, 0.0, -1e-40], [1e-30, 2e-30, -1e-30],
                          [-7e-39, 1e-38, 2e-39]])
        idx, scored, certified = band_search_model(v, cb)
        assert torch.equal(idx, ref.nearest_code_ref(_unit(v), cb))
        assert certified.all()

    def test_nan_input_takes_index_0(self):
        """No score beats -2 for a NaN vector, in the full search as in
        the band search."""
        cb = make_codebook(8)
        v = torch.tensor([[float("nan"), 0.0, 1.0], [1.0, 0.0, 0.0]])
        idx, _, _ = band_search_model(v, cb)
        assert torch.equal(idx, ref.nearest_code_ref(_unit(v), cb))
        assert int(idx[0]) == 0


class TestCodebookOrder:
    @pytest.mark.parametrize("bits", [4, 8, 12, 16])
    def test_make_codebook_marks_z_sorted(self, bits):
        cb = make_codebook(bits)
        assert cb.z_sorted is True
        assert is_z_sorted(fibonacci_sphere(2 ** bits))

    def test_a_permuted_codebook_is_not(self):
        pts = fibonacci_sphere(2 ** 8)
        perm = np.random.default_rng(0).permutation(pts.shape[0])
        assert not is_z_sorted(pts[perm])
        assert not getattr(make_codebook(8)[torch.from_numpy(perm)],
                           "z_sorted", False)


# --- K6: splits and the merge -------------------------------------------------

ROWS = (1, 16, 64, 300)
N_VALID = (1, 31, 32, 33, 64, 65, 127, 128, 129, 1000, 1024, 2048, 4097)


class TestDecodeSplits:
    @pytest.mark.parametrize("rows", ROWS)
    @pytest.mark.parametrize("n_valid", N_VALID)
    def test_every_token_once_and_no_empty_split(self, rows, n_valid):
        splits, chunk, run = split_plan(rows, n_valid)
        assert chunk % 32 == 0 and run % 32 == 0
        seen = np.zeros(n_valid, dtype=np.int64)
        first = {}
        for y, w, begin, end in warp_token_ranges(rows, n_valid):
            if end > begin:
                seen[begin:end] += 1
            if w == 0:
                first[y] = end - begin
        assert (seen == 1).all()
        assert len(first) == splits
        assert all(n > 0 for n in first.values())     # no empty split
        # about two blocks per SM at most, beyond what one split per row
        # needs
        assert rows * splits <= max(rows, 2 * 132 + rows)

    @pytest.mark.parametrize("n_valid", [1, 37, 64, 65, 128])
    def test_one_split_at_the_decode_shape(self, n_valid):
        assert n_splits(16, n_valid) == 1
        assert split_plan(16, n_valid)[0] == 1

    def test_long_cache_fills_the_card(self):
        assert split_plan(16, 2048) == (16, 128, 32)
        assert n_splits(300, 2048) == 1


def _kernel_model(q, k_q, k_s, v_q, v_s, n_valid, scale):
    """K6's decomposition in float32: per warp an online softmax over
    32-token steps, the block's warps merged in order, the splits
    combined in order."""
    bh = q.shape[0]
    k = k_q.float() * k_s[..., None]
    v = v_q.float() * v_s[..., None]
    parts = {}
    for y, w, begin, end in warp_token_ranges(bh, n_valid):
        m = torch.full(q.shape[:2], -math.inf)
        l = torch.zeros(q.shape[:2])
        acc = torch.zeros(q.shape)
        for t0 in range(begin, end, 32):
            t1 = min(t0 + 32, end)
            s = torch.einsum("bgd,btd->bgt", q, k[:, t0:t1]) * scale
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bgt,btd->bgd", p,
                                                       v[:, t0:t1])
            m = m_new
        parts.setdefault(y, []).append((m, l, acc))

    def merge(states):
        mx = torch.stack([s[0] for s in states]).amax(0)
        e = [torch.exp(s[0] - mx) for s in states]
        return (mx, sum(s[1] * ei for s, ei in zip(states, e)),
                sum(s[2] * ei[..., None] for s, ei in zip(states, e)))
    _, l, acc = merge([merge(parts[y]) for y in sorted(parts)])
    return acc / l[..., None]


class TestDecodeMerge:
    @pytest.mark.parametrize("n_valid", [1, 31, 33, 64, 65, 200, 2048])
    def test_matches_the_plain_version(self, n_valid):
        rng = np.random.default_rng(n_valid)
        bh, g, s, d = 16, 7, 2048, 64
        q = torch.from_numpy(rng.normal(size=(bh, g, d)).astype(np.float32))
        k, v = (torch.from_numpy(rng.normal(size=(bh, s, d))
                                 .astype(np.float32)) for _ in range(2))
        kv = ops.prepare_kv_int8(2 * k, v)
        got = _kernel_model(q, *kv, n_valid, d ** -0.5)
        want = ref.decode_attention_int8kv_ref(q, *kv, n_valid, d ** -0.5)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
