"""What the quantized matmul (K1/K2), the edge softmax (K3), the MDDQ
encode (K4), the int8 KV write (K5's KV entry) and the int8-KV decode
attention (K6) kernels decide, held on the CPU.

The CUDA kernels cannot run here (``tests/test_torch_cuda.py`` holds them
to their plain versions on a card). What their host side and algorithms
decide can: K1/K2's staged tiles and tensor-core fragments must give the
plain version's product bit for bit with no shared-memory bank conflict,
K3's 32-ary search must find the same segments as a lower bound and its
chunked softmax must stay within 1e-6 of the plain version; the band
search's plain model (seed window, certificate,
rescan of the z-band) must give the full search's codes exactly, and
K6's split arithmetic must cover every valid token once, under the
host's plan and under the device plan of a position read on the card
(splits sized from the cache length, each block's chunk the host's plan
of the n_valid it reads, for every n_valid up to the cache length), with the
kernel's decomposition (per-warp online softmax, warps merged in order,
the live splits combined in order; a split past the valid tokens, which
the kernel skips, would weigh exactly 0) within 1e-5 of the plain
version, K6's gate on the card. The KV write's warp/lane map must store every element and
scale of the slot exactly once from the right kv head's row, and the
codes it gives must equal the plain version's bit for bit.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.codebook import fibonacci_sphere, is_z_sorted, \
    make_codebook
from repro_torch.core.quantizers import scale_from_amax, unpack_int4
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.kernels.act_quant import (KV_HEAD_DIMS, elems_per_lane,
                                           kv_append_lane_map)
from repro_torch.kernels.attention_int8kv import (device_split_plan,
                                                  n_splits, split_plan,
                                                  warp_token_ranges)
from repro_torch.kernels.edge_softmax import (chunked_softmax_model,
                                              segment_bounds_model)
from repro_torch.kernels.mddq_kernel import (band_search_model,
                                             probe_vectors, seed_half_width,
                                             z_band)
from repro_torch.serving.bucketing import build_edge_list

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

    @pytest.mark.parametrize("rows,seq", [(16, 1024), (8, 288), (16, 288),
                                          (64, 32), (1, 2048), (300, 100)])
    def test_device_plan_takes_every_token_once(self, rows, seq):
        """A position read on the device: the grid's splits come from the
        cache length, and for every n_valid in 1..seq each block's chunk
        and warp runs, derived in the block, take every valid token once;
        the splits past them are empty."""
        splits = n_splits(rows, seq)
        for n_valid in range(1, seq + 1):
            s, chunk, run = device_split_plan(rows, seq, n_valid)
            assert s == splits and chunk % 32 == 0 and run % 32 == 0
            seen = np.zeros(n_valid, dtype=np.int64)
            live = set()
            for y, w, begin, end in warp_token_ranges(rows, n_valid, seq):
                if end > begin:
                    seen[begin:end] += 1
                    live.add(y)
            assert (seen == 1).all(), n_valid
            # the host's plan of n_valid: its splits live, within the grid
            host = split_plan(rows, n_valid)
            assert (chunk, run) == host[1:] and host[0] <= splits
            assert live == set(range(host[0]))

    def test_device_plan_at_the_decode_shape(self):
        # 16 rows over 1,024 slots: a grid of 8 splits at every position,
        # one of them live up to 128 tokens
        assert [device_split_plan(16, 1024, n) for n in (1, 64, 1024)] \
            == [(8, 32, 32), (8, 64, 32), (8, 128, 32)]


def _kernel_model(q, k_q, k_s, v_q, v_s, n_valid, scale, seq=None):
    """K6's decomposition in float32: per warp an online softmax over
    32-token steps, the block's warps merged in order (an empty one, or
    a whole empty block under the device plan of ``seq`` slots, weighs
    exactly 0), the splits combined in order."""
    bh = q.shape[0]
    k = k_q.float() * k_s[..., None]
    v = v_q.float() * v_s[..., None]
    parts = {}
    for y, w, begin, end in warp_token_ranges(bh, n_valid, seq):
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
        e = [torch.where(mx == -math.inf, 0.0, torch.exp(s[0] - mx))
             for s in states]
        return (mx, sum(s[1] * ei for s, ei in zip(states, e)),
                sum(s[2] * ei[..., None] for s, ei in zip(states, e)))
    _, l, acc = merge([merge(parts[y]) for y in sorted(parts)])
    return acc / l[..., None]


class TestDecodeMerge:
    @pytest.mark.parametrize("n_valid", [1, 33, 64, 200, 1024])
    def test_device_plan_matches_the_plain_version(self, n_valid):
        rng = np.random.default_rng(n_valid + 1)
        bh, g, s, d = 16, 7, 1024, 64
        q = torch.from_numpy(rng.normal(size=(bh, g, d)).astype(np.float32))
        k, v = (torch.from_numpy(rng.normal(size=(bh, s, d))
                                 .astype(np.float32)) for _ in range(2))
        kv = ops.prepare_kv_int8(2 * k, v)
        got = _kernel_model(q, *kv, n_valid, d ** -0.5, seq=s)
        want = ref.decode_attention_int8kv_ref(q, *kv, n_valid, d ** -0.5)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

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


# --- K1/K2: the staged tiles and the tensor-core fragments --------------------

MATMUL_SHAPES = [(256, 64, 192, False), (256, 16, 64, False),
                 (256, 80, 64, False), (256, 64, 32, True),
                 (1, 3, 2, False), (1, 3, 2, True), (255, 17, 66, False),
                 (255, 17, 66, True), (5, 300, 70, False),
                 (5, 300, 70, True)]


def _operands(m, k, n, w4, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(m, k)) * 2).astype(np.float32))
    x[0] = 0.0                                   # the 1e-8 floor
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    a_q, a_s = ref.act_quant_ref(x)
    w_q, w_s = ops.prepare_w4(w) if w4 else ops.prepare_w8(w)
    return a_q, a_s, w_q, w_s


class TestQuantMatmulStaging:
    @pytest.mark.parametrize("m,k,n,w4", MATMUL_SHAPES)
    def test_model_is_bit_for_bit_and_conflict_free(self, m, k, n, w4):
        """The kernel's staging (K padded to 32, the 4x4 byte transpose,
        W4 sign-extension in the transposed tile) fed through the
        m16n8k32 fragment layouts gives the plain version's result bit for
        bit, and no shared store or fragment read has a bank conflict."""
        a_q, a_s, w_q, w_s = _operands(m, k, n, w4, seed=m + k + n)
        got, conflict_free = qmm.mma_model(a_q.numpy(), a_s.numpy(),
                                           w_q.numpy(), w_s.numpy(), w4)
        plain = ref.w4a8_matmul_ref if w4 else ref.w8a8_matmul_ref
        np.testing.assert_array_equal(got, plain(a_q, a_s, w_q, w_s).numpy())
        assert conflict_free

    @pytest.mark.parametrize("k", [16, 17, 64, 80, 128, 300])
    def test_k_is_zero_padded_to_32(self, k):
        a_q, _, w_q, _ = _operands(20, k, 64, False, seed=k)
        for k0 in range(0, k, qmm.KC):
            As, Ws, kp, _ = qmm.staging_model(a_q.numpy(), w_q.numpy(), 64,
                                              False, 0, 0, k0)
            assert kp % 32 == 0 and kp >= min(qmm.KC, k - k0)
            a_bytes = qmm._bytes_of(As[:, :kp // 4]).reshape(qmm.BM, kp)
            w_bytes = qmm._bytes_of(Ws[:, :kp // 4]).reshape(qmm.BN, kp)
            live = min(qmm.KC, k - k0)
            np.testing.assert_array_equal(
                a_bytes[:, :live], a_q.numpy()[:qmm.BM, k0:k0 + live])
            np.testing.assert_array_equal(
                w_bytes[:, :live], w_q.numpy()[k0:k0 + live].T)
            assert not a_bytes[:, live:].any() and not w_bytes[:, live:].any()

    def test_w4_tile_is_the_w8_tile_of_its_nibbles(self):
        _, _, w4, _ = _operands(1, 80, 66, True, seed=1)
        w8 = unpack_int4(w4)
        for n0 in (0, 64):
            _, ws4, _, _ = qmm.staging_model(np.zeros((1, 80), np.int8),
                                             w4.numpy(), 66, True, 0, n0, 0)
            _, ws8, _, _ = qmm.staging_model(np.zeros((1, 80), np.int8),
                                             w8.numpy(), 66, False, 0, n0, 0)
            np.testing.assert_array_equal(ws4, ws8)

    def test_byte_transpose(self):
        rng = np.random.default_rng(0)
        rows = [rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
                .astype(np.uint32) for _ in range(4)]
        cols = qmm._transpose4(rows)
        got = np.stack([qmm._bytes_of(c) for c in cols], axis=1)
        want = np.stack([qmm._bytes_of(r) for r in rows], axis=2)
        np.testing.assert_array_equal(got, want)

    def test_nibble_sign_extension(self):
        p = np.arange(2 ** 16, dtype=np.uint32)
        got = qmm._bytes_of(qmm._sext_nibbles(p)).astype(np.int64)
        nib = (p[:, None] >> (4 * np.arange(4))) & 0xF
        np.testing.assert_array_equal(got, np.where(nib >= 8, nib - 16, nib))


# --- K3: the 32-ary segment search and the chunked softmax --------------------

def _lower_bound(receivers, edge_mask, lo, hi, target):
    keys = np.where(edge_mask, receivers.astype(np.int64), 2 ** 31 - 1)
    return lo + int(np.searchsorted(keys[lo:hi], target, side="left"))


def _layouts():
    """build_edge_list layouts: padded atoms and padding self-loops, an
    isolated atom, an all-padding molecule, and a molecule whose receivers
    each have 99 real edges."""
    rng = np.random.default_rng(0)
    B, cap = 4, 32
    coords = rng.uniform(0, 8.6, size=(B, cap, 3)).astype(np.float32)
    coords[0, 5] = 1e3                               # an isolated atom
    mask = np.ones((B, cap), bool)
    mask[0, 20:] = False
    mask[2] = False                                  # all padding
    out = [(build_edge_list(coords, mask, 3.0, 1024), cap, True)]
    dense = rng.uniform(0, 2.0, size=(1, 100, 3)).astype(np.float32)
    out.append((build_edge_list(dense, np.ones((1, 100), bool), 10.0,
                                100 * 99 + 124), 100, False))
    return out


class TestSegmentSearch:
    @pytest.mark.parametrize("which", [0, 1])
    def test_equals_lower_bound(self, which):
        el, cap, serving = _layouts()[which]
        n = el.receivers.shape[0] // el.edge_capacity * cap
        ec = el.edge_capacity
        for node in range(n):
            start, end, rounds = segment_bounds_model(
                el.receivers, el.edge_mask, node, cap, ec)
            b = node // cap
            lo, hi = b * ec, (b + 1) * ec
            assert start == _lower_bound(el.receivers, el.edge_mask, lo, hi,
                                         node)
            assert end == _lower_bound(el.receivers, el.edge_mask, lo, hi,
                                       node + 1)
            assert (el.receivers[start:end] == node).all()
            assert el.edge_mask[start:end].all()
            if serving:
                assert rounds <= 2            # 1,024 slots: two rounds
            else:
                assert end - start == 99       # > 64 real edges

    def test_isolated_and_padded_atoms_are_empty(self):
        el, cap, _ = _layouts()[0]
        for node in (5, 20, 31, 64, 80, 95):          # isolated, padded
            start, end, _ = segment_bounds_model(el.receivers, el.edge_mask,
                                                 node, cap, 1024)
            assert start == end


def _degree_layout(degrees, ec, seed):
    """One molecule whose node i receives degrees[i] real edges (senders
    at random), then masked self-loops on node 0 up to ec slots."""
    rng = np.random.default_rng(seed)
    cap = len(degrees)
    recv = np.repeat(np.arange(cap), degrees).astype(np.int32)
    send = rng.integers(0, cap, size=recv.shape[0]).astype(np.int32)
    pad = ec - recv.shape[0]
    mask = np.r_[np.ones(recv.shape[0], bool), np.zeros(pad, bool)]
    recv = np.r_[recv, np.zeros(pad, np.int32)]
    send = np.r_[send, np.zeros(pad, np.int32)]
    return (torch.from_numpy(send), torch.from_numpy(recv),
            torch.from_numpy(mask), cap)


class TestChunkedSoftmax:
    @pytest.mark.parametrize("F,W", [(16, 28), (64, 112)])
    def test_matches_the_plain_version(self, F, W):
        """Receivers with 1, 31, 32, 33 and 100 real edges (one to four
        chunks) and none."""
        degrees = [1, 31, 32, 33, 100, 0, 5, 0]
        send, recv, mask, cap = _degree_layout(degrees, 256, seed=F)
        rng = np.random.default_rng(W)
        q, k = (torch.from_numpy(rng.normal(size=(cap, F)).astype(np.float32))
                for _ in range(2))
        bias = torch.from_numpy(rng.normal(size=256).astype(np.float32))
        vals = torch.from_numpy(rng.normal(size=(256, W)).astype(np.float32))
        got = chunked_softmax_model(0.5 * q, k, bias, vals, send, recv, mask,
                                    cap)
        want = ref.edge_softmax_ref(0.5 * q, k, bias, send, recv, mask, vals,
                                    cap)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert (got[[5, 7]] == 0).all()


# --- K5's KV entry: the warp/lane map of the int8 KV write ----------------------

def _kv_model(k_new, v_new, cache, cur, replicate):
    """The KV write as the lane map runs it: each warp gathers its lanes'
    elements of its kv head's row, takes the max of the lanes' maxima,
    the row's scale, and each lane's codes from its own elements."""
    B, nkv, hd = k_new.shape
    epl = elems_per_lane(hd)
    m = kv_append_lane_map(B, nkv, hd, replicate)
    for blk in range(m["b"].shape[0]):
        for w in range(2):
            lanes = slice(32 * w, 32 * w + 32)
            t, b, h, src = (int(m[k][blk, 32 * w])
                            for k in ("tensor", "b", "h", "src"))
            row = (v_new if t else k_new)[b, src]
            firsts = [int(f) for f in m["first"][blk, lanes] if f >= 0]
            held = [row[f:f + epl] for f in firsts]
            amax = torch.stack([x.abs().amax() for x in held]).amax()
            scale = scale_from_amax(amax, 8).to(torch.float32)
            q, s = cache[2 * t], cache[2 * t + 1]
            for f, x in zip(firsts, held):
                q[b, h, cur, f:f + epl] = torch.clamp(torch.round(
                    x.to(torch.float32) / scale), -127, 127).to(torch.int8)
            assert m["scale"][blk, lanes].sum() == 1
            s[b, h, cur] = scale


class TestKVAppendLaneMap:
    @pytest.mark.parametrize("replicate", [1, 3])
    @pytest.mark.parametrize("hd", KV_HEAD_DIMS)
    def test_every_slot_element_stored_once(self, hd, replicate):
        """Every (K|V, b, h, element) of the slot is stored by exactly one
        lane and every scale by exactly one lane 0, each lane's elements
        are its vector's (aligned to ``elems_per_lane``), and head h reads
        kv head h // replicate; at hd 8 four lanes of each warp work."""
        B, nkv = 3, 2
        H, epl = nkv * replicate, elems_per_lane(hd)
        m = kv_append_lane_map(B, nkv, hd, replicate)
        assert m["b"].shape == (B * H, 64)
        np.testing.assert_array_equal(m["src"], m["h"] // replicate)
        active = m["first"] >= 0
        assert (m["first"][active] % epl == 0).all()
        assert (active.reshape(-1, 32).sum(1) == hd // epl).all()
        hits = np.zeros((2, B, H, hd), int)
        for t, b, h, f in zip(m["tensor"][active], m["b"][active],
                              m["h"][active], m["first"][active]):
            hits[t, b, h, f:f + epl] += 1
        assert (hits == 1).all()
        scales = np.zeros((2, B, H), int)
        np.add.at(scales, (m["tensor"][m["scale"]], m["b"][m["scale"]],
                           m["h"][m["scale"]]), 1)
        assert (scales == 1).all()
        # a warp is one row: the same tensor, batch row and head throughout
        for k in ("tensor", "b", "h"):
            warps = m[k].reshape(-1, 32)
            assert (warps == warps[:, :1]).all()

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("hd,replicate", [(8, 3), (64, 1), (128, 3)])
    def test_model_equals_the_plain_version(self, hd, replicate, dtype):
        """The lane map's arithmetic, on a cache with nonzero bytes
        around the slot, equals ``kv_append_int8_ref`` bit for bit (an
        all-zero row takes the 1e-8 floor)."""
        rng = np.random.default_rng(hd + replicate)
        B, nkv, S, cur = 2, 2, 3, 1
        H = nkv * replicate
        x = torch.from_numpy((rng.normal(size=(B, 2, nkv, hd)) * np.exp(
            rng.normal(size=(B, 2, nkv, 1)))).astype(np.float32)).to(dtype)
        x[1, 1, 0] = 0.0
        fill = [torch.from_numpy(rng.integers(-127, 128, size=(B, H, S, hd))
                                 .astype(np.int8)),
                torch.from_numpy(rng.uniform(size=(B, H, S))
                                 .astype(np.float32))]
        got = [t.clone() for t in fill + fill]
        want = [t.clone() for t in fill + fill]
        _kv_model(x[:, 0], x[:, 1], got, cur, replicate)
        ref.kv_append_int8_ref(x[:, 0], x[:, 1], *want, cur, replicate)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
