"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one (a CUDA kernel
has no CPU mode). On the card, with no JAX installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the quantized matmuls (int8-A and f32-A entries), the MDDQ
encode codes, the
activation quantizer (float32 and bfloat16) and the int8 KV write (the
whole cache, byte for byte) exactly (the kernels repeat
their plain versions' arithmetic in the same order); the edge softmax and
the int8-KV decode attention to 1e-5 (their sums run in another order).
The LM decode on the card against the CPU plain path to 1e-4 of the
largest |logit| (float32 smoke config; the card's cuBLAS sums in another
order than the CPU), and so are 10 MD steps (w8a8, MDDQ off) in
coordinates and total energy; the device edge list bit for bit. A packed
artifact loads onto the card byte for byte, and the scheduler's results
there match the CPU plain path on the same artifact to 1e-4 (the engine's
tolerance). A 2-replica cluster pool on cuda:0 answers as the direct
engine (energies equal, forces to 1e-5 of the largest |force|), each
replica's worker on its own stream; a rolling swap under traffic drops
nothing; an MD session's failed-over chunk re-emits every frame index.
The training programs (a full QAT step, an NVE segment, the launcher's
step on the (1, 1) mesh, the training set's classical-MD frame)
replayed from one state against five eager runs of their bodies from
it: bit for bit where the eager runs agree bit for bit, else within
twice their largest gap; a full QAT step launches K4 15 times by the
capture's tally and by the profiler.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.codebook import make_codebook
from repro_torch.kernels import ops, ref
from repro_torch.kernels.act_quant import act_quant, kv_append_int8
from repro_torch.kernels.attention_int8kv import decode_attention_int8kv
from repro_torch.kernels.edge_softmax import edge_softmax_fused
from repro_torch.kernels.mddq_kernel import mddq_encode_kernel, probe_vectors
from repro_torch.kernels.quant_matmul import (w4a8_matmul, w4a8_matmul_f32a,
                                              w8a8_matmul, w8a8_matmul_f32a)
from repro_torch.launch import serve, steps
from repro_torch.md import MDConfig, MDEngine, pad_replicas
from repro_torch.models.lm.transformer import init_cache
from repro_torch.models.so3krates import So3kratesConfig
from repro_torch.server import (MicroBatchScheduler, SchedulerConfig,
                                SizeClass, TrafficConfig, load_artifact,
                                load_engine, make_traffic, run_open_loop,
                                save_artifact)
from repro_torch.serving import QuantizedEngine, ServeConfig, random_graphs
from repro_torch.serving.qparams import QTensor
from repro_torch.serving.bucketing import build_edge_list, device_edge_list

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


MATMUL_SHAPES = [(1, 3, 2), (37, 80, 64), (256, 64, 192), (130, 100, 66),
                 (256, 16, 64), (256, 80, 64), (256, 64, 32), (255, 17, 66),
                 (256, 80, 1), (5, 300, 70)]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_quant_matmul_bit_for_bit(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m)
    a_q, a_s = ops.quantize_activations(
        torch.randn(m, k, generator=g, device=cuda))
    w = torch.randn(k, n, generator=g, device=cuda)
    w8, s8 = ops.prepare_w8(w)
    before = w8a8_matmul.launches
    assert torch.equal(w8a8_matmul(a_q, a_s, w8, s8),
                       ref.w8a8_matmul_ref(a_q, a_s, w8, s8))
    if n % 2 == 0:                     # W4 packs column pairs
        w4, s4 = ops.prepare_w4(w)
        assert torch.equal(w4a8_matmul(a_q, a_s, w4, s4),
                           ref.w4a8_matmul_ref(a_q, a_s, w4, s4))
    assert w8a8_matmul.launches == before + 1


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_quant_matmul_f32a_bit_for_bit(cuda, m, k, n):
    """The f32-A entries against act_quant_ref followed by the plain
    matmul, with an all-zero row (scale 1e-8 / 127) and a row below the
    floor; one launch per call and no act-quant launch."""
    g = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn(m, k, generator=g, device=cuda) \
        * torch.exp(torch.randn(m, 1, generator=g, device=cuda))
    x[0] = 0.0
    if m > 2:
        x[1] = 1e-9
    w = torch.randn(k, n, generator=g, device=cuda)
    a_q, a_s = ref.act_quant_ref(x)
    before = (w8a8_matmul_f32a.launches, w4a8_matmul_f32a.launches,
              act_quant.launches)
    w8, s8 = ops.prepare_w8(w)
    assert torch.equal(w8a8_matmul_f32a(x, w8, s8),
                       ref.w8a8_matmul_ref(a_q, a_s, w8, s8))
    if n % 2 == 0:
        w4, s4 = ops.prepare_w4(w)
        assert torch.equal(w4a8_matmul_f32a(x, w4, s4),
                           ref.w4a8_matmul_ref(a_q, a_s, w4, s4))
    assert (w8a8_matmul_f32a.launches, w4a8_matmul_f32a.launches,
            act_quant.launches) == (before[0] + 1,
                                    before[1] + (n % 2 == 0), before[2])


def test_quant_matmul_rejects_bad_arguments(cuda):
    x = torch.randn(8, 16, device=cuda)
    a_q, a_s = ops.quantize_activations(x)
    w, s = ops.prepare_w8(torch.randn(16, 8, device=cuda))
    w4, s4 = ops.prepare_w4(torch.randn(16, 8, device=cuda))
    with pytest.raises(TypeError):
        w8a8_matmul(a_q, a_s, w.to(torch.uint8), s)
    with pytest.raises(ValueError):
        w8a8_matmul(a_q, a_s, w.t().contiguous().t(), s)
    with pytest.raises(ValueError):
        w8a8_matmul(a_q, a_s, w.cpu(), s)
    with pytest.raises(TypeError):
        w4a8_matmul(a_q, a_s, w, s4)
    with pytest.raises(TypeError):
        w8a8_matmul_f32a(x.to(torch.bfloat16), w, s)
    with pytest.raises(TypeError):
        w8a8_matmul_f32a(x, w.to(torch.uint8), s)
    with pytest.raises(TypeError):
        w4a8_matmul_f32a(x, w, s4)
    with pytest.raises(ValueError):
        w8a8_matmul_f32a(x[:, :8], w, s)
    with pytest.raises(ValueError):
        w8a8_matmul_f32a(x.t().contiguous().t(), w, s)
    with pytest.raises(ValueError):
        w4a8_matmul_f32a(x, w4.cpu(), s4)


def _edge_inputs(el, B, cap, F, W, dev, seed):
    rng = np.random.default_rng(seed)
    n, e = B * cap, el.receivers.shape[0]
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)   # noqa: E731
    q, k = (t(rng.normal(size=(n, F)).astype(np.float32)) for _ in range(2))
    bias = t(rng.normal(size=(e,)).astype(np.float32))
    vals = t(rng.normal(size=(e, W)).astype(np.float32))
    return q, k, bias, vals, t(el.senders), t(el.receivers), t(el.edge_mask)


def _edge_softmax_exact_zeros(got, r, m, n):
    has_edge = torch.zeros(n, dtype=torch.bool, device=got.device)
    has_edge[r[m].long()] = True
    assert (got[~has_edge] == 0).all()


def test_edge_softmax_every_pair_connected(cuda):
    """64-atom molecules whose cutoff connects every pair: 63 real edges
    per receiver, two chunks of the kernel's softmax; one launch."""
    B, cap, F, W = 4, 64, 64, 112
    rng = np.random.default_rng(7)
    coords = rng.uniform(0, 3.0, size=(B, cap, 3)).astype(np.float32)
    mask = np.ones((B, cap), bool)
    mask[3, 40:] = False
    el = build_edge_list(coords, mask, 10.0, 4096)
    assert el.n_real == 3 * 64 * 63 + 40 * 39
    q, k, bias, vals, s, r, m = _edge_inputs(el, B, cap, F, W, cuda, 1)
    before = edge_softmax_fused.launches
    got = edge_softmax_fused(q, k, bias, vals, s, r, m, cap)
    assert edge_softmax_fused.launches == before + 1
    want = ref.edge_softmax_ref(q, k, bias, s, r, m, vals, B * cap)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    _edge_softmax_exact_zeros(got, r, m, B * cap)


@pytest.mark.parametrize("F,W", [(16, 28), (128, 256), (13, 30), (64, 111)])
def test_edge_softmax_widths(cuda, F, W):
    """The smallest and largest widths the serving configs use (F=16,
    W=28 and the kernel's limits F=128, W=256), and widths that are not
    multiples of 4 (the kernel's single-float path)."""
    rng = np.random.default_rng(F + W)
    B, cap = 4, 32
    coords = rng.uniform(0, 8.6, size=(B, cap, 3)).astype(np.float32)
    mask = np.ones((B, cap), bool)
    mask[1, 10:] = False
    el = build_edge_list(coords, mask, 3.0, 1024)
    q, k, bias, vals, s, r, m = _edge_inputs(el, B, cap, F, W, cuda, F)
    got = edge_softmax_fused(q, k, bias, vals, s, r, m, cap)
    want = ref.edge_softmax_ref(q, k, bias, s, r, m, vals, B * cap)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    _edge_softmax_exact_zeros(got, r, m, B * cap)


def test_edge_softmax_rejects_bad_arguments(cuda):
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 5.0, size=(2, 16, 3)).astype(np.float32)
    el = build_edge_list(coords, np.ones((2, 16), bool), 3.0, 256)
    q, k, bias, vals, s, r, m = _edge_inputs(el, 2, 16, 16, 28, cuda, 0)
    with pytest.raises(ValueError):
        edge_softmax_fused(q, k, bias, vals, s, r, m, 15)
    with pytest.raises(ValueError):
        edge_softmax_fused(torch.zeros(32, 129, device=cuda), k, bias, vals,
                           s, r, m, 16)
    with pytest.raises(TypeError):
        edge_softmax_fused(q, k, bias, vals, s.long(), r, m, 16)
    with pytest.raises(ValueError):
        edge_softmax_fused(q, k.cpu(), bias, vals, s, r, m, 16)
    with pytest.raises(ValueError):
        edge_softmax_fused(q, k, bias, vals.t().contiguous().t(), s, r, m,
                           16)


def test_edge_softmax_matches_plain(cuda):
    rng = np.random.default_rng(3)
    B, cap, ec, F, W = 4, 32, 256, 64, 112
    coords = rng.uniform(0, 8.6, size=(B, cap, 3)).astype(np.float32)
    coords[1] = np.arange(cap)[:, None] * 30.0      # a molecule with no edges
    mask = np.ones((B, cap), bool)
    mask[0, cap // 2:] = False
    el = build_edge_list(coords, mask, 3.0, ec)
    n, e = B * cap, B * ec
    t = lambda a: torch.from_numpy(np.array(a)).to(cuda)   # noqa: E731
    q, k = (t(rng.normal(size=(n, F)).astype(np.float32)) for _ in range(2))
    bias = t(rng.normal(size=(e,)).astype(np.float32))
    vals = t(rng.normal(size=(e, W)).astype(np.float32))
    s, r, m = t(el.senders), t(el.receivers), t(el.edge_mask)
    got = edge_softmax_fused(q, k, bias, vals, s, r, m, cap)
    want = ref.edge_softmax_ref(q, k, bias, s, r, m, vals, n)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    has_edge = torch.zeros(n, dtype=torch.bool, device=cuda)
    has_edge[r[m].long()] = True
    assert not has_edge[cap:2 * cap].any()
    assert (got[~has_edge] == 0).all()


@pytest.mark.parametrize("layout", ["md", "every_pair"])
def test_edge_softmax_refined_skin_list(cuda, layout):
    """An MD skin list refined to a smaller cutoff (holes inside the
    receivers' runs) with every listed edge of three receivers masked:
    the search runs on the layout mask, masked edges drop out, emptied
    receivers write exactly 0; one launch."""
    rng = np.random.default_rng(11)
    if layout == "md":      # chip_smoke phase 5's layout, 8 x 24 atoms
        B, cap, ec, skin_cut, cut = 8, 24, 640, 10.45, 5.0
        coords = rng.uniform(0, (cap / 0.1) ** (1 / 3), size=(B, cap, 3))
    else:                   # 63 listed edges per receiver, two chunks
        B, cap, ec, skin_cut, cut = 4, 64, 4096, 10.0, 3.0
        coords = rng.uniform(0, 5.0, size=(B, cap, 3))
    coords = torch.from_numpy(coords.astype(np.float32)).to(cuda)
    s, r, lay, _ = device_edge_list(
        coords, torch.ones((B, cap), dtype=torch.bool, device=cuda),
        skin_cut, ec)
    m = ops.refine_edge_mask(coords.reshape(-1, 3), s, r, lay, cut)
    emptied = torch.tensor([1, cap + 5, B * cap - 1], dtype=torch.int32,
                           device=cuda)
    m &= ~torch.isin(r, emptied)
    assert bool((m != lay).any())
    n, e, F, W = B * cap, B * ec, 64, 112
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa
    q, k = t(rng.normal(size=(n, F))), t(rng.normal(size=(n, F)))
    bias, vals = t(rng.normal(size=e)), t(rng.normal(size=(e, W)))
    before = edge_softmax_fused.launches
    got = edge_softmax_fused(q, k, bias, vals, s, r, m, cap, lay)
    assert edge_softmax_fused.launches == before + 1
    want = ref.edge_softmax_ref(q, k, bias, s, r, m, vals, n)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (got[emptied.long()] == 0).all()
    _edge_softmax_exact_zeros(got, r, m, n)


@pytest.mark.parametrize("ns,cap,ec,cutoff", [
    ((24,) * 8, 24, 640, 10.45), ((5, 16, 1, 9), 16, 256, 3.0),
    ((4, 3), 4, 128, 3.0)])
def test_device_edge_list_card_matches_cpu(cuda, ns, cap, ec, cutoff):
    rng = np.random.default_rng(cap)
    coords = np.zeros((len(ns), cap, 3), np.float32)
    mask = np.zeros((len(ns), cap), bool)
    for b, n in enumerate(ns):
        coords[b, :n] = rng.uniform(0, (n / 0.1) ** (1 / 3), size=(n, 3))
        mask[b, :n] = True
    cpu = device_edge_list(torch.from_numpy(coords), torch.from_numpy(mask),
                           cutoff, ec)
    card = device_edge_list(torch.from_numpy(coords).to(cuda),
                            torch.from_numpy(mask).to(cuda), cutoff, ec)
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


def test_md_on_card_matches_cpu_plain_path(cuda):
    """10 MD steps, w8a8 with MDDQ off, the same weights and initial
    velocities on both devices: coordinates and total energies to 1e-4
    of the largest |value|, the card through K1'/K3 (and no K5/K6)."""
    cfg = So3kratesConfig(feat=16, vec_feat=4, n_layers=2, n_rbf=4,
                          dir_bits=6, cutoff=3.0)
    rng = np.random.default_rng(5)
    sp = rng.integers(0, cfg.n_species, 20).astype(np.int32)
    co = rng.uniform(0, (20 / 0.1) ** (1 / 3), size=(20, 3)).astype(
        np.float32)
    spec, coords, mask = pad_replicas(sp, co, 2)
    masses = np.full(20, 12.0, np.float32)
    md = MDConfig(mode="w8a8", dt_fs=0.25, record_every=5, skin=0.1,
                  quant_vectors=False)
    out = {}
    for dev in (cuda, "cpu"):
        eng = MDEngine(cfg, md=md, device=dev)
        st = eng.init_state(3, spec, coords, mask, masses, 300.0)
        before = (w8a8_matmul_f32a.launches, edge_softmax_fused.launches,
                  act_quant.launches, decode_attention_int8kv.launches)
        st, rec = eng.run(st, spec, mask, masses, n_steps=10)
        after = (w8a8_matmul_f32a.launches, edge_softmax_fused.launches,
                 act_quant.launches, decode_attention_int8kv.launches)
        out[str(dev)] = (st.coords.cpu().numpy(), rec, before, after)
    c_card, r_card, before, after = out[str(cuda)]
    c_cpu, r_cpu, _, _ = out["cpu"]
    assert after[0] > before[0] and after[1] - before[1] == 2 * 10
    assert after[2:] == before[2:]
    assert np.abs(c_card - c_cpu).max() <= 1e-4 * np.abs(c_cpu).max()
    assert np.abs(r_card["e_tot"] - r_cpu["e_tot"]).max() \
        <= 1e-4 * np.abs(r_cpu["e_tot"]).max()
    assert r_card["n_rebuilds"] == r_cpu["n_rebuilds"]


@pytest.mark.parametrize("n,bits", [(1, 6), (4096, 16), (1000, 12)])
def test_mddq_encode_exact(cuda, n, bits):
    g = torch.Generator(device=cuda).manual_seed(n)
    v = torch.randn(n, 3, generator=g, device=cuda) * 3.0
    v[: min(n, 4)] = 0.0
    cb = make_codebook(bits, device=cuda)
    idx, mag = mddq_encode_kernel(v, cb)
    idx_p, mag_p = ref.mddq_encode_ref(v, cb)
    assert torch.equal(idx, idx_p) and torch.equal(mag, mag_p)
    # a row-major (C, 3) codebook, which the wrapper transposes itself
    idx_r, mag_r = mddq_encode_kernel(v, cb.contiguous())
    assert torch.equal(idx_r, idx) and torch.equal(mag_r, mag)


def test_mddq_encode_probe_vectors_exact(cuda):
    """16 bits, every probe kind (near ties, poles, equator, codewords,
    vectors under 1e-12) and as many zeros: the band search, one launch
    per call; then a permuted codebook through the full search."""
    cb = make_codebook(16, device=cuda)
    v = torch.cat(list(probe_vectors(cb, seed=1, n=256).values()))
    v = torch.cat([v, torch.zeros_like(v)])
    before = (mddq_encode_kernel.launches, mddq_encode_kernel.full_launches)
    idx, mag = mddq_encode_kernel(v, cb)
    assert (mddq_encode_kernel.launches, mddq_encode_kernel.full_launches) \
        == (before[0] + 1, before[1])
    idx_p, mag_p = ref.mddq_encode_ref(v, cb)
    assert torch.equal(idx, idx_p) and torch.equal(mag, mag_p)
    perm = torch.randperm(cb.shape[0], generator=torch.Generator().manual_seed(0))
    cb_perm = cb[perm.to(cuda)]
    idx, mag = mddq_encode_kernel(v, cb_perm)
    assert (mddq_encode_kernel.launches, mddq_encode_kernel.full_launches) \
        == (before[0] + 2, before[1] + 1)
    idx_p, mag_p = ref.mddq_encode_ref(v, cb_perm)
    assert torch.equal(idx, idx_p) and torch.equal(mag, mag_p)


def test_engine_on_card_matches_cpu_plain_path(cuda):
    cfg = So3kratesConfig(feat=16, vec_feat=4, n_layers=2, n_rbf=4,
                          dir_bits=6, cutoff=3.0)
    graphs = random_graphs(6, 1, 14, cfg.n_species, seed=0)
    serve = ServeConfig(mode="w4a8", path="sparse", bucket_sizes=(16,),
                        max_batch=8, mddq_kernel=True)
    counters = (w8a8_matmul_f32a, w4a8_matmul_f32a, edge_softmax_fused,
                mddq_encode_kernel)
    before = [c.launches for c in counters]
    others = (act_quant, kv_append_int8, w8a8_matmul, w4a8_matmul)
    quiet = [c.launches for c in others]
    card = QuantizedEngine.from_config(cfg, serve=serve,
                                       device=cuda).infer_batch(graphs)
    assert all(c.launches > b for c, b in zip(counters, before))
    # the A8 step runs inside the matmul launches
    assert [c.launches for c in others] == quiet
    cpu = QuantizedEngine.from_config(cfg, serve=serve,
                                      device="cpu").infer_batch(graphs)
    f_scale = max(float(np.abs(r.forces).max()) for r in cpu)
    for a, b in zip(card, cpu):
        assert abs(a.energy - b.energy) <= 1e-4 * max(abs(b.energy), 1.0)
        assert float(np.abs(a.forces - b.forces).max()) <= 1e-4 * f_scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(1, 1), (16, 64), (256, 16), (256, 80),
                                 (4096, 896), (37, 1000)])
def test_act_quant_bit_for_bit(cuda, dtype, m, k):
    g = torch.Generator(device=cuda).manual_seed(m * k)
    x = (torch.randn(m, k, generator=g, device=cuda)
         * torch.exp(torch.randn(m, 1, generator=g, device=cuda))).to(dtype)
    x[0] = 0.0                                   # the 1e-8 floor
    if m > 2:
        x[1] = 1e-9                              # below the floor
    before = act_quant.launches
    q, s = act_quant(x)
    q_p, s_p = ref.act_quant_ref(x)
    assert act_quant.launches == before + 1
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    q_c, s_c = ref.act_quant_ref(x.cpu())
    assert torch.equal(q.cpu(), q_c) and torch.equal(s.cpu(), s_c)


def test_act_quant_rejects_bad_arguments(cuda):
    with pytest.raises(TypeError):
        act_quant(torch.zeros(4, 8, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError):
        act_quant(torch.zeros(8, 4, device=cuda).T)


def _kv_stacked_cache(cuda, B, H, S, hd):
    """A 3-layer int8 cache of -128 (never a code) with NaN scales: a
    write outside its slot shows in the bytes."""
    q = torch.full((2, 3, B, H, S, hd), -128, dtype=torch.int8, device=cuda)
    s = torch.full((2, 3, B, H, S), float("nan"), device=cuda)
    return q, s


def _kv_write(fn, x, q, s, cur, rep):
    """``fn`` on layer 1's views; K and V are strided views of x."""
    fn(x[:, 0], x[:, 1], q[0, 1], s[0, 1], q[1, 1], s[1, 1], cur, rep)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nkv,hd,rep,S", [
    (8, 2, 64, 1, 1024),       # qwen2-0.5b's decode
    (2, 8, 128, 1, 64),        # llama3.2-3b's heads
    (3, 1, 8, 1, 16),          # qwen2's smoke config
    (2, 2, 64, 3, 32), (2, 2, 8, 3, 16), (2, 2, 128, 3, 16)])
def test_kv_append_int8_bit_for_bit(cuda, dtype, B, nkv, hd, rep, S):
    """The whole stacked cache, byte for byte, against the plain version
    on the card and on the CPU, at the first and last slot, with an
    all-zero row; one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(B * hd + rep)
    x = (torch.randn(B, 2, nkv, hd, generator=g, device=cuda)
         * torch.exp(torch.randn(B, 2, nkv, 1, generator=g, device=cuda))
         ).to(dtype)
    x[0, 0, 0] = 0.0                             # the 1e-8 floor
    for cur in (0, S - 1):
        got = _kv_stacked_cache(cuda, B, nkv * rep, S, hd)
        want = [t.clone() for t in got]
        before = kv_append_int8.launches
        _kv_write(kv_append_int8, x, *got, cur, rep)
        assert kv_append_int8.launches == before + 1
        _kv_write(ref.kv_append_int8_ref, x, *want, cur, rep)
        on_cpu = [t.cpu() for t in _kv_stacked_cache(cuda, B, nkv * rep, S,
                                                     hd)]
        _kv_write(ref.kv_append_int8_ref, x.cpu(), *on_cpu, cur, rep)
        for w in (want, [t.to(cuda) for t in on_cpu]):
            assert torch.equal(got[0], w[0])
            assert torch.equal(got[1].view(torch.int32),
                               w[1].view(torch.int32))
        assert (got[0][:, 1, :, :, cur] != -128).all()
        assert not got[1][:, 1, :, :, cur].isnan().any()


def test_kv_append_int8_rejects_bad_arguments(cuda):
    B, nkv, hd, S = 2, 2, 64, 8
    q, s = _kv_stacked_cache(cuda, B, nkv, S, hd)
    kv = (q[0, 0], s[0, 0], q[1, 0], s[1, 0])
    x = torch.randn(B, 2, nkv, hd, device=cuda)
    before = kv_append_int8.launches
    with pytest.raises(TypeError):
        h = x.to(torch.float16)
        kv_append_int8(h[:, 0], h[:, 1], *kv, 0)
    with pytest.raises(ValueError, match="head_dim"):
        q32, s32 = _kv_stacked_cache(cuda, B, nkv, S, 32)
        x32 = torch.randn(B, 2, nkv, 32, device=cuda)
        kv_append_int8(x32[:, 0], x32[:, 1], q32[0, 0], s32[0, 0],
                       q32[1, 0], s32[1, 0], 0)
    with pytest.raises(ValueError, match="last dim"):
        wide = torch.randn(B, 2, nkv, 2 * hd, device=cuda)[..., ::2]
        kv_append_int8(wide[:, 0], wide[:, 1], *kv, 0)
    with pytest.raises(ValueError, match="aligned"):
        odd = torch.randn(B * 2 * nkv * hd + 1, device=cuda)[1:] \
            .view(B, 2, nkv, hd)
        kv_append_int8(odd[:, 0], odd[:, 1], *kv, 0)
    for bad in (S, -1):
        with pytest.raises(ValueError, match="cur_index"):
            kv_append_int8(x[:, 0], x[:, 1], *kv, bad)
    assert kv_append_int8.launches == before
    assert (q == -128).all() and s.isnan().all()


@pytest.mark.parametrize("n_valid", [1, 31, 32, 33, 37, 64, 65, 1000, 2048])
def test_decode_attention_int8kv_matches_plain(cuda, n_valid):
    g = torch.Generator(device=cuda).manual_seed(n_valid)
    bh, grp, s, d = 16, 7, 2048, 64
    q = torch.randn(bh, grp, d, generator=g, device=cuda)
    k = torch.randn(bh, s, d, generator=g, device=cuda) * 2
    v = torch.randn(bh, s, d, generator=g, device=cuda)
    k_q, k_s, v_q, v_s = ops.prepare_kv_int8(k, v)
    before = decode_attention_int8kv.launches
    got = decode_attention_int8kv(q, k_q, k_s, v_q, v_s, n_valid, d ** -0.5)
    want = ref.decode_attention_int8kv_ref(q, k_q, k_s, v_q, v_s, n_valid,
                                           d ** -0.5)
    assert decode_attention_int8kv.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # tokens past n_valid are never read: garbage there changes nothing
    k_q[:, n_valid:] = 127
    v_s[:, n_valid:] = float("nan")
    again = decode_attention_int8kv(q, k_q, k_s, v_q, v_s, n_valid,
                                    d ** -0.5)
    assert torch.equal(again, got)


@pytest.mark.parametrize("grp,s,n_valid", [(1, 512, 512), (1, 2048, 129),
                                            (7, 1024, 64), (7, 1024, 1)])
def test_decode_attention_int8kv_shapes(cuda, grp, s, n_valid):
    """g = 1 (the TPU kernel's own layout) and the LM decode's 1,024-token
    cache at its last greedy position: one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(s + n_valid)
    q = torch.randn(16, grp, 64, generator=g, device=cuda)
    k, v = (torch.randn(16, s, 64, generator=g, device=cuda)
            for _ in range(2))
    kv = ops.prepare_kv_int8(k, v)
    before = decode_attention_int8kv.launches
    got = decode_attention_int8kv(q, *kv, n_valid, 0.125)
    assert decode_attention_int8kv.launches == before + 1
    torch.testing.assert_close(
        got, ref.decode_attention_int8kv_ref(q, *kv, n_valid, 0.125),
        rtol=1e-5, atol=1e-5)
    # the same call again: the split combine's tickets were reset
    assert torch.equal(decode_attention_int8kv(q, *kv, n_valid, 0.125), got)


def test_decode_attention_int8kv_rejects_unsupported(cuda):
    q = torch.randn(2, 4, 32, device=cuda)
    kv = ops.prepare_kv_int8(torch.randn(2, 8, 32, device=cuda),
                             torch.randn(2, 8, 32, device=cuda))
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention_int8kv(q, *kv, 8, 0.25)
    q = torch.randn(2, 17, 64, device=cuda)
    kv = ops.prepare_kv_int8(torch.randn(2, 8, 64, device=cuda),
                             torch.randn(2, 8, 64, device=cuda))
    with pytest.raises(ValueError, match="group"):
        decode_attention_int8kv(q, *kv, 8, 0.25)


def test_decode_attention_int8kv_wide_heads(cuda):
    """llama3.2-3b's grouping (g=3, hd=128), a group wide enough to need
    more than 48 KB of shared memory (g=16, hd=128), and the smoke
    configs' head_dim 8 (g=7)."""
    for grp, hd in ((3, 128), (16, 128), (7, 8)):
        g = torch.Generator(device=cuda).manual_seed(grp)
        q = torch.randn(4, grp, hd, generator=g, device=cuda)
        k, v = (torch.randn(4, 300, hd, generator=g, device=cuda)
                for _ in range(2))
        kv = ops.prepare_kv_int8(k, v)
        torch.testing.assert_close(
            decode_attention_int8kv(q, *kv, 300, 0.125),
            ref.decode_attention_int8kv_ref(q, *kv, 300, 0.125),
            rtol=1e-5, atol=1e-5)


def test_lm_decode_on_card_matches_cpu_plain_path(cuda):
    """qwen2's smoke config (float32, int8 KV, W8 weights): the same
    weights decode the same tokens on the card (K5's KV write and K6
    launched on every layer, the (M, K) act-quant entry never) and on the
    CPU (plain versions)."""
    cfg = serve.lm_config("qwen2-0.5b", smoke=True, quant="serve_w8a8",
                          kv_quant=True)
    lm = {dev: serve.build_lm(cfg, seed=0, device=dev)
          for dev in (cuda, "cpu")}
    caches = {dev: init_cache(cfg, 3, 16, dev) for dev in lm}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(8, 3, 1)))
    before = (kv_append_int8.launches, decode_attention_int8kv.launches,
              act_quant.launches)
    for i in range(8):
        out = {dev: serve.decode(lm[dev], caches[dev], toks[i].to(
            lm[dev].device), i).cpu() for dev in lm}
        torch.testing.assert_close(
            out[cuda], out["cpu"], rtol=0,
            atol=1e-4 * float(out["cpu"].abs().max()))
    assert kv_append_int8.launches - before[0] == 8 * cfg.n_layers
    assert decode_attention_int8kv.launches - before[1] == 8 * cfg.n_layers
    assert act_quant.launches == before[2]
    # the K/V rows come out of matmuls summed in other orders, so a code
    # at a rounding boundary may move by one
    diff = (caches[cuda]["blocks"]["k_q"].cpu().int()
            - caches["cpu"]["blocks"]["k_q"].int()).abs()
    assert int(diff.max()) <= 1


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "nemotron-4-15b"])
def test_lm_prefill_and_int4_decode_on_card_match_cpu(cuda, arch):
    """The prefill (float32 smoke config, W8 weights) on the card against
    the CPU, with no kernel of the port launched; then the int4-KV decode
    of the same prompt, card against CPU (a plain path: no launch)."""
    cfg = dataclasses.replace(serve.lm_config(
        arch, smoke=True, quant="serve_w8a8", kv_quant=True), kv_bits=4)
    lm = {dev: serve.build_lm(cfg, seed=0, device=dev)
          for dev in (cuda, "cpu")}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(3, 16)))
    before = (kv_append_int8.launches, decode_attention_int8kv.launches,
              act_quant.launches)
    full = {dev: steps.make_prefill_step(cfg)(
        lm[dev].params, {"tokens": toks.to(lm[dev].device)}).cpu()
        for dev in lm}
    torch.testing.assert_close(full[cuda], full["cpu"], rtol=0,
                               atol=1e-4 * float(full["cpu"].abs().max()))
    caches = {dev: init_cache(cfg, 3, 16, dev) for dev in lm}
    for i in range(16):
        out = {dev: serve.decode(lm[dev], caches[dev], toks[:, i:i + 1].to(
            lm[dev].device), i).cpu() for dev in lm}
        torch.testing.assert_close(
            out[cuda], out["cpu"], rtol=0,
            atol=1e-4 * float(out["cpu"].abs().max()))
    assert (kv_append_int8.launches, decode_attention_int8kv.launches,
            act_quant.launches) == before


SERVER_CFG = So3kratesConfig(feat=16, vec_feat=4, n_layers=2, n_rbf=4,
                             dir_bits=6, cutoff=3.0)
SERVER_SERVE = ServeConfig(mode="w4a8", path="sparse", bucket_sizes=(16, 32),
                           max_batch=8, mddq_kernel=True)


def _server_artifact(tmp_path):
    path = str(tmp_path / "model.npz")
    src = QuantizedEngine.from_config(SERVER_CFG, serve=SERVER_SERVE,
                                      device="cpu")
    save_artifact(path, src)
    return path, src


def _server_traffic(n=24):
    return make_traffic(TrafficConfig(
        rate_rps=200.0, n_requests=n, seed=1,
        size_mix=(SizeClass(4, 16, 0.5), SizeClass(17, 32, 0.5))))


def test_artifact_loads_onto_card_byte_identical(cuda, tmp_path):
    path, src = _server_artifact(tmp_path)
    card = load_engine(path, device=cuda)
    assert card.artifact_version == load_artifact(path).version_tag
    for name, v in src.qparams.items():
        w = card.qparams[name]
        if isinstance(v, QTensor):
            pairs = [(v.data, w.data)] + ([(v.scale, w.scale)]
                                          if v.scale is not None else [])
        else:
            pairs = [(v, w)]
        for a, b in pairs:
            assert b.device == cuda and b.dtype == a.dtype
            assert torch.equal(a, b.cpu()), name


def test_scheduler_on_card_resolves_and_launches(cuda, tmp_path):
    """Every handle resolves, and the flushes (on the scheduler's worker
    thread) launched the SO3 kernels and nothing else."""
    path, _ = _server_artifact(tmp_path)
    eng = load_engine(path, device=cuda)
    counters = (w8a8_matmul_f32a, w4a8_matmul_f32a, edge_softmax_fused,
                mddq_encode_kernel)
    others = (act_quant, kv_append_int8, w8a8_matmul, w4a8_matmul,
              decode_attention_int8kv)
    with MicroBatchScheduler(eng, SchedulerConfig(max_batch=8,
                                                  deadline_ms=5.0)) as sched:
        before = [c.launches for c in counters]
        quiet = [c.launches for c in others]
        res = run_open_loop(sched, _server_traffic(), result_timeout=60)
        stats = sched.stats()
    assert res.summary()["n_requests"] == 24 and res.n_shed == 0
    assert stats["n_completed"] == 24
    assert all(c.launches > b for c, b in zip(counters, before))
    assert [c.launches for c in others] == quiet


def test_scheduler_on_card_matches_cpu_plain_path(cuda, tmp_path):
    path, _ = _server_artifact(tmp_path)
    card = load_engine(path, device=cuda)
    cpu = load_engine(path, device="cpu")
    graphs = [g for _, g in _server_traffic(16)]
    with MicroBatchScheduler(card, SchedulerConfig(max_batch=8,
                                                   deadline_ms=5.0)) as sched:
        handles = [sched.submit(g) for g in graphs]
        served = [h.result(timeout=60) for h in handles]
    plain = cpu.infer_batch(graphs)
    f_scale = max(float(np.abs(r.forces).max()) for r in plain)
    for a, b in zip(served, plain):
        assert abs(a.energy - b.energy) <= 1e-4 * max(abs(b.energy), 1.0)
        assert float(np.abs(a.forces - b.forces).max()) <= 1e-4 * f_scale


# -- the cluster and MD sessions on one card ---------------------------------

def _card_pool(cuda, n=2, **kw):
    from repro_torch.cluster import ClusterConfig, ClusterPool
    return ClusterPool.from_config(
        SERVER_CFG, serve=SERVER_SERVE, device=cuda,
        cluster=ClusterConfig(n_replicas=n, max_batch=8, deadline_ms=5.0,
                              **kw))


def test_cluster_on_card_matches_direct_engine(cuda):
    """A 2-replica pool on cuda:0 answers as the direct engine on the
    same weights: energies equal, forces within 1e-5 of the largest
    |force| (the backward's atomic sums run in any order)."""
    graphs = [g for _, g in _server_traffic(16)]
    with _card_pool(cuda) as pool:
        direct = QuantizedEngine.from_quantized(
            SERVER_CFG, pool._replicas[0].engine.qparams, SERVER_SERVE,
            device=cuda)
        served = pool.infer(graphs, timeout_s=60)
    for g, r in zip(graphs, served):
        (d,) = direct.infer_batch([g])
        f_scale = max(float(np.abs(d.forces).max()), 1e-12)
        assert r.energy == d.energy
        assert float(np.abs(r.forces - d.forces).max()) <= 1e-5 * f_scale


def test_cluster_replicas_launch_on_their_own_streams(cuda):
    """Each replica's worker runs its flushes on its own stream: two
    replicas of one card, two distinct streams, neither the default."""
    from repro_torch.server.scheduler import RequestHandle
    seen = {}
    with _card_pool(cuda) as pool:
        for rep in pool._replicas:
            plain = rep.engine.infer_batch

            def recording(graphs, on_flag=None, rid=rep.replica_id,
                          plain=plain):
                seen.setdefault(rid, set()).add(
                    torch.cuda.current_stream(cuda).cuda_stream)
                return plain(graphs, on_flag=on_flag)
            rep.engine.infer_batch = recording
        g = _server_traffic(1)[0][1]
        for rep in pool._replicas:
            h = RequestHandle(g, 0.0, bucket_capacity=16 if g.n_atoms <= 16
                              else 32)
            assert rep.try_submit(h)
            h.result(timeout=60)
        streams = {r.replica_id: r.stream.cuda_stream for r in pool._replicas}
    assert seen == {rid: {s} for rid, s in streams.items()}
    assert len(set(streams.values())) == 2
    assert torch.cuda.default_stream(cuda).cuda_stream not in streams.values()


def test_cluster_on_card_tallies_launches_by_role(cuda):
    """The replicas' warmup runs and flushes launch the SO3 kernels on
    the card, each tallied under its role: every launch of the window
    belongs to a ``warmup:`` or ``flush:`` role of the pool's tier."""
    from repro_torch.kernels import _launch
    counters = (w8a8_matmul_f32a, w4a8_matmul_f32a, edge_softmax_fused,
                mddq_encode_kernel)
    before = [c.launches for c in counters]
    _launch.reset_role_launches()
    with _card_pool(cuda) as pool:
        for rep in pool._replicas:
            assert rep.ready.wait(120)
        pool.infer([g for _, g in _server_traffic(8)], timeout_s=60)
        roles = _launch.role_launches()
    mode = SERVER_SERVE.mode
    assert set(roles) == {f"warmup:{mode}", f"flush:{mode}"}
    for c, b in zip(counters, before):
        assert sum(t.get(c.__name__, 0) for t in roles.values()) \
            == c.launches - b
    assert all(roles[f"flush:{mode}"].get(c.__name__, 0) > 0
               for c in counters)


def test_cluster_rolling_swap_on_card_drops_nothing(cuda, tmp_path):
    import threading
    import time
    path = str(tmp_path / "v2.npz")
    save_artifact(path, QuantizedEngine.from_config(
        SERVER_CFG, serve=SERVER_SERVE, seed=99, device="cpu"))
    graphs = [g for _, g in _server_traffic(64)]
    done, errors = [], []
    with _card_pool(cuda) as pool:
        def client():
            for g in graphs:
                try:
                    done.append(pool.submit(g).result(timeout=60))
                except BaseException as e:     # every request must land
                    errors.append(e)
                time.sleep(0.005)
        t = threading.Thread(target=client)
        t.start()
        report = pool.swap_artifact(path)
        t.join()
        after = pool.infer(graphs[:4], timeout_s=60)
    assert not errors and len(done) == len(graphs)
    assert len(report["replicas"]) == 2
    assert {r.artifact_version for r in after} == {report["version_tag"]}
    assert {r.artifact_version for r in done} <= {"", report["version_tag"]}


def test_session_chunk_failed_over_on_card_reemits_frames(cuda, tmp_path):
    """An in-flight kill of the session's replica: the chunk fails over
    and the trajectory streams every frame index once, in order."""
    from repro_torch.md import MDConfig
    from repro_torch.sessions import (FaultInjector, FaultSpec,
                                      SessionConfig, SessionManager)
    rng = np.random.default_rng(17)
    n = 12
    species = rng.integers(0, SERVER_CFG.n_species, n).astype(np.int32)
    coords = rng.uniform(0, (n / 0.1) ** (1 / 3), (n, 3)).astype(np.float32)
    with _card_pool(cuda) as pool:
        faults = FaultInjector([FaultSpec(kind="kill_replica", at_chunk=2,
                                          mode="in_flight")], pool)
        mgr = SessionManager(pool, str(tmp_path), faults=faults)
        s = mgr.start(species, coords, np.full(n, 12.0, np.float32), seed=4,
                      config=SessionConfig(
                          n_steps=100, chunk_steps=20, record_every=10,
                          checkpoint_every=2,
                          md=MDConfig(mode="w4a8", dt_fs=0.25,
                                      record_every=10, mddq_kernel=True)))
        assert s.wait(300) == "done"
        st = pool.stats()
        mgr.close()
    assert [f.index for f in s.collected] == list(range(10))
    assert all(np.isfinite(f.e_tot).all() for f in s.collected)
    assert faults.counts()["kill_replica"] == 1
    assert st["n_live"] == 1
    assert st["chunks"]["n_requeued"] + s.n_retries >= 1


def _qat_codes(rec_into):
    """Patch the QAT model's quantizers to record each site's A8 code and
    clip gate (x / scale, rounded and compared with qmax) and MDDQ codes,
    as CPU tensors; returns the restore function."""
    from repro_torch.core.mddq import mddq_encode
    from repro_torch.models import so3krates as so3
    qact, qvec = so3._qact, so3._qvec

    def rec_act(x, cfg, degrees=None, nested=False):
        y = (x.detach() / so3._act_scale(x, cfg, degrees)).cpu()
        rec_into.append(torch.stack([y.clamp(-127, 127).round(),
                                     (y.abs() < 127).float()
                                     + 0.5 * (y.abs() == 127).float()]))
        return qact(x, cfg, degrees, nested)

    def rec_vec(v, cfg, codebook, nested=False):
        if not cfg.freeze_vec_quant:
            with torch.no_grad():
                rec_into.extend(c.cpu() for c in mddq_encode(
                    v.detach(), cfg.mddq(), codebook))
        return qvec(v, cfg, codebook, nested)
    so3._qact, so3._qvec = rec_act, rec_vec

    def restore():
        so3._qact, so3._qvec = qact, qvec
    return restore


def test_qat_step_on_card_matches_cpu(cuda):
    """One full gaq_w4a8 QAT step (force loss, LEE term over 2 rotations,
    second-order backward) on the card against the CPU plain path, same
    weights, batch and rotations: the loss to 1e-4 relative and every
    gradient leaf to 1e-4 of its largest |g|, or, past that, an A8 code or
    clip gate or an MDDQ code that moved between the devices. On the
    card the step launches the MDDQ encode L x (1 + 2 x 2) times and no
    other kernel."""
    from repro_torch.core.codebook import make_codebook
    from repro_torch.core.lee import random_rotations
    from repro_torch.data.synthetic_md import sample_dataset
    from repro_torch.models import so3krates as so3
    from repro_torch.training import so3_trainer as tr
    cfg = so3.So3kratesConfig(feat=16, vec_feat=4, n_layers=2, n_rbf=8,
                              dir_bits=12, quant="gaq_w4a8")
    tcfg = tr.TrainConfig(lee_weight=1.0, lee_rotations=2)
    data = sample_dataset(0, 4, device="cpu")
    params = so3.init_params(cfg, 0, "cpu")
    rots = random_rotations(1, 2)
    counters = [mddq_encode_kernel, w8a8_matmul_f32a, w4a8_matmul_f32a,
                edge_softmax_fused, act_quant]

    def step(dev, codes=None):
        loss_fn = tr.make_loss_fn(cfg, data["species"].to(dev),
                                  make_codebook(12, device=dev), tcfg)
        batch = [data[k].to(dev) for k in ("coords", "energy", "forces")]
        restore = _qat_codes(codes) if codes is not None else None
        try:
            return tr.loss_and_grads(
                loss_fn, {k: v.to(dev) for k, v in params.items()}, *batch,
                rots)
        finally:
            if restore:
                restore()
    for c in counters:
        c.launches = 0
    (lc, _, gc) = step(cuda)
    assert mddq_encode_kernel.launches == 2 * (1 + 2 * 2)
    assert all(c.launches == 0 for c in counters[1:])
    (lh, _, gh) = step(torch.device("cpu"))
    rel = abs(float(lc) - float(lh)) / abs(float(lh))
    worst = max(float((gc[k].cpu() - gh[k]).abs().max()
                      / gh[k].abs().max().clamp(min=1e-30)) for k in gh)
    if rel > 1e-4 or worst > 1e-4:
        codes = {"cuda": [], "cpu": []}
        step(cuda, codes["cuda"])
        step(torch.device("cpu"), codes["cpu"])
        moved = sum(int((a != b).sum()) for a, b in zip(codes["cuda"],
                                                         codes["cpu"]))
        assert moved > 0, (rel, worst)


# --- captured programs (CUDA graphs) and the device position -----------------

@pytest.mark.parametrize("cur", [0, 7, 15])
def test_kv_append_int8_device_position(cuda, cur):
    """K5's KV entry reading its position from device memory: the whole
    cache byte for byte against the plain version at the int position."""
    g = torch.Generator(device=cuda).manual_seed(cur)
    k, v = (torch.randn(3, 2, 64, generator=g, device=cuda)
            for _ in range(2))
    got = [torch.full((3, 2, 16, 64), -128, dtype=torch.int8, device=cuda),
           torch.zeros((3, 2, 16), device=cuda)]
    got = [got[0], got[1], got[0].clone(), got[1].clone()]
    want = [t.clone() for t in got]
    kv_append_int8(k, v, *got,
                   torch.tensor(cur, dtype=torch.int32, device=cuda))
    ref.kv_append_int8_ref(k, v, *want, cur)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("rows,grp,hd,s,n_valid", [
    (16, 7, 64, 1024, 1), (16, 7, 64, 1024, 64), (16, 7, 64, 1024, 1024),
    (8, 8, 128, 288, 37), (16, 8, 128, 1024, 288)])
def test_decode_attention_device_position(cuda, rows, grp, hd, s, n_valid):
    """K6 with the position on the device (the grid sized from S, each
    block the host's plan of the n_valid it reads) within 1e-5 of its
    plain version, and bit for bit the int entry's result."""
    g = torch.Generator(device=cuda).manual_seed(n_valid)
    q = torch.randn(rows, grp, hd, generator=g, device=cuda)
    kv = ops.prepare_kv_int8(
        torch.randn(rows, s, hd, generator=g, device=cuda) * 2,
        torch.randn(rows, s, hd, generator=g, device=cuda))
    pos = torch.tensor(n_valid - 1, dtype=torch.int32, device=cuda)
    got = decode_attention_int8kv(q, *kv, pos, hd ** -0.5)
    want = ref.decode_attention_int8kv_ref(q, *kv, n_valid, hd ** -0.5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # each block takes the host's plan of the n_valid it reads
    assert torch.equal(got, decode_attention_int8kv(q, *kv, n_valid,
                                                    hd ** -0.5))


def test_captured_k6_owns_its_ticket_buffer(cuda):
    """A captured K6 call keeps its split-combine tickets for the life of
    its program: K6 captured at 16 rows (8 live splits), then captured
    and run eagerly at 512 rows on the same thread (a larger ticket
    buffer), with the capture stream's small blocks then filled with
    nonzero words; the first program's replays still equal its eager
    call bit for bit."""
    from repro_torch.captured import CapturedProgram, _capture_stream
    g = torch.Generator(device=cuda).manual_seed(5)

    def inputs(rows):
        kv = ops.prepare_kv_int8(
            torch.randn(rows, 1024, 64, generator=g, device=cuda) * 2,
            torch.randn(rows, 1024, 64, generator=g, device=cuda))
        return {"q": torch.randn(rows, 7, 64, generator=g, device=cuda),
                "kv": kv,
                "pos": torch.tensor(1000, dtype=torch.int32, device=cuda)}

    def fn(q, kv, pos):
        return decode_attention_int8kv(q, *kv, pos, 0.125)
    small, large = inputs(16), inputs(512)
    first = CapturedProgram(fn, small, device=cuda, name="K6 at 16 rows")
    second = CapturedProgram(fn, large, device=cuda, name="K6 at 512 rows")
    want_large = fn(**large)
    with torch.cuda.stream(_capture_stream(torch.device(cuda))):
        junk = [torch.full((256,), 7, dtype=torch.int32, device=cuda)
                for _ in range(256)]
    torch.cuda.synchronize()
    want = fn(**small)
    for _ in range(3):
        assert torch.equal(first.replay(), want)
    assert torch.equal(second.replay(), want_large)
    assert len(junk) == 256


def _spread(runs, i):
    return max(float((a[i] - b[i]).abs().max())
               for a in runs for b in runs)


@pytest.mark.parametrize("path", ["sparse", "dense"])
def test_replayed_so3_batch_matches_eager(cuda, path):
    """The engine's captured program of a batch against its eager
    functions on the same padded batch: energies bit for bit (the forward
    sums in a fixed order), forces within twice the largest gap between
    five eager runs (the sparse backward's index_add sums with atomics)."""
    from repro_torch.serving import pad_graphs, plan_batches
    cfg = So3kratesConfig(feat=16, vec_feat=4, n_layers=2, n_rbf=4,
                          dir_bits=6, cutoff=3.0)
    eng = QuantizedEngine.from_config(cfg, serve=ServeConfig(
        mode="w4a8", path=path, bucket_sizes=(16,), max_batch=4,
        mddq_kernel=True), device=cuda)
    eng.warmup()
    assert eng.compiled_shapes == eng.shapes_seen and eng._programs
    graphs = random_graphs(4, 6, 14, cfg.n_species, seed=2)
    plan = plan_batches(graphs, eng.serve.buckets())[0]
    sp, co, mask = pad_graphs(graphs, plan)
    if path == "sparse":
        el = build_edge_list(co, mask, cfg.cutoff, plan.bucket.edges)
        run = lambda: eng._run_sparse(sp, co, mask, el)  # noqa: E731
    else:
        run = lambda: eng._run_dense(sp, co, mask)  # noqa: E731
    replayed = [t.cpu() for t in run()]
    eager = []
    for _ in range(5):
        eng._run = eng._eager_run
        try:
            eager.append([t.cpu() for t in run()])
        finally:
            del eng._run
    assert torch.equal(replayed[0], eager[0][0])
    assert float((replayed[1] - eager[0][1]).abs().max()) \
        <= 2 * _spread(eager, 1)
    shapes = set(eng.compiled_shapes)
    eng.infer_batch(graphs)
    assert eng.compiled_shapes == shapes


def test_replayed_md_segment_matches_eager(cuda):
    cfg = So3kratesConfig(feat=16, vec_feat=4, n_layers=2, n_rbf=4,
                          dir_bits=6, cutoff=3.0)
    rng = np.random.default_rng(5)
    sp = rng.integers(0, cfg.n_species, 20).astype(np.int32)
    co = rng.uniform(0, (20 / 0.1) ** (1 / 3), size=(20, 3)).astype(
        np.float32)
    spec, coords, mask = pad_replicas(sp, co, 2)
    masses = np.full(20, 12.0, np.float32)
    eng = MDEngine(cfg, md=MDConfig(mode="w8a8", dt_fs=0.25, skin=0.1,
                                    quant_vectors=False), device=cuda)
    st = eng.init_state(3, spec, coords, mask, masses, 300.0)
    s_t, m_t, ms_t = eng.device_inputs(spec, mask, masses)
    eng._captured_segment(st, s_t, m_t, ms_t, 5)             # captures
    assert len(eng._programs) == 1

    def out(res):
        new, rec = res
        return [new.coords.cpu(), rec["e_tot"].cpu()]
    replayed = out(eng._captured_segment(st, s_t, m_t, ms_t, 5))
    eager = [out(eng._segment(st, s_t, m_t, ms_t, 5)) for _ in range(3)]
    for i in range(2):
        scale = float(eager[0][i].abs().max())
        gap = float((replayed[i] - eager[0][i]).abs().max())
        spread = max(_spread(eager, j) / float(eager[0][j].abs().max())
                     for j in range(2))
        assert gap <= 2 * spread * scale
    # run() replays, and hands back a state of its own
    st2, rec = eng.run(st, spec, mask, masses, n_steps=10, record_every=5)
    prog = next(iter(eng._programs.values()))
    assert st2.coords.data_ptr() != prog.static["state"].coords.data_ptr()
    assert np.isfinite(rec["e_tot"]).all()


def test_replayed_decode_step_matches_eager(cuda):
    """The captured greedy decode (the step at a device position, lm_head
    and the argmax into the static ids) against the eager loop: the same
    tokens and, bit for bit, the same cache."""
    cfg = serve.lm_config("qwen2-0.5b", smoke=True, quant="serve_w8a8",
                          kv_quant=True)
    lm = serve.build_lm(cfg, seed=0, device=cuda)
    caches = [init_cache(cfg, 3, 16, cuda) for _ in range(3)]
    before = kv_append_int8.launches
    runs = [serve.greedy_decode(lm, 3, 16, 12, cache=caches[0]),
            serve.greedy_decode_eager(lm, 3, 16, 12, cache=caches[1]),
            serve.greedy_decode(lm, 3, 16, 12, cache=caches[2])]
    assert (3, 16) in lm.programs
    assert all(torch.equal(r.tokens, runs[0].tokens) for r in runs)
    for c in caches[1:]:
        for name in ("k_q", "k_s", "v_q", "v_s"):
            assert torch.equal(c["blocks"][name], caches[0]["blocks"][name])
    # every step launches once per layer, captured or not
    assert kv_append_int8.launches - before == 3 * 12 * cfg.n_layers


def test_replay_launches_match_the_profiler(cuda):
    """One replayed decode step: the launches the capture recorded equal
    the profiler's kernels by name, and a replay adds them to the
    counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = serve.lm_config("qwen2-0.5b", smoke=True, quant="serve_w8a8",
                          kv_quant=True)
    lm = serve.build_lm(cfg, seed=0, device=cuda)
    serve.greedy_decode(lm, 2, 8, 3)
    prog = lm.programs[(2, 8)]
    counts = prog.launch_counts()
    assert counts["kv_append_int8"] == counts[
        "decode_attention_int8kv"] == cfg.n_layers
    before = decode_attention_int8kv.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prog.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert sum("kv_append_kernel" in n for n in names) == cfg.n_layers
    assert sum("decode_kernel<" in n for n in names) == cfg.n_layers
    assert decode_attention_int8kv.launches - before == cfg.n_layers


# --- the training programs, captured (CUDA graphs) ---------------------------

def _hold(replayed, eager):
    """Each output of a replay against five eager runs of the same inputs
    from the same state: bit for bit where the eager runs agree bit for
    bit, else within twice their largest gap."""
    for i, r in enumerate(replayed):
        spread = _spread(eager, i)
        if spread == 0:
            assert torch.equal(r, eager[0][i]), i
        else:
            assert float((r - eager[0][i]).abs().max()) <= 2 * spread, i


def _replay_against_eager(progs, key, body, state0, **inputs):
    """The program of ``key`` replayed from ``state0`` and ``body`` run
    eagerly five times from it, each run's outputs and new state on the
    host."""
    from torch.distributed.tensor import DTensor
    from repro_torch.captured import copy_into, tree_tensors

    def run(fn):
        copy_into(progs.state, state0)
        out = fn(**inputs)
        return [(t.full_tensor() if isinstance(t, DTensor) else t)
                .detach().cpu().clone()
                for t in tree_tensors(out) + tree_tensors(progs.state)]
    progs.run(key, body, **inputs)                       # captures
    replayed = run(lambda **kw: progs.run(key, body, **kw))
    eager = [run(lambda **kw: body(state=progs.state, **kw))
             for _ in range(5)]
    return replayed, eager


def _profiled_band_kernels(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum("band_kernel" in e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA)


def test_replayed_so3_qat_step_matches_eager(cuda):
    """A full QAT step (three layers, the LEE term over two rotations)
    captured and replayed: its loss and new parameters and AdamW state
    against five eager runs of the body from the same state; K4 launched
    L x (1 + 2 x 2) = 15 times per step, by the capture's tally and by
    the profiler over one replay."""
    import functools
    from repro_torch.captured import Programs, clone_tree
    from repro_torch.core.lee import random_rotations
    from repro_torch.data.synthetic_md import sample_dataset_md
    from repro_torch.models import so3krates as so3
    from repro_torch.training import so3_trainer as tr
    cfg = So3kratesConfig(feat=16, vec_feat=4, n_layers=3, n_rbf=8,
                          dir_bits=8, quant="gaq_w4a8")
    data = sample_dataset_md(0, 8, device=cuda)
    tcfg = tr.TrainConfig(batch_size=4, lee_weight=1.0, lee_rotations=2)
    params = so3.init_params(cfg, 0, cuda)
    opt = tr.make_optimizer(tcfg, 10)
    body = functools.partial(tr.step_body, tr.make_loss_fn(
        cfg, data["species"], make_codebook(8, device=cuda), tcfg), opt,
        data)
    state0 = clone_tree((params, opt.init(params)))
    progs = Programs(device=cuda, name="a QAT step", state=clone_tree(
        state0))
    inputs = dict(idx=torch.tensor([5, 0, 2, 7], device=cuda),
                  rotations=torch.as_tensor(random_rotations(1, 2),
                                            device=cuda))
    replayed, eager = _replay_against_eager(progs, "full", body, state0,
                                            **inputs)
    _hold(replayed, eager)
    prog = progs.programs["full"]
    assert prog.launch_counts()["mddq_encode_kernel"] == 15
    before = mddq_encode_kernel.launches
    assert _profiled_band_kernels(prog.replay) == 15
    assert mddq_encode_kernel.launches - before == 15


def test_replayed_nve_segment_matches_eager(cuda):
    """A 5-step NVE segment of a quantized model (the pipeline's NVE
    body) captured and replayed: the state and the energy record against
    five eager runs from the same state; ``nve_trajectory`` on the card
    gives finite records of its length."""
    from repro_torch.captured import Programs, clone_tree
    from repro_torch.data.synthetic_md import MASSES, make_ff
    from repro_torch.md.nve import init_state, nve_segment, nve_trajectory
    from repro_torch.models import so3krates as so3
    cfg = So3kratesConfig(feat=16, vec_feat=4, n_layers=2, n_rbf=8,
                          dir_bits=8, quant="gaq_w4a8")
    params = so3.init_params(cfg, 0, cuda)
    eq, species, _ = make_ff(cuda)
    cb = make_codebook(8, device=cuda)
    masses = torch.tensor(MASSES, device=cuda)

    def force_fn(c):
        return so3.forces(params, cfg, species, c, cb)

    def energy_fn(c):
        with torch.no_grad():
            return so3.energy(params, cfg, species, c, cb)
    state0 = init_state(7, eq, masses, force_fn, 300.0)

    def body(state):
        return nve_segment(state, masses, force_fn, energy_fn, 0.5, 5)
    progs = Programs(device=cuda, name="an NVE segment",
                     state=clone_tree(state0))
    _hold(*_replay_against_eager(progs, 5, body, state0))
    _, e = nve_trajectory(state0, masses, force_fn, energy_fn, 0.5, 12, 5)
    assert e.shape == (3,) and bool(torch.isfinite(e).all())


def test_replayed_launcher_step_matches_eager(cuda):
    """The launcher's qat_w4a8 + ef8 step (float32 smoke config) on the
    local (1, 1) mesh, DTensor state and batch, captured and replayed:
    its loss and new state against five eager runs from the same state;
    no kernel of the port launched."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.captured import Programs, clone_tree
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.lm.config import ShapeCell
    from repro_torch.models.lm.transformer import init_lm
    from repro_torch.optim.compression import ef_init
    from repro_torch.tools.lm_train_gap import launcher_optimizer
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-0.5b"),
                              quant_mode="qat_w4a8", dtype=torch.float32)
    opt = launcher_optimizer(10)
    mesh = make_local_mesh(cuda)
    try:
        params = init_lm(cfg, seed=0, device=cuda)
        params = shd.place(params, shd.to_shardings(
            shd.param_specs(params, cfg, mesh), mesh))
        b_sh = shd.to_shardings(shd.batch_specs(
            cfg, ShapeCell("custom", 32, 2, "train"), mesh), mesh)
        it = synthetic_token_batches(cfg, 2, 32, seed=17)
        batch = {k: distribute_tensor(torch.from_numpy(v).to(cuda), mesh,
                                      b_sh[k].placements)
                 for k, v in next(it).items()}
        it.close()
        state0 = clone_tree((params, opt.init(params), ef_init(params)))
        progs = Programs(device=cuda, name="the launcher's step",
                         state=clone_tree(state0))
        before = {fn.__name__: fn.launches for fn in (
            mddq_encode_kernel, w8a8_matmul_f32a, w4a8_matmul_f32a,
            edge_softmax_fused, kv_append_int8, decode_attention_int8kv)}
        with implicit_replication():
            replayed, eager = _replay_against_eager(
                progs, "step", train.make_body(cfg, opt, True), state0,
                batch=batch)
        _hold(replayed, eager)
        assert progs.programs["step"].launch_counts() == {}
        assert before == {fn.__name__: fn.launches for fn in (
            mddq_encode_kernel, w8a8_matmul_f32a, w4a8_matmul_f32a,
            edge_softmax_fused, kv_append_int8, decode_attention_int8kv)}
    finally:
        dist.destroy_process_group()


def test_replayed_md_frame_matches_eager(cuda):
    """The training set's classical-MD frame (40 velocity-Verlet steps of
    the classical force field, its forces by autograd) captured and
    replayed: the state (r, v, f) after it against five eager runs of the
    body from the same state. The three leaves are one trajectory's
    state, so each leaf's gap over its largest |value| is held within
    twice the largest such spread of the eager runs over the three (bit
    for bit if no eager leaf differs): a position can round alike in five
    eager runs whose forces, summed with atomics, differ."""
    from repro_torch.data.synthetic_md import frame_sampler
    from repro_torch.md.nve import init_state
    s = frame_sampler(cuda)
    state0 = tuple(init_state(0, s.eq, s.masses, s.ff.forces, 300.0))
    with s.lock:
        replayed, eager = _replay_against_eager(
            s.programs, (24, 40, 0.5), s.body(40, 0.5), state0)

    def rel(a, i):
        return float((a - eager[0][i]).abs().max()
                     / eager[0][i].abs().max())
    spread = max(_spread(eager, i) / float(eager[0][i].abs().max())
                 for i in range(3))
    for i, r in enumerate(replayed):
        if spread == 0:
            assert torch.equal(r, eager[0][i]), i
        else:
            assert rel(r, i) <= 2 * spread, (i, rel(r, i), spread)


def test_md_frames_capture_once_per_atom_count_and_stride(cuda):
    """``sample_dataset_md`` on the card captures one frame program per
    (atom count, stride, dt), kept across calls and seeds; what it
    returns is finite and carries no autograd graph, though it is called
    under ``enable_grad``."""
    from repro_torch.data.synthetic_md import frame_sampler, sample_dataset_md
    s = frame_sampler(cuda)
    with torch.enable_grad():
        a = sample_dataset_md(0, 3, stride=4, device=cuda)
    prog = s.programs.programs[(24, 4, 0.5)]
    b = sample_dataset_md(1, 5, stride=4, device=cuda)
    c = sample_dataset_md(0, 2, stride=3, device=cuda)
    assert s.programs.programs[(24, 4, 0.5)] is prog
    assert {(24, 3, 0.5), (24, 4, 0.5)} <= set(s.programs.programs)
    for d, n in ((a, 3), (b, 5), (c, 2)):
        assert d["coords"].shape == (n, 24, 3)
        for k in ("coords", "energy", "forces"):
            assert bool(torch.isfinite(d[k]).all()), k
            assert not d[k].requires_grad and d[k].grad_fn is None
    for t in s.programs.state:
        assert not t.requires_grad and t.grad_fn is None
