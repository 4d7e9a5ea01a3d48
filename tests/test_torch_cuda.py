"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one (a CUDA kernel
has no CPU mode). On the card, with no JAX installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the quantized matmuls and the MDDQ encode codes exactly (the
kernels repeat their plain versions' arithmetic in the same order); the
edge softmax to 1e-5 (its sums run in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.codebook import make_codebook
from repro_torch.kernels import ops, ref
from repro_torch.kernels.edge_softmax import edge_softmax_fused
from repro_torch.kernels.mddq_kernel import mddq_encode_kernel
from repro_torch.kernels.quant_matmul import w4a8_matmul, w8a8_matmul
from repro_torch.models.so3krates import So3kratesConfig
from repro_torch.serving import QuantizedEngine, ServeConfig, random_graphs
from repro_torch.serving.bucketing import build_edge_list

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("m,k,n", [(1, 3, 2), (37, 80, 64), (256, 64, 192),
                                   (130, 100, 66)])
def test_quant_matmul_bit_for_bit(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m)
    a_q, a_s = ops.quantize_activations(
        torch.randn(m, k, generator=g, device=cuda))
    w = torch.randn(k, n, generator=g, device=cuda)
    w8, s8 = ops.prepare_w8(w)
    w4, s4 = ops.prepare_w4(w)
    before = w8a8_matmul.launches
    assert torch.equal(w8a8_matmul(a_q, a_s, w8, s8),
                       ref.w8a8_matmul_ref(a_q, a_s, w8, s8))
    assert torch.equal(w4a8_matmul(a_q, a_s, w4, s4),
                       ref.w4a8_matmul_ref(a_q, a_s, w4, s4))
    assert w8a8_matmul.launches == before + 1


def test_quant_matmul_rejects_bad_arguments(cuda):
    a_q, a_s = ops.quantize_activations(torch.randn(8, 16, device=cuda))
    w, s = ops.prepare_w8(torch.randn(16, 8, device=cuda))
    with pytest.raises(TypeError):
        w8a8_matmul(a_q, a_s, w.to(torch.uint8), s)
    with pytest.raises(ValueError):
        w8a8_matmul(a_q, a_s, w.t().contiguous().t(), s)
    with pytest.raises(ValueError):
        w8a8_matmul(a_q, a_s, w.cpu(), s)


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


def test_engine_on_card_matches_cpu_plain_path(cuda):
    cfg = So3kratesConfig(feat=16, vec_feat=4, n_layers=2, n_rbf=4,
                          dir_bits=6, cutoff=3.0)
    graphs = random_graphs(6, 1, 14, cfg.n_species, seed=0)
    serve = ServeConfig(mode="w4a8", path="sparse", bucket_sizes=(16,),
                        max_batch=8, mddq_kernel=True)
    counters = (w8a8_matmul, w4a8_matmul, edge_softmax_fused,
                mddq_encode_kernel)
    before = [c.launches for c in counters]
    card = QuantizedEngine.from_config(cfg, serve=serve,
                                       device=cuda).infer_batch(graphs)
    assert all(c.launches > b for c, b in zip(counters, before))
    cpu = QuantizedEngine.from_config(cfg, serve=serve,
                                      device="cpu").infer_batch(graphs)
    f_scale = max(float(np.abs(r.forces).max()) for r in cpu)
    for a, b in zip(card, cpu):
        assert abs(a.energy - b.energy) <= 1e-4 * max(abs(b.energy), 1.0)
        assert float(np.abs(a.forces - b.forces).max()) <= 1e-4 * f_scale
