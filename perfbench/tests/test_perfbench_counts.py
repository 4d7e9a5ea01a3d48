"""The model-FLOP and roofline counts against hand counts at small
shapes, and the forward's matrix products against
``torch.utils.flop_counter.FlopCounterMode`` over the reference."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops, peaks
from perfbench.common import load_module, make_params
from perfbench.reference import so3krates as ref

DIMS = ref.ModelDims(feat=8, vec_feat=2, n_layers=2, n_rbf=3, cutoff=3.0)


def test_matmul_flops_by_hand():
    F, Fv, K, L, N, E = 8, 2, 3, 2, 5, 12
    layer = (2 * N * F * F * 3 + 2 * N * F * Fv * 2 + 2 * E * K
             + 2 * E * K * F + 2 * 2 * E * K * Fv + 2 * 2 * N * F * F
             + 2 * N * Fv * F)
    want = L * layer + 2 * N * (F + Fv) * F + 2 * N * F
    assert flops.matmul_flops(DIMS, N, E) == want
    assert flops.edge_flops(DIMS, E) == L * E * (4 * F + 13 * Fv)
    fwd = [{"atoms": N, "edges": E, "factor": 2},
           {"atoms": 1, "edges": 0, "factor": 6, "calls": 3}]
    assert flops.window_flops(DIMS, fwd, 7) == 7 * (
        2 * flops.forward_flops(DIMS, N, E)
        + 18 * flops.forward_flops(DIMS, 1, 0))


@pytest.mark.parametrize("mode", ["fp32", "w4a8"])
def test_matmul_flops_equal_the_flop_counter(mode):
    torch.manual_seed(0)
    params = make_params(DIMS, 3, torch.device("cpu"))
    quant = ref.Quant(mode=mode, dir_bits=6)
    weights = ref.served_weights(params, DIMS, quant)
    B, n = 2, 6
    coords = torch.rand(B, n, 3) * 3.0
    mask = torch.ones(B, n, dtype=torch.bool)
    mask[1, 4:] = False
    species = torch.randint(0, DIMS.n_species, (B, n))
    edges = ref.cutoff_edges(coords, mask, DIMS.cutoff)
    cb = ref.fibonacci_codebook(6, "cpu")
    with FlopCounterMode(display=False) as counter:
        ref.energy(weights, DIMS, quant, species, coords, mask, edges, cb)
    # the reference runs its projections over every padded row
    assert counter.get_total_flops() == flops.matmul_flops(
        DIMS, B * n, int(edges[0].numel()))


def test_quant_matmul_roofline_by_hand():
    entry = load_module("rooflines", "quant_matmul")
    F, Fv, L, M = 8, 2, 2, 10
    fwd = {"kind": "served", "mode": "w4a8", "atoms": M, "edges": 0}
    n_bytes, ops = entry.work(DIMS, fwd)
    shapes = [(F, 3 * F, 1.0), (F, 2 * Fv, 0.5), (F, F, 1.0), (F, F, 1.0),
              (Fv, F, 1.0)] * L + [(F + Fv, F, 1.0)]
    assert n_bytes == sum(4 * M * k + k * n * b + 4 * n + 4 * M * n
                          for k, n, b in shapes)
    assert ops == {"int8": sum(2 * M * n * k for k, n, _ in shapes),
                   "fp32": sum(4 * M * k for k, _, _ in shapes)}
    assert entry.work(DIMS, dict(fwd, mode="fp32")) is None
    assert entry.work(DIMS, dict(fwd, kind="qat")) is None


def test_edge_softmax_and_mddq_rooflines_by_hand():
    F, Fv, L, N, E = 8, 2, 2, 10, 30
    W = F + 3 * Fv
    es = load_module("rooflines", "edge_softmax")
    n_bytes, ops = es.work(DIMS, {"kind": "served", "atoms": N, "edges": E})
    assert n_bytes == L * (8 * N * F + E * (13 + 4 * W) + 4 * N * W)
    assert ops == {"fp32": L * E * (2 * F + 3 * W + 8)}
    md = load_module("rooflines", "mddq_encode")
    fwd = {"kind": "qat", "atoms": N, "vectors_quantized": True,
           "codebook": 64}
    assert md.work(DIMS, fwd) == (L * (20 * N * Fv + 12 * 64), {})
    assert md.work(DIMS, dict(fwd, vectors_quantized=False)) is None


def test_least_time_takes_the_larger_bound():
    assert peaks.least_time(3.35e12, {}) == pytest.approx(1.0)
    assert peaks.least_time(0, {"int8": 1979e12, "fp32": 67e12}) \
        == pytest.approx(2.0)


def test_shares_divide_by_the_unprofiled_time():
    """Idle share and MFU read a closed-loop driver's traced units against
    the untraced part's seconds a unit, not the profiled window's length;
    an open-loop window (no ``untraced``) keeps its own length."""
    import dataclasses

    from perfbench import reductions
    from perfbench.common import Outcome, Trace
    tr = Trace(kernels=[("k", 0, 30_000_000), ("k", 40_000_000, 30_000_000)],
               host=[], window_s=0.2, units=2)
    fwd = [{"atoms": 5, "edges": 12, "factor": 2}]
    out = Outcome(e2e={}, setup_end=0.0, attempted=0, failed=0,
                  memory_peak_bytes=0, readings={}, trace=tr,
                  counters={"untraced": (0.4, 10), "dims": DIMS,
                            "forwards": fwd, "peak": "fp32"})
    # busy 0.06 s over 2 units that take 0.04 s each unprofiled
    assert reductions.idle_share(out) == pytest.approx(0.25)
    assert reductions.mfu(out) == pytest.approx(
        100 * 10 * 2 * flops.forward_flops(DIMS, 5, 12)
        / (0.4 * peaks.OPS_PER_S["fp32"]))
    open_loop = dataclasses.replace(out, counters={
        k: v for k, v in out.counters.items() if k != "untraced"})
    assert reductions.idle_share(open_loop) == pytest.approx(0.7)
    assert reductions.mfu(open_loop) == pytest.approx(
        100 * 2 * 2 * flops.forward_flops(DIMS, 5, 12)
        / (0.2 * peaks.OPS_PER_S["fp32"]))
    no_untraced_units = dataclasses.replace(out, counters=dict(
        out.counters, untraced=(0.4, 0)))
    assert reductions.idle_share(no_untraced_units) is None
    assert reductions.mfu(no_untraced_units) is None
