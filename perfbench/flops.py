"""Model FLOPs of the So3krates force field, counted from its widths and
the real atoms and edges of a call (a multiply-add counts 2).

``matmul_flops`` is the forward's matrix products as the reference
writes them: per layer the five projections of the layer-normed
features, the four radial products on the edges, the update MLP and the
vector-norm feedback, then the readout. ``edge_flops`` is the forward's
elementwise work on the edges (logits, gated messages, both equivariant
terms). A force call (energy, then forces by the input gradient) is
counted as twice the forward; a QAT step's energy-and-force loss, whose
parameter gradient differentiates the force pass again, as six times.
"""
from __future__ import annotations


def matmul_flops(dims, atoms: int, edges: int) -> float:
    F, Fv, K, L = dims.feat, dims.vec_feat, dims.n_rbf, dims.n_layers
    N, E = atoms, edges
    layer = (2 * N * F * (3 * F + 2 * Fv)        # q, k, msg, a, b
             + 2 * E * K * (1 + F + 2 * Fv)      # bias, gate, a/b gates
             + 2 * 2 * N * F * F                 # update MLP
             + 2 * N * Fv * F)                   # vector-norm feedback
    return L * layer + 2 * N * (F + Fv) * F + 2 * N * F


def edge_flops(dims, edges: int) -> float:
    F, Fv = dims.feat, dims.vec_feat
    return dims.n_layers * edges * (2 * F + 2 * F + 4 * Fv + 9 * Fv)


def forward_flops(dims, atoms: int, edges: int) -> float:
    return matmul_flops(dims, atoms, edges) + edge_flops(dims, edges)


def window_flops(dims, forwards, units: int) -> float:
    """FLOPs of ``units`` units of work, each running ``forwards``
    (dicts with atoms, edges, calls (default 1) and factor: 2 for a
    force call, 6 for a QAT loss)."""
    per_unit = sum(f.get("calls", 1) * f["factor"]
                   * forward_flops(dims, f["atoms"], f["edges"])
                   for f in forwards)
    return per_unit * units
