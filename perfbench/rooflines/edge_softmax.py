"""The fused edge softmax (K3: ``edge_softmax_kernel`` in
``kernels/csrc/edge_softmax.cu``, through ``ops.edge_softmax``), one
launch per layer of a served forward: per receiver the softmax of
q . k + bias over its real edges, and the weighted sum of the edges'
values (W = F + 3 Fv: the scalar message and both equivariant terms).
Frozen from ``chip_smoke.py`` (commit dde5d65): q and k read once (2 N F
floats), per real edge its bias, its values row, both indices and its
mask bit, the output written once; E (2 F + 3 W + 8) float32
operations."""

PATTERN = r"edge_softmax_kernel"


def work(dims, fwd):
    if fwd["kind"] != "served":
        return None
    F, Fv, L = dims.feat, dims.vec_feat, dims.n_layers
    W = F + 3 * Fv
    N, E = fwd["atoms"], fwd["edges"]
    n_bytes = 2 * N * F * 4 + E * (4 + 4 * W + 4 + 4 + 1) + N * W * 4
    return L * n_bytes, {"fp32": L * E * (2 * F + 3 * W + 8)}
