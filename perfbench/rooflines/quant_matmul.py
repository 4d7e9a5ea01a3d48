"""The served quantized products (K1/K2: ``qmm_kernel`` in
``kernels/csrc/quant_matmul.cu``, through ``ops.matmul_w8a8`` /
``matmul_w4a8``): y = A8(x) @ W8|W4, float32 x quantized per row inside
the product. Frozen from ``chip_smoke.py`` (commit dde5d65), keyed by
operation: per product, the float32 input read once, the packed weights
and their column scales read once, the float32 output written once;
2 M N K int8 operations and 4 M K float32 ones for the A8 step."""

PATTERN = r"qmm_kernel"


def _products(dims):
    """(K, N, weight bits) of one forward's products, in w4a8."""
    F, Fv, L = dims.feat, dims.vec_feat, dims.n_layers
    layer = [(F, 3 * F, 8), (F, 2 * Fv, 4), (F, F, 8), (F, F, 8),
             (Fv, F, 8)]
    return layer * L + [(F + Fv, F, 8)]


def work(dims, fwd):
    if fwd["kind"] != "served" or fwd["mode"] != "w4a8":
        return None
    M = fwd["atoms"]
    n_bytes = int8 = fp32 = 0
    for K, N, bits in _products(dims):
        n_bytes += 4 * M * K + K * N * bits // 8 + 4 * N + 4 * M * N
        int8 += 2 * M * N * K
        fp32 += 4 * M * K
    return n_bytes, {"int8": int8, "fp32": fp32}
