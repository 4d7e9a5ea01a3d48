"""The MDDQ encode (K4: ``band_kernel`` / ``search_kernel`` /
``combine_kernel`` in ``kernels/csrc/mddq_encode.cu``, through
``codebook.nearest_code`` and ``ops.mddq_qdq_kernel``), one call per
layer and forward that quantizes the l = 1 features: each vector's
nearest codeword and log-magnitude code. What the inputs need, whatever
the search: each vector read once (12 bytes), the codebook read once
(12 bytes a codeword), an index and a code written (8 bytes) per vector.
The search's comparisons depend on the algorithm (a band search covers a
small part of the codebook), so no operations are counted: the bound is
the bytes."""

PATTERN = r"band_kernel|search_kernel|combine_kernel"


def work(dims, fwd):
    if not fwd.get("vectors_quantized"):
        return None
    n_vec = fwd["atoms"] * dims.vec_feat
    n_bytes = 12 * n_vec + 12 * fwd["codebook"] + 8 * n_vec
    return dims.n_layers * n_bytes, {}
