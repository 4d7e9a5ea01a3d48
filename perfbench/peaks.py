"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates, no sparsity, at the full 700 W power limit). A card set below
700 W reaches less; the result line's device and PERF.md give the card's
name and limit beside every share read against these."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "int8": 1979e12,      # tensor cores, TOP/s
    "bf16": 989e12,
    "tf32": 495e12,
    "fp32": 67e12,        # outside the tensor cores (TF32 off)
}


def least_time(n_bytes: float, ops: dict) -> float:
    """The card's least seconds for the work: the larger of the bytes over
    the memory rate and the operations (by type) over their peaks."""
    t_ops = sum(n / OPS_PER_S[kind] for kind, n in ops.items())
    return max(n_bytes / HBM_BYTES_PER_S, t_ops)
