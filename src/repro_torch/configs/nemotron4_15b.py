"""nemotron-4-15b [dense]: GQA, squared-ReLU MLP.
32L d_model=6144 48H (kv=8) d_ff=24576 vocab=256000 [arXiv:2402.16819].
"""
from repro_torch.models.lm.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="nemotron-4-15b", block_pattern="transformer",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=24576, vocab=256000, head_dim=128, mlp_kind="squared_relu",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="nemotron-smoke", block_pattern="transformer",
        n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
        d_ff=96, vocab=256, head_dim=8, mlp_kind="squared_relu",
    )
