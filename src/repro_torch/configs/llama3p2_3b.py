"""llama3.2-3b [dense]: small llama3.
28L d_model=3072 24H (kv=8) d_ff=8192 vocab=128256 [hf:meta-llama/Llama-3.2-1B].
"""
from repro_torch.models.lm.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="llama3.2-3b", block_pattern="transformer",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256, head_dim=128, mlp_kind="swiglu",
        rope_theta=500000.0,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="llama3.2-smoke", block_pattern="transformer",
        n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=8, mlp_kind="swiglu",
    )
