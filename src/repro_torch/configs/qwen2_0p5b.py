"""qwen2-0.5b [dense]: GQA, QKV bias, tied embeddings.
24L d_model=896 14H (kv=2) d_ff=4864 vocab=151936 [arXiv:2407.10671; hf].
"""
from repro_torch.models.lm.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="qwen2-0.5b", block_pattern="transformer",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab=151936, head_dim=64, qkv_bias=True,
        mlp_kind="swiglu", tie_embeddings=True,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen2-smoke", block_pattern="transformer",
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
        d_ff=128, vocab=256, head_dim=8, qkv_bias=True,
        mlp_kind="swiglu", tie_embeddings=True,
    )
