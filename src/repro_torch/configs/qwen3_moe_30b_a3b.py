"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, fine-grained (d_ff=768).
48L d_model=2048 32H (kv=4) vocab=151936 [hf:Qwen/Qwen3-30B-A3B].
Qwen3 uses QK-norm natively -- which IS the paper's robust attention.
"""
from repro_torch.models.lm.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="qwen3-moe-30b-a3b", block_pattern="transformer",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=768, vocab=151936, head_dim=128, mlp_kind="swiglu",
        moe=True, n_experts=128, top_k=8, qk_norm=True,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen3-moe-smoke", block_pattern="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=256, head_dim=16, mlp_kind="swiglu",
        moe=True, n_experts=8, top_k=2, qk_norm=True,
    )
