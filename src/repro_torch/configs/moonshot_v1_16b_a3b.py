"""moonshot-v1-16b-a3b [moe]: kimi/moonlight-style 64-expert top-6 MoE.
48L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=163840
[hf:moonshotai/Moonlight-16B-A3B]. (Published model keeps layer 0 dense;
the JAX package, and so the port, use all-MoE layers for scan
homogeneity.)
"""
from repro_torch.models.lm.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="moonshot-v1-16b-a3b", block_pattern="transformer",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=163840, head_dim=128, mlp_kind="swiglu",
        moe=True, n_experts=64, top_k=6,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="moonshot-smoke", block_pattern="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=256, head_dim=16, mlp_kind="swiglu",
        moe=True, n_experts=8, top_k=2,
    )
