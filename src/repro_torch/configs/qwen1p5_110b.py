"""qwen1.5-110b [dense]: GQA + QKV bias.
80L d_model=8192 64H (kv=8) d_ff=49152 vocab=152064 [hf:Qwen/Qwen1.5-0.5B; hf].
"""
from repro_torch.models.lm.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-110b", block_pattern="transformer",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=49152, vocab=152064, head_dim=128, qkv_bias=True,
        mlp_kind="swiglu",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen1.5-smoke", block_pattern="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab=256, head_dim=16, qkv_bias=True, mlp_kind="swiglu",
    )
