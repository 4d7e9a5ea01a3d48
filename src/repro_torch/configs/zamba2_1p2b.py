"""zamba2-1.2b [hybrid]: Mamba2 backbone + one shared attention block.
38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf]. Sub-quadratic (SSM) -> runs long_500k.
"""
from repro_torch.models.lm.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="zamba2-1.2b", block_pattern="zamba2",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32000, head_dim=64,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
        zamba_mamba_per_attn=2, mlp_kind="swiglu",
        sub_quadratic=True,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="zamba2-smoke", block_pattern="zamba2",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, head_dim=16,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_groups=1,
        zamba_mamba_per_attn=2, mlp_kind="swiglu", ssm_chunk=32,
        sub_quadratic=True,
    )
