"""chameleon-34b [vlm]: early-fusion over VQ image tokens (backbone only;
the VQ-VAE frontend is a stub -- input_specs provides patch embeddings).
48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536 [arXiv:2405.09818].
Chameleon uses QK-norm natively -- the paper's robust attention.
"""
from repro_torch.models.lm.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="chameleon-34b", block_pattern="transformer",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab=65536, head_dim=128, mlp_kind="swiglu",
        qk_norm=True, frontend="image_patches",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="chameleon-smoke", block_pattern="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=256, head_dim=16, mlp_kind="swiglu",
        qk_norm=True, frontend="image_patches",
    )
