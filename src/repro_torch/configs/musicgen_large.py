"""musicgen-large [audio]: decoder-only over EnCodec tokens (backbone only;
the EnCodec frontend is a stub -- input_specs provides frame embeddings).
48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048 [arXiv:2306.05284; hf].
"""
from repro_torch.models.lm.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="musicgen-large", block_pattern="transformer",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=2048, head_dim=64, mlp_kind="swiglu",
        frontend="audio_frames",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="musicgen-smoke", block_pattern="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, head_dim=16, mlp_kind="swiglu",
        frontend="audio_frames",
    )
