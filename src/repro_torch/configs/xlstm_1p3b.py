"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks at the published 7:1 ratio.
48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304 [arXiv:2405.04517; unverified].
Recurrent (O(1) state) -> runs long_500k.
"""
from repro_torch.models.lm.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="xlstm-1.3b", block_pattern="xlstm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, mlp_kind="none",
        xlstm_mlstm_per_slstm=7, xlstm_proj_factor=1,  # pf=1 hits 1.3B at the assigned 48L
        sub_quadratic=True,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="xlstm-smoke", block_pattern="xlstm",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=256, mlp_kind="none",
        xlstm_mlstm_per_slstm=7, xlstm_proj_factor=2, ssm_chunk=32,
        sub_quadratic=True,
    )
