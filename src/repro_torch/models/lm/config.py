"""LM architecture configuration: counterpart of
``repro/models/lm/config.py``'s ``LMConfig``, ``ShapeCell`` and
``SHAPES``, with the same fields, defaults and values. ``dtype``
(activations) and ``param_dtype`` are ``torch.dtype``s. The sharding
field (``act_sharding``) and ``attn_chunk_kv`` are kept so configs copy
over unchanged, and the port does not read them; it reads
``attn_chunk_q`` (the prefill's query block), ``remat`` (each group
recomputed in the backward) and ``ssm_chunk`` (the chunked linear-RNN
scan's chunk, for the Mamba2 and mLSTM blocks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["LMConfig", "ShapeCell", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: Optional[int] = None           # default d_model // n_heads
    mlp_kind: str = "swiglu"                 # swiglu | squared_relu | none
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # --- robust attention normalization (paper §III-E, LM analogue) ---
    qk_norm: bool = False                    # l2-normalize q/k per head
    attn_tau: float = 10.0                   # inverse temperature
    rope_theta: float = 500000.0
    # --- block pattern ---
    block_pattern: str = "transformer"       # transformer | zamba2 | xlstm
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 64
    ssm_heads: int = 0                       # default d_inner // ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1                      # B/C groups (like GQA for SSM)
    zamba_mamba_per_attn: int = 2            # mamba blocks per shared attn
    # --- xLSTM ---
    xlstm_mlstm_per_slstm: int = 7           # the 7:1 ratio
    xlstm_proj_factor: int = 2
    # --- modality frontend ---
    frontend: str = "token"                  # token | audio_frames | image_patches
    # --- quantized execution ---
    quant_mode: str = "none"                 # none | qat_w4a8 | serve_w8a8 | serve_w4a8
    kv_quant: bool = False                   # quantized KV cache at serve time
    kv_bits: int = 8                         # 8 (int8) or 4 (packed int4)
    # replicate each KV head r times at decode so kv_heads*r divides the TP
    # width: attention becomes chip-local (no partial-softmax collectives) at
    # the cost of r x cache bytes (cheap once the cache is int4)
    kv_replicate: int = 1
    # --- numerics / scale ---
    dtype: Any = torch.bfloat16             # activation dtype
    param_dtype: Any = torch.float32
    remat: bool = False                      # activation checkpoint per block
    # activation sharding constraints at block boundaries (perf iteration):
    #   none  - let GSPMD propagate freely (baseline)
    #   dp    - pin batch to the data axes between blocks
    #   dp_sp - additionally shard the sequence dim over "model" between
    #           blocks (Megatron-style sequence parallelism)
    act_sharding: str = "none"
    # rmsnorm statistics dtype: f32 (safe default) or bf16. XLA pairs the
    # f32 upcast with the TP partial-sum all-reduce, doubling its bytes;
    # bf16 norms keep the dominant collective in bf16 (perf iteration).
    norm_f32: bool = True
    attn_chunk_q: int = 1024                 # chunked-attention query block
    attn_chunk_kv: int = 1024
    ssm_chunk: int = 256
    # long-context support marker (sub-quadratic path exists)
    sub_quadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS = 6 N D)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * hd * (nh + 2 * nkv) + nh * hd * d
        mlp = {"swiglu": 3 * d * ff, "squared_relu": 2 * d * ff,
               "none": 0}[self.mlp_kind]
        if self.moe:
            mlp = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        if self.block_pattern == "transformer":
            per_layer = attn + mlp
            body = self.n_layers * per_layer
        elif self.block_pattern == "zamba2":
            di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
            G = self.ssm_groups
            mamba = (d * (2 * di + 2 * G * N + H) + di * d + 4 * di + 2 * H)
            n_groups = self.n_layers // self.zamba_mamba_per_attn
            body = self.n_layers * mamba + (attn + mlp)  # shared attn counted once
        elif self.block_pattern == "xlstm":
            dk = d // 2
            m_per = d * 2 * d * self.xlstm_proj_factor // 2  # rough
            di = d * self.xlstm_proj_factor
            mlstm = d * di * 2 + di * (3 * (di // 2)) + di * d
            slstm = d * 4 * d * 2  # 4 gates, input+recurrent
            n_s = self.n_layers // (self.xlstm_mlstm_per_slstm + 1)
            body = (self.n_layers - n_s) * mlstm + n_s * slstm
        else:
            raise ValueError(self.block_pattern)
        emb = V * d * (1 if self.tie_embeddings else 2)
        return int(body + emb)

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        total = self.param_count()
        moe_p = self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
        active = self.n_layers * self.top_k * 3 * self.d_model * self.d_ff
        return int(total - moe_p + active)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (arch x input-shape) cell."""
    shape_name: str          # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)
