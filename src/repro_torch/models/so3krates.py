"""SO3krates-like SO(3)-equivariant transformer: config, parameters and
the geometry/attention helpers the serving forward shares.

Counterpart of ``repro/models/so3krates.py`` for the serving slice. The
QAT ``energy``/``forces`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.attention_norm import l2_normalize
from repro_torch.core.mddq import MDDQConfig
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["So3kratesConfig", "Params", "init_params", "pair_geometry",
           "cosine_logits"]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class So3kratesConfig:
    n_species: int = 20
    feat: int = 64             # F invariant channels
    vec_feat: int = 16         # Fv equivariant (l=1) channels
    n_layers: int = 3
    n_rbf: int = 16
    cutoff: float = 10.0       # Angstrom
    tau: float = 10.0          # cosine-attention inverse temperature
    quant: str = "none"
    w_bits: int = 4            # equivariant-branch weight bits (paper: W4)
    w_bits_inv: int = 8        # invariant-branch weight bits (paper: 8)
    a_bits: int = 8
    dir_bits: int = 16         # 65,536-entry Fibonacci codebook
    robust_attention: bool = True
    geometric_ste: bool = True
    freeze_vec_quant: bool = False

    def mddq(self) -> MDDQConfig:
        return MDDQConfig(direction_bits=self.dir_bits,
                          magnitude_bits=self.a_bits,
                          geometric_ste=self.geometric_ste)


def init_params(cfg: So3kratesConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random parameters with the shapes and scales of the JAX package's
    ``init_params`` (normal / sqrt(fan_in); embedding x 0.5; readout head
    x 0.1), drawn with numpy from ``seed`` (not JAX's bits)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    F, Fv, K = cfg.feat, cfg.vec_feat, cfg.n_rbf

    def dense(fan_in, fan_out):
        return rng.standard_normal((fan_in, fan_out)) / math.sqrt(fan_in)

    p = {"embed": rng.standard_normal((cfg.n_species, F)) * 0.5}
    for i in range(cfg.n_layers):
        L = f"layer{i}"
        p[f"{L}/wq"] = dense(F, F)
        p[f"{L}/wk"] = dense(F, F)
        p[f"{L}/wm"] = dense(F, F)
        p[f"{L}/rbf_m"] = dense(K, F)
        p[f"{L}/rbf_bias"] = dense(K, 1)
        p[f"{L}/wa"] = dense(F, Fv)
        p[f"{L}/rbf_a"] = dense(K, Fv)
        p[f"{L}/wb"] = dense(F, Fv)
        p[f"{L}/rbf_b"] = dense(K, Fv)
        p[f"{L}/w_upd1"] = dense(F, F)
        p[f"{L}/w_upd2"] = dense(F, F)
        p[f"{L}/w_vnorm"] = dense(Fv, F)
        p[f"{L}/ln_g"] = np.ones((F,))
        p[f"{L}/ln_b"] = np.zeros((F,))
    p["ro_w1"] = dense(F + Fv, F)
    p["ro_w2"] = dense(F, 1) * 0.1
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            for k, v in p.items()}


def _layernorm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)   # population, as jnp.var
    return (x - mu) / torch.sqrt(var + 1e-6) * g + b


def _rbf(d: torch.Tensor, cfg: So3kratesConfig) -> torch.Tensor:
    centers = torch.linspace(0.5, cfg.cutoff, cfg.n_rbf, dtype=d.dtype,
                             device=d.device)
    gamma = (cfg.n_rbf / cfg.cutoff) ** 2
    phi = torch.exp(-gamma * (d[..., None] - centers) ** 2)
    # smooth cutoff envelope (cosine)
    env = 0.5 * (torch.cos(math.pi * torch.clamp(d / cfg.cutoff, 0, 1)) + 1.0)
    return phi * env[..., None]


def _vnorm(v: torch.Tensor) -> torch.Tensor:
    """Invariant per-channel vector norms. (..., Fv, 3) -> (..., Fv)."""
    return torch.sqrt((v ** 2).sum(-1) + 1e-12)


def pair_geometry(coords: torch.Tensor, cfg: So3kratesConfig,
                  mask: Optional[torch.Tensor] = None):
    """Dense pairwise geometry. coords: (..., n, 3); mask: (..., n) bool
    (True = real atom). Returns (d, u, rbf, pair_mask): d (..., n, n),
    u = (r_j - r_i)/d, rbf zeroed outside the cutoff graph, pair_mask
    excluding self-pairs and padded atoms."""
    n = coords.shape[-2]
    rij = coords[..., None, :, :] - coords[..., :, None, :]   # [i,j]=r_j-r_i
    d = torch.sqrt((rij ** 2).sum(-1) + 1e-12)
    eye = torch.eye(n, dtype=torch.bool, device=coords.device)
    pair_mask = (d < cfg.cutoff) & ~eye
    if mask is not None:
        pair_mask = pair_mask & mask[..., :, None] & mask[..., None, :]
    u = rij / d[..., None]
    rbf = _rbf(d, cfg) * pair_mask[..., None]
    return d, u, rbf, pair_mask


def cosine_logits(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor,
                  cfg: So3kratesConfig, robust: bool) -> torch.Tensor:
    """Dense attention logits (..., n, n): tau * <q/|q|, k/|k|> (the
    paper's robust cosine form) or q.k / sqrt(F), plus the radial bias."""
    if robust:
        return cfg.tau * torch.einsum("...if,...jf->...ij", l2_normalize(q),
                                      l2_normalize(k)) + bias
    return torch.einsum("...if,...jf->...ij", q, k) \
        / math.sqrt(q.shape[-1]) + bias
