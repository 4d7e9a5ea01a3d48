"""SO3krates-like SO(3)-equivariant transformer with GAQ quantization:
counterpart of ``repro/models/so3krates.py``.

The config, parameters and geometry/attention helpers are shared with the
serving forward; :func:`energy`, :func:`forces` and
:func:`energy_and_forces` are the dense QAT model (fake quantization with
straight-through gradients) in the five ``cfg.quant`` modes: ``"none"``
(fp32), ``"gaq_w4a8"`` (the paper's: MDDQ with the geometric STE on the
vectors, W4 equivariant / W8 invariant weights, A8, cosine attention),
``"naive_int8"`` (per-tensor INT8 on Cartesian vector components),
``"degree_quant"`` (per-node range scaled by sqrt(degree)) and
``"svq_kmeans"`` (hard spherical VQ with no gradient).

The JAX package vmaps the single-molecule energy over a batch, so every
per-tensor abs-max scale (A8 activations, the baselines' vectors) and
``degree_quant``'s largest degree is a molecule's own. The port takes
coordinates with any leading batch axes and reduces each such scale over
one molecule's axes only; weight scales are shared.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch.nn.functional import silu

from repro_torch.core.attention_norm import l2_normalize
from repro_torch.core.codebook import make_codebook, nearest_code
from repro_torch.core.mddq import MDDQConfig, mddq_fake_quant
from repro_torch.core.quantizers import clip, fake_quant_ste, scale_from_amax
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["So3kratesConfig", "Params", "init_params", "pair_geometry",
           "cosine_logits", "energy", "forces", "energy_and_forces"]

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
    env = 0.5 * (torch.cos(math.pi * clip(d / cfg.cutoff, 0.0, 1.0)) + 1.0)
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


# ---------------------------------------------------------------------------
# quantization helpers (branch-separated, paper §III-D)
# ---------------------------------------------------------------------------

def _qw(w: torch.Tensor, cfg: So3kratesConfig, branch: str) -> torch.Tensor:
    """Weight fake-quant: per-output-channel, W4 equivariant / W8 invariant."""
    if cfg.quant == "none":
        return w
    bits = cfg.w_bits if branch == "eqv" else cfg.w_bits_inv
    if cfg.quant in ("naive_int8", "degree_quant", "svq_kmeans"):
        bits = 8  # baselines are W8A8
    return fake_quant_ste(w, bits, channel_axis=w.ndim - 1)


def _mol_scale(x: torch.Tensor, bits: int, mol_dims: int) -> torch.Tensor:
    """Abs-max scale of each molecule: over the last ``mol_dims`` axes
    (kept), so leading batch axes get one scale per molecule."""
    amax = x.detach().abs().amax(dim=tuple(range(-mol_dims, 0)),
                                 keepdim=True)
    return scale_from_amax(amax, bits)


def _act_scale(x: torch.Tensor, cfg: So3kratesConfig,
               degrees: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The A8 scale of per-atom activations x (..., n, F): one per
    molecule, or with ``degree_quant`` per atom, scaled by
    sqrt(degree / the molecule's largest degree)."""
    scale = _mol_scale(x, cfg.a_bits, 2)
    if cfg.quant == "degree_quant" and degrees is not None:
        top = torch.clamp(degrees.amax(-1, keepdim=True), min=1.0)
        scale = scale * torch.sqrt(degrees / top)[..., None]
        scale = torch.clamp(scale, min=1e-8)
    return scale


def _qact(x: torch.Tensor, cfg: So3kratesConfig,
          degrees: Optional[torch.Tensor] = None,
          nested: bool = False) -> torch.Tensor:
    """Scalar-activation fake-quant (A8)."""
    if cfg.quant == "none":
        return x
    return fake_quant_ste(x, cfg.a_bits, scale=_act_scale(x, cfg, degrees),
                          nested=nested)


def _qvec(v: torch.Tensor, cfg: So3kratesConfig,
          codebook: Optional[torch.Tensor],
          nested: bool = False) -> torch.Tensor:
    """Equivariant-feature quantization, where the methods differ.
    v: (..., n, Fv, 3)."""
    if cfg.quant == "none" or cfg.freeze_vec_quant:
        return v
    if cfg.quant == "gaq_w4a8":
        return mddq_fake_quant(v, cfg.mddq(), codebook, nested)
    if cfg.quant == "svq_kmeans":
        # hard spherical VQ with no gradient approximation: the output is
        # detached (gradient fracture, paper §IV-B)
        v = v.detach()
        m = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        u = v / torch.clamp(m, min=1e-12)
        return codebook[nearest_code(u, codebook)] * m
    # naive / degree_quant: per-tensor linear INT8 on Cartesian components
    return fake_quant_ste(v, 8, scale=_mol_scale(v, 8, 3), nested=nested)


# ---------------------------------------------------------------------------
# the dense QAT forward
# ---------------------------------------------------------------------------

def energy(params: Params, cfg: So3kratesConfig, species, coords: torch.Tensor,
           codebook: Optional[torch.Tensor] = None,
           nested: bool = False) -> torch.Tensor:
    """Total energy of each molecule. species: (n,) or (..., n) ints;
    coords: (..., n, 3) -> (...). ``codebook`` defaults to
    ``make_codebook(cfg.dir_bits)`` on the coordinates' device in a
    quantized mode; MDDQ's nearest codeword runs the encode kernel (K4)
    on the card, one launch per layer for the whole batch.

    ``nested``: forces will be taken with ``create_graph=True`` and
    differentiated again. The estimators on tensors that depend on the
    coordinates then follow the JAX package's nested semantics
    (``core.ste``); those on the weights and on the first layer's
    normalized embedding, which do not depend on the coordinates, pass
    gradient as in first order."""
    if codebook is None and cfg.quant != "none":
        codebook = make_codebook(cfg.dir_bits, device=coords.device)
    species = torch.as_tensor(species, device=coords.device).long()
    _, u, rbf, mask = pair_geometry(coords, cfg)
    degrees = mask.sum(-1).to(coords.dtype)

    x = params["embed"].index_select(0, species.reshape(-1))
    x = x.reshape(*species.shape, cfg.feat)
    x = x.expand(*coords.shape[:-1], cfg.feat)                # (..., n, F)
    v = coords.new_zeros(*coords.shape[:-1], cfg.vec_feat, 3)
    robust = (cfg.robust_attention
              and cfg.quant not in ("naive_int8", "degree_quant"))

    for i in range(cfg.n_layers):
        L = f"layer{i}"
        xn = _layernorm(x, params[f"{L}/ln_g"], params[f"{L}/ln_b"])
        xn = _qact(xn, cfg, degrees, nested=nested and i > 0)

        q = xn @ _qw(params[f"{L}/wq"], cfg, "inv")
        k = xn @ _qw(params[f"{L}/wk"], cfg, "inv")
        bias = (rbf @ params[f"{L}/rbf_bias"])[..., 0]       # (..., n, n)
        logits = cosine_logits(q, k, bias, cfg, robust)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
        alpha = torch.softmax(logits, dim=-1)

        # invariant messages
        msg = xn @ _qw(params[f"{L}/wm"], cfg, "inv")        # (..., n, F)
        gate = rbf @ params[f"{L}/rbf_m"]                    # (..., n, n, F)
        x = x + torch.einsum("...ij,...ijf->...if", alpha,
                             gate * msg[..., None, :, :])
        h = silu(_qact(x, cfg, degrees, nested)
                   @ _qw(params[f"{L}/w_upd1"], cfg, "inv"))
        x = x + h @ _qw(params[f"{L}/w_upd2"], cfg, "inv")

        # equivariant messages: coefficients are invariant scalars
        ca = (xn @ _qw(params[f"{L}/wa"], cfg, "eqv"))[..., None, :, :] \
            * (rbf @ params[f"{L}/rbf_a"])
        cb = (xn @ _qw(params[f"{L}/wb"], cfg, "eqv"))[..., None, :, :] \
            * (rbf @ params[f"{L}/rbf_b"])
        dv = torch.einsum("...ij,...ijc,...ijd->...icd", alpha, ca, u) \
            + torch.einsum("...ij,...ijc,...jcd->...icd", alpha, cb, v)
        v = _qvec(v + dv, cfg, codebook, nested)

        # invariant feedback from vector norms (keeps branches coupled)
        x = x + silu(_qact(_vnorm(v), cfg, degrees, nested)) \
            @ _qw(params[f"{L}/w_vnorm"], cfg, "inv")

    feats = torch.cat([x, _vnorm(v)], dim=-1)
    e_atom = silu(feats @ _qw(params["ro_w1"], cfg, "inv")) \
        @ params["ro_w2"]
    return e_atom.sum((-2, -1))


def energy_and_forces(params: Params, cfg: So3kratesConfig, species,
                      coords: torch.Tensor,
                      codebook: Optional[torch.Tensor] = None,
                      create_graph: bool = False):
    """(energies (...), forces -dE/dr (..., n, 3)) by autograd, under
    ``torch.enable_grad()`` whatever the caller's mode. With
    ``create_graph`` both stay differentiable in the parameters (a force
    loss, the LEE regularizer), with the reference's nested semantics
    (:func:`energy`'s ``nested``); without it both come back detached."""
    with torch.enable_grad():
        c = coords.detach().requires_grad_()
        e = energy(params, cfg, species, c, codebook, nested=create_graph)
        (g,) = torch.autograd.grad(e.sum(), c, create_graph=create_graph)
    if not create_graph:
        e = e.detach()
    return e, -g


def forces(params: Params, cfg: So3kratesConfig, species,
           coords: torch.Tensor, codebook: Optional[torch.Tensor] = None,
           create_graph: bool = False) -> torch.Tensor:
    """Conservative forces F = -dE/dr, (..., n, 3)."""
    return energy_and_forces(params, cfg, species, coords, codebook,
                             create_graph)[1]
