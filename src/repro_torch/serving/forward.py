"""Batched, masked, quantized SO3krates forward passes: dense and sparse.

Counterpart of ``repro/serving/forward.py``. Two executions of the same
architecture:

* **Dense** (``batched_energy``): the O(B * n^2) path with pairwise
  (B, n, n, .) tensors and a masked softmax over full rows; the oracle,
  and the fallback for batches denser than a bucket's edge capacity.
* **Sparse** (``sparse_energy``): the O(E) edge-list path. Attention,
  radial gating and both equivariant message terms are computed on
  gathered edge features and reduced by one fused edge-softmax kernel
  launch per layer.

Every per-atom projection runs through ``qparams.qmatmul`` (the
quantized-matmul kernels on CUDA tensors, their plain versions on CPU
tensors) and serve-time vector quantization through MDDQ (on CUDA
tensors the codebook search is always the encode kernel). Padded atoms
never enter an edge or a pair, contribute exactly zero energy and get
exactly zero force. Forces are ``-dE/dr`` by ``torch.autograd.grad``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as Fn

from repro_torch.core.attention_norm import l2_normalize
from repro_torch.core.mddq import mddq_fake_quant
from repro_torch.kernels import ops
from repro_torch.models.so3krates import (So3kratesConfig, _layernorm, _rbf,
                                          _vnorm, cosine_logits,
                                          pair_geometry)
from repro_torch.serving.qparams import (QuantizedParams, concat_qtensors,
                                         qmatmul)

__all__ = ["batched_energy", "batched_energy_and_forces",
           "sparse_energy", "sparse_energy_and_forces"]

# the per-layer "trunk": every projection taken from the same layernormed
# activations, fused into as few matmuls as the weight kinds allow
# (w8a8/fp32: one; w4a8: one w8 + one w4 group) — an exact rewrite, see
# qparams.concat_qtensors
_TRUNK = ("wq", "wk", "wm", "wa", "wb")


def _trunk_matmul(qparams, layer: str, xn: torch.Tensor) -> torch.Tensor:
    """One fused projection pass: (N, 3F + 2Fv) columns ordered
    q | k | msg | a-coeff | b-coeff."""
    qts = [qparams[f"{layer}/{n}"] for n in _TRUNK]
    outs = []
    lo = 0
    for hi in range(1, len(qts) + 1):
        if hi == len(qts) or qts[hi].kind != qts[lo].kind:
            group = qts[lo:hi]
            qt = group[0] if len(group) == 1 else concat_qtensors(group)
            outs.append(qmatmul(xn, qt))
            lo = hi
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _dense(x: torch.Tensor, qt) -> torch.Tensor:
    """(B, n, F_in) @ W -> (B, n, F_out) through one flattened matmul."""
    B, n, f = x.shape
    return qmatmul(x.reshape(B * n, f), qt).reshape(B, n, -1)


def _quant_vectors(v: torch.Tensor, cfg: So3kratesConfig,
                   codebook: torch.Tensor, mddq_kernel: bool) -> torch.Tensor:
    """Serve-time MDDQ on l=1 features: the encode-kernel quantize-
    dequantize (``ServeConfig.mddq_kernel``) or the fake-quant reference;
    both keep zero vectors exactly zero and NaN-safe."""
    if mddq_kernel:
        return ops.mddq_qdq_kernel(v, cfg.mddq(), codebook)
    return mddq_fake_quant(v, cfg.mddq(), codebook)


def _codebook_for(cfg: So3kratesConfig, codebook, quant_vectors: bool,
                  device) -> Optional[torch.Tensor]:
    if codebook is None and quant_vectors:
        return cfg.mddq().codebook(device)
    return codebook


def batched_energy(qparams: QuantizedParams, cfg: So3kratesConfig,
                   species: torch.Tensor, coords: torch.Tensor,
                   mask: torch.Tensor,
                   codebook: Optional[torch.Tensor] = None,
                   *, quant_vectors: bool = True,
                   mddq_kernel: bool = False) -> torch.Tensor:
    """Per-molecule energies for a padded batch — dense O(n^2) path.

    species: (B, n) int, coords: (B, n, 3) f32, mask: (B, n) bool (True =
    real atom). Returns (B,) f32.
    """
    B, n = species.shape
    codebook = _codebook_for(cfg, codebook, quant_vectors, coords.device)
    _, u, rbf, pair_mask = pair_geometry(coords, cfg, mask)

    x = qparams["embed"][species] * mask[..., None]          # (B, n, F)
    v = coords.new_zeros((B, n, cfg.vec_feat, 3))

    for i in range(cfg.n_layers):
        L = f"layer{i}"
        xn = _layernorm(x, qparams[f"{L}/ln_g"], qparams[f"{L}/ln_b"])

        q = _dense(xn, qparams[f"{L}/wq"])
        k = _dense(xn, qparams[f"{L}/wk"])
        bias = (rbf @ qparams[f"{L}/rbf_bias"])[..., 0]      # (B, n, n)
        logits = cosine_logits(q, k, bias, cfg, cfg.robust_attention)
        logits = torch.where(pair_mask, logits,
                             torch.full_like(logits, -1e9))
        alpha = torch.softmax(logits, dim=-1)                # (B, n, n)

        # invariant messages (gate is rbf-masked -> padded pairs drop out)
        msg = _dense(xn, qparams[f"{L}/wm"])
        gate = rbf @ qparams[f"{L}/rbf_m"]                   # (B, n, n, F)
        x = x + torch.einsum("bij,bijf->bif", alpha,
                             gate * msg[:, None, :, :])
        h = Fn.silu(_dense(x, qparams[f"{L}/w_upd1"]))
        x = x + _dense(h, qparams[f"{L}/w_upd2"])

        # equivariant messages: invariant coefficients x directions
        ca = _dense(xn, qparams[f"{L}/wa"])[:, None] \
            * (rbf @ qparams[f"{L}/rbf_a"])                  # (B, n, n, Fv)
        cb = _dense(xn, qparams[f"{L}/wb"])[:, None] \
            * (rbf @ qparams[f"{L}/rbf_b"])
        dv = torch.einsum("bij,bijc,bijd->bicd", alpha, ca, u) \
            + torch.einsum("bij,bijc,bjcd->bicd", alpha, cb, v)
        v = v + dv
        if quant_vectors:
            v = _quant_vectors(v, cfg, codebook, mddq_kernel)

        x = x + _dense(Fn.silu(_vnorm(v)), qparams[f"{L}/w_vnorm"])

    feats = torch.cat([x, _vnorm(v)], dim=-1)
    e_hid = Fn.silu(_dense(feats, qparams["ro_w1"]))
    e_atom = _dense(e_hid, qparams["ro_w2"])[..., 0]         # (B, n)
    return (e_atom * mask).sum(-1)                           # (B,)


def _energy_and_forces(energy_fn, coords: torch.Tensor):
    coords = coords.detach().requires_grad_()
    with torch.enable_grad():
        e = energy_fn(coords)
        (grad,) = torch.autograd.grad(e.sum(), coords)
    return e.detach(), -grad


def batched_energy_and_forces(qparams, cfg, species, coords, mask,
                              codebook=None, *, quant_vectors=True,
                              mddq_kernel=False):
    """Energies (B,) and conservative forces (B, n, 3) = -dE/dr, through
    the straight-through backwards; padded atoms get exactly zero force."""
    return _energy_and_forces(
        lambda c: batched_energy(qparams, cfg, species, c, mask, codebook,
                                 quant_vectors=quant_vectors,
                                 mddq_kernel=mddq_kernel), coords)


# ---------------------------------------------------------------------------
# sparse edge-list path
# ---------------------------------------------------------------------------

def sparse_energy(qparams: QuantizedParams, cfg: So3kratesConfig,
                  species: torch.Tensor, coords: torch.Tensor,
                  mask: torch.Tensor, senders: torch.Tensor,
                  receivers: torch.Tensor, edge_mask: torch.Tensor,
                  codebook: Optional[torch.Tensor] = None,
                  *, quant_vectors: bool = True,
                  mddq_kernel: bool = False,
                  refine_cutoff: bool = False) -> torch.Tensor:
    """Per-molecule energies over a padded edge list — the O(E) path.

    species/coords/mask as in ``batched_energy``; senders/receivers are
    flat int32 indices into the (B * n,) node axis and edge_mask the
    per-slot validity bit, laid out per the ``bucketing.EdgeList``
    contract (per-molecule slot ranges, receiver-sorted real edges).
    ``refine_cutoff=True`` treats ``edge_mask`` as a Verlet-skin list
    built at an enlarged radius and tightens it to ``d < cfg.cutoff`` at
    the current coordinates from the distances computed here (the MD
    engine's per-step refinement, the predicate of
    ``kernels.ops.refine_edge_mask``); the unrefined mask stays the edge
    softmax's layout. Returns (B,) f32.
    """
    B, n = species.shape
    N = B * n
    F, Fv = cfg.feat, cfg.vec_feat
    codebook = _codebook_for(cfg, codebook, quant_vectors, coords.device)

    # edge geometry from gathered coordinates, so forces flow through the
    # gathers; masked slots are self-loops (d ~ 0), gated by edge_mask
    coords_f = coords.reshape(N, 3)
    rij = ops.edge_gather(coords_f, senders) \
        - ops.edge_gather(coords_f, receivers)               # (E, 3) r_j-r_i
    d2 = (rij ** 2).sum(-1)
    layout_mask = edge_mask
    if refine_cutoff:
        edge_mask = edge_mask & (d2 < cfg.cutoff * cfg.cutoff)
    d = torch.sqrt(d2 + 1e-12)
    u = rij / d[..., None]                                   # (E, 3)
    rbf_e = _rbf(d, cfg) * edge_mask[..., None]              # (E, K)

    mask_f = mask.reshape(N)
    x = qparams["embed"][species.reshape(N)] * mask_f[:, None]   # (N, F)
    v = coords.new_zeros((N, Fv, 3))

    for i in range(cfg.n_layers):
        L = f"layer{i}"
        xn = _layernorm(x, qparams[f"{L}/ln_g"], qparams[f"{L}/ln_b"])

        trunk = _trunk_matmul(qparams, L, xn)            # (N, 3F+2Fv)
        q, k = trunk[:, :F], trunk[:, F:2 * F]
        if cfg.robust_attention:
            q_s = cfg.tau * l2_normalize(q)
            k_s = l2_normalize(k)
        else:
            q_s = q / q.shape[-1] ** 0.5
            k_s = k

        # fused radial product: bias | scalar gate | a-gate | b-gate
        rg = rbf_e @ torch.cat(
            [qparams[f"{L}/rbf_bias"], qparams[f"{L}/rbf_m"],
             qparams[f"{L}/rbf_a"], qparams[f"{L}/rbf_b"]], dim=1)
        bias_e = rg[:, 0]                                    # (E,)
        gate_e = rg[:, 1:1 + F]                              # (E, F)

        # fused sender gather: scalar messages, both coefficient
        # projections and the vector features off one (E, .) gather
        sf = ops.edge_gather(
            torch.cat([trunk[:, 2 * F:], v.reshape(N, Fv * 3)], dim=1),
            senders)
        msg_e = sf[:, :F]                                    # (E, F)
        ca_e = sf[:, F:F + Fv] * rg[:, 1 + F:1 + F + Fv]     # (E, Fv)
        cb_e = sf[:, F + Fv:F + 2 * Fv] * rg[:, 1 + F + Fv:]
        # one fused softmax-scatter carries the scalar message and both
        # equivariant message terms (they share alpha)
        vec_e = ca_e[..., None] * u[:, None, :] \
            + cb_e[..., None] * sf[:, F + 2 * Fv:].reshape(-1, Fv, 3)
        vals = torch.cat([gate_e * msg_e, vec_e.reshape(-1, Fv * 3)], dim=1)

        out = ops.edge_softmax(q_s, k_s, bias_e, vals, senders, receivers,
                               edge_mask, cap=n, layout_mask=layout_mask)
        x = x + out[:, :F]
        h = Fn.silu(qmatmul(x, qparams[f"{L}/w_upd1"]))
        x = x + qmatmul(h, qparams[f"{L}/w_upd2"])

        v = v + out[:, F:].reshape(N, Fv, 3)
        if quant_vectors:
            v = _quant_vectors(v, cfg, codebook, mddq_kernel)

        x = x + qmatmul(Fn.silu(_vnorm(v)), qparams[f"{L}/w_vnorm"])

    feats = torch.cat([x, _vnorm(v)], dim=-1)
    e_hid = Fn.silu(qmatmul(feats, qparams["ro_w1"]))
    e_atom = qmatmul(e_hid, qparams["ro_w2"])[:, 0]               # (N,)
    return (e_atom.reshape(B, n) * mask).sum(-1)             # (B,)


def sparse_energy_and_forces(qparams, cfg, species, coords, mask, senders,
                             receivers, edge_mask, codebook=None, *,
                             quant_vectors=True, mddq_kernel=False,
                             refine_cutoff=False):
    """Sparse-path energies (B,) and conservative forces (B, n, 3). The
    edge list is data (no gradient); padded atoms, which appear in no
    real edge, get exactly zero force."""
    return _energy_and_forces(
        lambda c: sparse_energy(qparams, cfg, species, c, mask, senders,
                                receivers, edge_mask, codebook,
                                quant_vectors=quant_vectors,
                                mddq_kernel=mddq_kernel,
                                refine_cutoff=refine_cutoff), coords)
