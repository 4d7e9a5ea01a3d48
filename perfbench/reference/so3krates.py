"""Plain PyTorch reference of the So3krates force field as it is served.

Written from the paper's equations and the port's documented semantics,
with no import of the program: the benchmark's yardstick for what the
timed path produces. It takes the fp32 weights the benchmark drew from the
seed and works out again everything the program derives from them: the
int8 / int4 weights and their per-column scales, the per-atom A8 codes,
the MDDQ codebook and codes, and the cutoff graph (every ordered pair of
distinct atoms of one molecule closer than the cutoff).

Semantics held:

* quantized products (``mode="w4a8"``): weights per output column at
  ``max(max|w|, 1e-8) / qmax`` (4 bits for the equivariant coefficient
  matrices ``wa`` / ``wb``, ``w_bits_inv`` for every other projection),
  activations per row at ``max(max|x|, 1e-8) / 127``, rounded half to
  even and clipped to the grid, the integer product exact (float64), then
  ``float32(acc) * a_scale * w_scale``; the backward is straight through
  against the dequantized weight. ``ro_w2`` stays float32.
* MDDQ on the l = 1 features after every layer (``dir_bits`` Fibonacci
  codebook, first index on ties, 8-bit log magnitude on [1e-6, 1e3]);
  zero vectors stay zero; the backward is straight through on the
  magnitude and the geometric STE (tangent projection) on the direction.
* robust cosine attention, ``tau * <q/|q|, k/|k|> + bias``, a softmax
  over each receiver's incoming edges.

Each abs-max scale divides by a tensor, so it is correctly rounded on
either device (PyTorch on the card multiplies by the reciprocal of a
Python scalar divisor); the log-magnitude code divides as the port's
plain version writes it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch.nn.functional import silu

__all__ = ["ModelDims", "Quant", "fibonacci_codebook", "cutoff_edges",
           "served_weights", "energy", "energy_and_forces"]

_NEAREST_CHUNK = 4096
_ROW_CHUNK = 16384


@dataclasses.dataclass(frozen=True)
class ModelDims:
    n_species: int = 20
    feat: int = 64
    vec_feat: int = 16
    n_layers: int = 3
    n_rbf: int = 16
    cutoff: float = 10.0
    tau: float = 10.0


@dataclasses.dataclass(frozen=True)
class Quant:
    """What the served forward quantizes. ``mode`` "fp32" quantizes
    nothing; "w4a8" as the module says. ``w_bits_inv`` is 8 in the
    configuration; the control lowers it."""
    mode: str = "w4a8"
    w_bits_eqv: int = 4
    w_bits_inv: int = 8
    a_bits: int = 8
    dir_bits: int = 16
    mag_bits: int = 8
    m_min: float = 1e-6
    m_max: float = 1e3


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    return x / torch.full_like(x, c)


def _f32(x: float) -> float:
    return float(np.float32(x))


# --- geometry ----------------------------------------------------------------

def cutoff_edges(coords: torch.Tensor, mask: torch.Tensor, cutoff: float):
    """Edges of a padded batch: coords (B, n, 3), mask (B, n) bool ->
    (senders, receivers) int64 flat indices into (B * n,), every ordered
    pair of distinct real atoms of one molecule with d < cutoff."""
    B, n, _ = coords.shape
    rij = coords[:, None, :, :] - coords[:, :, None, :]      # [b,i,j]=r_j-r_i
    d2 = (rij * rij).sum(-1)
    eye = torch.eye(n, dtype=torch.bool, device=coords.device)
    pair = (d2 < cutoff * cutoff) & ~eye & mask[:, :, None] & mask[:, None, :]
    b, i, j = pair.nonzero(as_tuple=True)
    return b * n + j, b * n + i


def _rbf(d: torch.Tensor, dims: ModelDims) -> torch.Tensor:
    centers = torch.linspace(0.5, dims.cutoff, dims.n_rbf, dtype=d.dtype,
                             device=d.device)
    gamma = (dims.n_rbf / dims.cutoff) ** 2
    phi = torch.exp(-gamma * (d[..., None] - centers) ** 2)
    x = torch.minimum(torch.maximum(d / dims.cutoff, d.new_full((), 0.0)),
                      d.new_full((), 1.0))
    return phi * (0.5 * (torch.cos(math.pi * x) + 1.0))[..., None]


def _layernorm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) / torch.sqrt(var + 1e-6) * g + b


def _l2n(x: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.maximum(norm, norm.new_full((), 1e-6))


def _vnorm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v ** 2).sum(-1) + 1e-12)


# --- quantized products --------------------------------------------------------

def _quantize_columns(w: torch.Tensor, bits: int):
    qmax = 2 ** (bits - 1) - 1
    scale = _div(torch.clamp(w.abs().amax(0, keepdim=True), min=1e-8), qmax)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax)
    return q, scale


class _IntProduct(torch.autograd.Function):
    """A8 x W(int) product; straight-through backward g @ dequant(W)^T."""

    @staticmethod
    def forward(ctx, x, w_q, w_scale):
        a_scale = _div(torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-8),
                       127)
        a_q = torch.clamp(torch.round(x / a_scale), -127, 127)
        acc = torch.matmul(a_q.to(torch.float64), w_q.to(torch.float64))
        ctx.save_for_backward(w_q, w_scale)
        return acc.to(torch.float32) * a_scale * w_scale

    @staticmethod
    def backward(ctx, g):
        w_q, w_scale = ctx.saved_tensors
        return g @ (w_q * w_scale).T, None, None


class Linear:
    """A served projection: fp32, or integer codes with column scales."""

    def __init__(self, w: torch.Tensor, bits: Optional[int]):
        self.w = w
        self.bits = bits
        if bits is not None:
            self.q, self.scale = _quantize_columns(w, bits)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits is None:
            return x @ self.w
        return _IntProduct.apply(x, self.q, self.scale)


_PROJ = ("wq", "wk", "wm", "wa", "wb", "w_upd1", "w_upd2", "w_vnorm")


def served_weights(params: Dict[str, torch.Tensor], dims: ModelDims,
                   quant: Quant) -> Dict[str, object]:
    """The projections in their served form, the rest as given."""
    out: Dict[str, object] = dict(params)
    for name, w in params.items():
        base = name.split("/")[-1]
        if base in _PROJ or name == "ro_w1":
            bits = None
            if quant.mode == "w4a8":
                bits = quant.w_bits_eqv if base in ("wa", "wb") \
                    else quant.w_bits_inv
            out[name] = Linear(w, bits)
    return out


# --- MDDQ ----------------------------------------------------------------------

def fibonacci_codebook(bits: int, device) -> torch.Tensor:
    """(2**bits, 3) float32 near-uniform directions (Fibonacci lattice,
    built in float64 and rounded once)."""
    n = 2 ** bits
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * i
    pts = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                    np.cos(phi)], -1)
    pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    return torch.from_numpy(pts.astype(np.float32)).to(device)


def nearest_code(u: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """First-index argmax of ``(ux*cx + uy*cy) + uz*cz``. u (N, 3)."""
    out = torch.empty(u.shape[0], dtype=torch.int64, device=u.device)
    for r in range(0, u.shape[0], _ROW_CHUNK):
        uu = u[r:r + _ROW_CHUNK]
        best = torch.full((uu.shape[0],), -2.0, dtype=u.dtype,
                          device=u.device)
        idx = torch.zeros(uu.shape[0], dtype=torch.int64, device=u.device)
        ux, uy, uz = uu[:, 0:1], uu[:, 1:2], uu[:, 2:3]
        for base in range(0, codebook.shape[0], _NEAREST_CHUNK):
            c = codebook[base:base + _NEAREST_CHUNK]
            s = (ux * c[:, 0] + uy * c[:, 1]) + uz * c[:, 2]
            val, i = s.max(1)
            take = val > best
            best = torch.where(take, val, best)
            idx = torch.where(take, i + base, idx)
        out[r:r + _ROW_CHUNK] = idx
    return out


def _log_bounds(quant: Quant):
    lo = float(torch.log(torch.tensor(quant.m_min, dtype=torch.float32)))
    hi = float(torch.log(torch.tensor(quant.m_max, dtype=torch.float32)))
    return lo, hi


def _magnitude(m: torch.Tensor, quant: Quant) -> torch.Tensor:
    """The decoded 8-bit log-domain magnitude of m."""
    levels = 2 ** quant.mag_bits - 1
    lo, hi = _log_bounds(quant)
    lm = torch.log(torch.clamp(m, _f32(quant.m_min), _f32(quant.m_max)))
    t = (lm - lo) / _f32(hi - lo)
    code = torch.clamp(torch.round(t * levels), 0, levels)
    return torch.exp(lo + code / levels * _f32(hi - lo))


class _GeometricSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, q):
        ctx.save_for_backward(u)
        return q.clone()

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        return g - u * (u * g).sum(-1, keepdim=True), None


def mddq(v: torch.Tensor, codebook: torch.Tensor, quant: Quant):
    """Quantize-dequantize (..., 3) vectors with the module's gradients."""
    flat = v.detach().reshape(-1, 3)
    x, y, z = flat[:, 0], flat[:, 1], flat[:, 2]
    norm = torch.sqrt((x * x + y * y) + z * z)
    u_enc = flat / torch.clamp(norm, min=1e-12)[:, None]
    q_dir = codebook[nearest_code(u_enc, codebook)].reshape(v.shape)
    m_q = _magnitude(norm, quant).reshape(*v.shape[:-1], 1)

    m2 = (v * v).sum(-1, keepdim=True)
    m = torch.sqrt(torch.clamp(m2, min=1e-24))
    u = v / torch.clamp(m, min=1e-12)
    out = (m + (m_q - m).detach()) * _GeometricSTE.apply(u, q_dir)
    return torch.where(m <= 1e-12, torch.zeros_like(out), out)


# --- the served energy ------------------------------------------------------------

def _segment_softmax(logits, receivers, n_nodes):
    seg_max = torch.full((n_nodes,), float("-inf"), dtype=logits.dtype,
                         device=logits.device).scatter_reduce(
        0, receivers, logits.detach(), reduce="amax", include_self=True)
    p = torch.exp(logits - seg_max.index_select(0, receivers))
    denom = torch.zeros(n_nodes, dtype=p.dtype, device=p.device) \
        .index_add(0, receivers, p)
    return p / denom.index_select(0, receivers)


def energy(weights, dims: ModelDims, quant: Quant, species: torch.Tensor,
           coords: torch.Tensor, mask: torch.Tensor, edges,
           codebook: Optional[torch.Tensor]) -> torch.Tensor:
    """Energies (B,) of a padded batch: species (B, n) long, coords
    (B, n, 3), mask (B, n) bool, edges from :func:`cutoff_edges`."""
    B, n, _ = coords.shape
    N = B * n
    F, Fv = dims.feat, dims.vec_feat
    s, r = edges
    c = coords.reshape(N, 3)
    rij = c.index_select(0, s) - c.index_select(0, r)
    d = torch.sqrt((rij ** 2).sum(-1) + 1e-12)
    u = rij / d[:, None]
    rbf = _rbf(d, dims)

    mask_f = mask.reshape(N)
    x = weights["embed"][species.reshape(N)] * mask_f[:, None]
    v = c.new_zeros((N, Fv, 3))
    for i in range(dims.n_layers):
        L = f"layer{i}"
        xn = _layernorm(x, weights[f"{L}/ln_g"], weights[f"{L}/ln_b"])
        q = dims.tau * _l2n(weights[f"{L}/wq"](xn))
        k = _l2n(weights[f"{L}/wk"](xn))
        msg = weights[f"{L}/wm"](xn)
        a = weights[f"{L}/wa"](xn)
        b = weights[f"{L}/wb"](xn)
        bias = (rbf @ weights[f"{L}/rbf_bias"])[:, 0]
        gate = rbf @ weights[f"{L}/rbf_m"]
        ga = rbf @ weights[f"{L}/rbf_a"]
        gb = rbf @ weights[f"{L}/rbf_b"]
        logits = (q.index_select(0, r) * k.index_select(0, s)).sum(-1) + bias
        alpha = _segment_softmax(logits, r, N)[:, None]
        x = x + torch.zeros_like(x).index_add(
            0, r, alpha * gate * msg.index_select(0, s))
        x = x + weights[f"{L}/w_upd2"](silu(weights[f"{L}/w_upd1"](x)))
        ca = alpha * a.index_select(0, s) * ga
        cb = alpha * b.index_select(0, s) * gb
        dv = ca[..., None] * u[:, None, :] \
            + cb[..., None] * v.index_select(0, s)
        v = v + torch.zeros_like(v).index_add(0, r, dv)
        if quant.mode != "fp32":
            v = mddq(v, codebook, quant)
        x = x + weights[f"{L}/w_vnorm"](silu(_vnorm(v)))
    feats = torch.cat([x, _vnorm(v)], dim=-1)
    e_atom = (silu(weights["ro_w1"](feats)) @ weights["ro_w2"])[:, 0]
    return (e_atom.reshape(B, n) * mask).sum(-1)


def energy_and_forces(weights, dims, quant, species, coords, mask,
                      codebook, edges=None):
    """(energies (B,), forces -dE/dr (B, n, 3)), both detached; the
    cutoff graph is built here at these coordinates unless given."""
    if edges is None:
        edges = cutoff_edges(coords, mask, dims.cutoff)
    with torch.enable_grad():
        c = coords.detach().requires_grad_()
        e = energy(weights, dims, quant, species, c, mask, edges, codebook)
        (g,) = torch.autograd.grad(e.sum(), c)
    return e.detach(), -g
