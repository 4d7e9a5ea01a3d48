"""Plain PyTorch reference of one GAQ quantization-aware training step of
So3krates (the paper's second contribution), written from the paper and
the port's documented semantics, importing nothing of the program.

The model is the dense QAT forward: per-column fake-quantized weights
(W4 on the equivariant coefficient matrices ``wa`` / ``wb``,
``w_bits_inv`` on every other projection), A8 fake quantization of the
scalar activations with one abs-max scale per molecule, MDDQ fake
quantization of the l = 1 features (``dir_bits`` Fibonacci codebook,
8-bit log magnitude) with the geometric straight-through estimator, and
cosine attention over the cutoff graph. Rounding passes gradient
straight through; a clip splits it at a bound as ``jnp.clip`` does.

The loss is the energy MSE plus ``force_weight`` times the force MSE,
plus ``lee_weight`` times the local equivariance error of the batch's
first molecule over the given rotations; forces are taken with a
differentiable input gradient, and the estimators on tensors that depend
on the coordinates follow the nested rule: they pass gradient in the
force pass and none in the parameter pass over it (the JAX package's
``custom_vjp`` semantics). The optimizer is AdamW with a global-norm
clip and a linear-warm-up cosine schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch.nn.functional import silu

from perfbench.reference.so3krates import (ModelDims, _div, _l2n,
                                           _layernorm, _log_bounds, _rbf,
                                           _vnorm, _f32, nearest_code)

__all__ = ["QatQuant", "TrainSpec", "energy", "loss", "loss_and_grads",
           "adamw_step", "rotations_from_quaternions"]


@dataclasses.dataclass(frozen=True)
class QatQuant:
    w_bits_eqv: int = 4
    w_bits_inv: int = 8
    a_bits: int = 8
    dir_bits: int = 12
    m_min: float = 1e-6
    m_max: float = 1e3


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    force_weight: float = 10.0
    lee_weight: float = 1.0
    lr: float = 1e-3
    total_steps: int = 480
    grad_clip: float = 10.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


# --- estimators -------------------------------------------------------------------

def _outer(nested: bool) -> bool:
    return nested and not torch.is_grad_enabled()


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, nested):
        ctx.nested = nested
        return torch.round(y)

    @staticmethod
    def backward(ctx, g):
        return (None if _outer(ctx.nested) else g), None


class _GeometricSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, q, nested):
        ctx.nested = nested
        ctx.save_for_backward(u)
        return q.clone()

    @staticmethod
    def backward(ctx, g):
        if _outer(ctx.nested):
            return None, None, None
        (u,) = ctx.saved_tensors
        return g - u * (u * g).sum(-1, keepdim=True), None, None


def _round(y: torch.Tensor, nested: bool) -> torch.Tensor:
    if nested:
        return _Round.apply(y, True)
    return y + (torch.round(y) - y).detach()


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _fake_quant(x: torch.Tensor, bits: int, scale: torch.Tensor,
                nested: bool) -> torch.Tensor:
    m = 2 ** (bits - 1) - 1
    return _round(_clip(x / scale, -m, m), nested) * scale


def _scale(amax: torch.Tensor, bits: int) -> torch.Tensor:
    return _div(torch.clamp(amax, min=1e-8), 2 ** (bits - 1) - 1)


def _qw(w: torch.Tensor, bits: int) -> torch.Tensor:
    return _fake_quant(w, bits, _scale(w.detach().abs().amax(0, keepdim=True),
                                       bits), False)


def _qact(x: torch.Tensor, bits: int, nested: bool) -> torch.Tensor:
    amax = x.detach().abs().amax(dim=(-2, -1), keepdim=True)
    return _fake_quant(x, bits, _scale(amax, bits), nested)


def _mddq(v: torch.Tensor, codebook: torch.Tensor, q: QatQuant,
          nested: bool) -> torch.Tensor:
    m = torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-24))
    u = v / torch.clamp(m, min=1e-12)
    flat = u.detach().reshape(-1, 3)
    x, y, z = flat[:, 0], flat[:, 1], flat[:, 2]
    unit = flat / torch.clamp(torch.sqrt((x * x + y * y) + z * z),
                              min=1e-12)[:, None]
    q_dir = codebook[nearest_code(unit, codebook)].reshape(v.shape)
    levels = 255
    lo, hi = _log_bounds(q)
    lm = torch.log(torch.clamp(m.detach(), _f32(q.m_min), _f32(q.m_max)))
    code = torch.clamp(torch.round((lm - lo) / _f32(hi - lo) * levels),
                       0, levels)
    m_q = torch.exp(lo + code / levels * _f32(hi - lo))
    out = (m + (m_q - m).detach()) * _GeometricSTE.apply(u, q_dir, nested)
    return torch.where(m <= 1e-12, torch.zeros_like(out), out)


# --- the dense QAT energy ------------------------------------------------------------

def energy(params: Dict[str, torch.Tensor], dims: ModelDims, q: QatQuant,
           species: torch.Tensor, coords: torch.Tensor,
           codebook: torch.Tensor, nested: bool) -> torch.Tensor:
    """Energies (...) of coords (..., n, 3); species (n,) long."""
    n = coords.shape[-2]
    rij = coords[..., None, :, :] - coords[..., :, None, :]
    d = torch.sqrt((rij ** 2).sum(-1) + 1e-12)
    eye = torch.eye(n, dtype=torch.bool, device=coords.device)
    mask = (d < dims.cutoff) & ~eye
    u = rij / d[..., None]
    rbf = _rbf(d, dims) * mask[..., None]

    x = params["embed"].index_select(0, species)
    x = x.expand(*coords.shape[:-1], dims.feat)
    v = coords.new_zeros(*coords.shape[:-1], dims.vec_feat, 3)
    inv, eqv, ab = q.w_bits_inv, q.w_bits_eqv, q.a_bits
    for i in range(dims.n_layers):
        L = f"layer{i}"
        xn = _layernorm(x, params[f"{L}/ln_g"], params[f"{L}/ln_b"])
        xn = _qact(xn, ab, nested and i > 0)
        qq = xn @ _qw(params[f"{L}/wq"], inv)
        kk = xn @ _qw(params[f"{L}/wk"], inv)
        bias = (rbf @ params[f"{L}/rbf_bias"])[..., 0]
        logits = dims.tau * torch.einsum("...if,...jf->...ij", _l2n(qq),
                                         _l2n(kk)) + bias
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
        alpha = torch.softmax(logits, dim=-1)
        msg = xn @ _qw(params[f"{L}/wm"], inv)
        gate = rbf @ params[f"{L}/rbf_m"]
        x = x + torch.einsum("...ij,...ijf->...if", alpha,
                             gate * msg[..., None, :, :])
        h = silu(_qact(x, ab, nested) @ _qw(params[f"{L}/w_upd1"], inv))
        x = x + h @ _qw(params[f"{L}/w_upd2"], inv)
        ca = (xn @ _qw(params[f"{L}/wa"], eqv))[..., None, :, :] \
            * (rbf @ params[f"{L}/rbf_a"])
        cb = (xn @ _qw(params[f"{L}/wb"], eqv))[..., None, :, :] \
            * (rbf @ params[f"{L}/rbf_b"])
        dv = torch.einsum("...ij,...ijc,...ijd->...icd", alpha, ca, u) \
            + torch.einsum("...ij,...ijc,...jcd->...icd", alpha, cb, v)
        v = _mddq(v + dv, codebook, q, nested)
        x = x + silu(_qact(_vnorm(v), ab, nested)) \
            @ _qw(params[f"{L}/w_vnorm"], inv)
    feats = torch.cat([x, _vnorm(v)], dim=-1)
    e_atom = silu(feats @ _qw(params["ro_w1"], inv)) @ params["ro_w2"]
    return e_atom.sum((-2, -1))


def _forces(params, dims, q, species, coords, codebook):
    with torch.enable_grad():
        c = coords.detach().requires_grad_()
        e = energy(params, dims, q, species, c, codebook, nested=True)
        (g,) = torch.autograd.grad(e.sum(), c, create_graph=True)
    return e, -g


def loss(params, dims, q, spec: TrainSpec, species, coords, e_ref, f_ref,
         rotations, codebook) -> torch.Tensor:
    e, f = _forces(params, dims, q, species, coords, codebook)
    total = ((e - e_ref) ** 2).mean() \
        + spec.force_weight * ((f - f_ref) ** 2).sum(-1).mean()
    if spec.lee_weight > 0:
        c0 = coords[0]
        lees = []
        for rot in rotations:
            f_rot_in = _forces(params, dims, q, species, c0 @ rot.T,
                               codebook)[1]
            rot_f = _forces(params, dims, q, species, c0, codebook)[1] @ rot.T
            lees.append(torch.linalg.norm(f_rot_in - rot_f))
        total = total + spec.lee_weight * torch.stack(lees).mean()
    return total


def loss_and_grads(params, *args):
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    value = loss(leaves, *args)
    grads = torch.autograd.grad(value, list(leaves.values()),
                                allow_unused=True)
    return value.detach(), {k: torch.zeros_like(p) if g is None else g
                            for (k, p), g in zip(leaves.items(), grads)}


def _lr(spec: TrainSpec, t: torch.Tensor) -> torch.Tensor:
    """Linear warm-up over the first twentieth of the steps, then cosine
    decay to 0, in float32."""
    warm = max(spec.total_steps // 20, 1)
    rise = spec.lr * t / torch.full_like(t, warm)
    prog = torch.clamp((t - warm) / torch.full_like(
        t, max(spec.total_steps - warm, 1)), 0.0, 1.0)
    fall = spec.lr * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(t < warm, rise, fall)


def adamw_step(spec: TrainSpec, params, grads, mu, nu, step: int):
    """One AdamW step (``step`` counts from 1), in float32 throughout:
    the global norm over the leaves in sorted order, the clip, the
    moments, the bias corrections. Returns (params, mu, nu, the clipped
    gradient)."""
    some = next(iter(params.values()))
    t = torch.tensor(float(step), device=some.device)
    gnorm = torch.sqrt(sum((grads[k] ** 2).sum() for k in sorted(grads)))
    scale = torch.minimum(torch.ones_like(gnorm),
                          torch.full_like(gnorm, spec.grad_clip)
                          / (gnorm + 1e-9))
    grads = {k: g * scale for k, g in grads.items()}
    lr = _lr(spec, t)
    bc1 = 1 - torch.full_like(t, spec.b1) ** t
    bc2 = 1 - torch.full_like(t, spec.b2) ** t
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = mu[k] * spec.b1 + g * (1 - spec.b1)
        n = nu[k] * spec.b2 + g * (1 - spec.b2) * g
        den = torch.sqrt(n / bc2) + spec.eps
        new_p[k] = p - (m / bc1) / den * lr
        new_mu[k], new_nu[k] = m, n
    return new_p, new_mu, new_nu, grads


def rotations_from_quaternions(quat: torch.Tensor) -> torch.Tensor:
    """(k, 4) quaternions (w, x, y, z), normalized here -> (k, 3, 3)."""
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    one = torch.ones_like(w)
    return torch.stack([
        torch.stack([one - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), one - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     one - 2 * (x * x + y * y)], -1)], dim=-2)


def lowered(q: QatQuant) -> QatQuant:
    """The control: the invariant weights one step lower (W8 -> W4)."""
    return dataclasses.replace(q, w_bits_inv=4)
