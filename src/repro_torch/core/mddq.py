"""Magnitude-Direction Decoupled Quantization (MDDQ), paper Definition 3.1.

Counterpart of ``repro/core/mddq.py``: Q(v) = Q_m(|v|) * Q_d(v / |v|),
with a fake-quant path (Geometric STE, for QAT and serve-time
quantize-dequantize) and a real path (integer codes).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.codebook import make_codebook, nearest_code
from repro_torch.core.quantizers import (abs_max_scale,
                                         dequantize_log_magnitude,
                                         fake_quant_ste,
                                         quantize_log_magnitude)
from repro_torch.core.ste import geometric_ste_direction, identity_ste

__all__ = ["MDDQConfig", "mddq_fake_quant", "fake_quant_from_codes",
           "mddq_encode", "mddq_decode"]

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class MDDQConfig:
    direction_bits: int = 8          # codebook size = 2**direction_bits
    magnitude_bits: int = 8
    codebook_kind: str = "fibonacci"
    magnitude_domain: str = "log"     # or "linear"
    geometric_ste: bool = True        # False -> plain STE (ablation)
    m_min: float = 1e-6
    m_max: float = 1e3

    def codebook(self, device="cpu") -> torch.Tensor:
        return make_codebook(self.direction_bits, self.codebook_kind, device)


def _split(v: torch.Tensor):
    # NaN-safe norm: d|v|/dv at v = 0 is 0/0; clamping the squared norm
    # before the sqrt makes the gradient exactly zero there instead, so
    # zero vectors (isolated atoms, padded batch slots) stay differentiable.
    m2 = (v * v).sum(-1, keepdim=True)
    m = torch.sqrt(torch.clamp(m2, min=_EPS * _EPS))
    u = v / torch.clamp(m, min=_EPS)
    return m, u


def fake_quant_from_codes(v: torch.Tensor, cfg: MDDQConfig,
                          q_dir: torch.Tensor, m_q: torch.Tensor,
                          nested: bool = False) -> torch.Tensor:
    """The log-domain fake-quant output for given codes: forward value
    ``m_q * q_dir`` (0 for zero vectors), gradient the straight-through
    magnitude plus the Geometric-STE (or identity) direction estimator.
    q_dir: (..., 3) codewords; m_q: (..., 1) decoded magnitudes.
    ``nested``: see ``core.ste``."""
    m, u = _split(v)
    ste = geometric_ste_direction if cfg.geometric_ste else identity_ste
    u_hat = ste(u, q_dir, nested)
    m_hat = m + (m_q - m).detach()
    # zero vectors stay zero (direction undefined); <= because the safe
    # norm in _split floors m at exactly _EPS for v == 0
    out = m_hat * u_hat
    return torch.where(m <= _EPS, torch.zeros_like(out), out)


def mddq_fake_quant(v: torch.Tensor, cfg: MDDQConfig,
                    codebook: Optional[torch.Tensor] = None,
                    nested: bool = False) -> torch.Tensor:
    """Differentiable MDDQ. v: (..., 3) -> (..., 3).

    Gradients: straight-through on the magnitude; Geometric STE (tangent
    projection) on the direction unless ``cfg.geometric_ste`` is False.
    ``nested``: see ``core.ste``.
    """
    if codebook is None:
        codebook = cfg.codebook(v.device)
    m, u = _split(v)
    q_dir = codebook[nearest_code(u.detach(), codebook)]
    if cfg.magnitude_domain == "log":
        code = quantize_log_magnitude(m.detach(), cfg.magnitude_bits,
                                      cfg.m_min, cfg.m_max)
        m_q = dequantize_log_magnitude(code, cfg.magnitude_bits,
                                       cfg.m_min, cfg.m_max)
        return fake_quant_from_codes(v, cfg, q_dir, m_q, nested)
    ste = geometric_ste_direction if cfg.geometric_ste else identity_ste
    out = fake_quant_ste(m, cfg.magnitude_bits, nested=nested) \
        * ste(u, q_dir, nested)
    return torch.where(m <= _EPS, torch.zeros_like(out), out)


def mddq_encode(v: torch.Tensor, cfg: MDDQConfig,
                codebook: Optional[torch.Tensor] = None):
    """Real encoding: (..., 3) -> (dir_idx int32, mag_code int32), each
    of shape (...)."""
    if codebook is None:
        codebook = cfg.codebook(v.device)
    m, u = _split(v)
    dir_idx = nearest_code(u, codebook)
    if cfg.magnitude_domain == "log":
        mag = quantize_log_magnitude(m[..., 0], cfg.magnitude_bits,
                                     cfg.m_min, cfg.m_max)
    else:
        scale = abs_max_scale(m, cfg.magnitude_bits)
        mag = torch.clamp(torch.round(m[..., 0] / scale), 0,
                          2 ** cfg.magnitude_bits - 1).to(torch.int32)
    return dir_idx, mag


def mddq_decode(dir_idx: torch.Tensor, mag_code: torch.Tensor,
                cfg: MDDQConfig,
                codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    if codebook is None:
        codebook = cfg.codebook(dir_idx.device)
    if cfg.magnitude_domain != "log":
        raise NotImplementedError("linear-domain decode requires stored scale")
    u = codebook[dir_idx]
    m = dequantize_log_magnitude(mag_code, cfg.magnitude_bits,
                                 cfg.m_min, cfg.m_max)
    return u * m[..., None]
