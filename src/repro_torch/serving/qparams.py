"""Serve-time quantized parameters for the SO3krates force field.

Counterpart of ``repro/serving/qparams.py``. Each matmul weight is stored
as int8 (W8) or nibble-packed int4 (W4) plus a per-output-channel float32
scale and consumed by the quantized-matmul kernels. In ``w4a8`` mode the
equivariant-branch coefficient matrices (``wa``/``wb``) take W4 and every
other projection W8; the embedding, layernorm parameters, radial gates
and the energy head ``ro_w2`` stay float32.

``qmatmul`` is the entry the serving forward uses: forward through the
kernels (plain versions on CPU tensors), backward straight through
against the dequantized weight, so forces ``F = -dE/dr`` differentiate
through the integer forward.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.core.quantizers import unpack_int4
from repro_torch.kernels import ops, ref

__all__ = ["QTensor", "QuantPolicy", "QuantizedParams", "qmatmul",
           "ref_qmatmul", "concat_qtensors", "quantize_so3_params",
           "serving_bytes", "fp32_bytes", "serving_fp32_equiv"]

# names of the equivariant-branch coefficient matrices (paper: W4 in w4a8)
_EQV_SUFFIXES = ("/wa", "/wb")
# matmul weights consumed by qmatmul; everything else stays fp32
_MATMUL_SUFFIXES = ("/wq", "/wk", "/wm", "/w_upd1", "/w_upd2", "/w_vnorm",
                    "/wa", "/wb")
_MATMUL_GLOBALS = ("ro_w1",)


class QTensor:
    """A weight in its serving representation.

    kind: "fp" -> data = fp32 (K, N), scale unused
          "w8" -> data = int8 (K, N), scale = fp32 (1, N) per column
          "w4" -> data = uint8 (K, N//2) nibble-packed, scale = fp32 (1, N)
    """

    def __init__(self, kind: str, data: torch.Tensor,
                 scale: Optional[torch.Tensor] = None):
        self.kind = kind
        self.data = data
        self.scale = scale

    @property
    def out_features(self) -> int:
        return self.data.shape[1] * (2 if self.kind == "w4" else 1)

    @property
    def nbytes(self) -> int:
        n = self.data.numel() * self.data.element_size()
        return n + (0 if self.scale is None else self.scale.numel() * 4)

    def dequantize(self) -> torch.Tensor:
        """fp32 view of the stored weight (the straight-through backward
        and the reference forward use it)."""
        if self.kind == "fp":
            return self.data
        if self.kind == "w8":
            return self.data.to(torch.float32) * self.scale
        if self.kind == "w4":
            return unpack_int4(self.data).to(torch.float32) * self.scale
        raise ValueError(self.kind)


QuantizedParams = Dict[str, Union[QTensor, torch.Tensor]]


def _qmm_kernel(kind, x, data, scale):
    if kind == "fp":
        return x @ data
    if kind == "w8":
        return ops.matmul_w8a8(x, data, scale)
    if kind == "w4":
        return ops.matmul_w4a8(x, data, scale)
    raise ValueError(kind)


def _qmm_ref(kind, x, data, scale):
    if kind == "fp":
        return x @ data
    a_q, a_s = ops.quantize_activations(x)
    mm = ref.w8a8_matmul_ref if kind == "w8" else ref.w4a8_matmul_ref
    return mm(a_q, a_s, data, scale)


class _QMatmul(torch.autograd.Function):
    """Integer forward, straight-through backward: gx = g @ dequant(W)^T;
    the weights are frozen at serve time and get no gradient."""

    @staticmethod
    def forward(ctx, x, impl, qt: QTensor):
        ctx.qt = qt
        return impl(qt.kind, x, qt.data, qt.scale)

    @staticmethod
    def backward(ctx, g):
        return g @ ctx.qt.dequantize().T, None, None


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y = x @ W for a serving-format weight. x: (M, K) f32 -> (M, N) f32.

    W8/W4 kinds run the quantized-matmul kernels (per-row dynamic A8
    activations, exact integer accumulation); ``fp`` weights a plain
    matmul. Differentiable through the straight-through backward.
    """
    return _QMatmul.apply(x, _qmm_kernel, qt)


def ref_qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The plain reference with the semantics of :func:`qmatmul` (same A8
    codes, exact integer products in float64) and the same backward."""
    return _QMatmul.apply(x, _qmm_ref, qt)


def concat_qtensors(qts) -> QTensor:
    """Fuse weights along the output axis: ``x @ [W1|W2|...]`` equals the
    per-weight matmuls column for column, because activation scales are
    per row and weight scales per column (and each packed W4 width is a
    whole number of bytes). Inputs share kind and input dimension."""
    kind = qts[0].kind
    if any(q.kind != kind for q in qts):
        raise ValueError(f"mixed kinds {[q.kind for q in qts]}")
    if any(q.data.shape[0] != qts[0].data.shape[0] for q in qts):
        raise ValueError("mismatched input dims")
    data = torch.cat([q.data for q in qts], dim=1)
    if kind == "fp":
        return QTensor("fp", data)
    return QTensor(kind, data, torch.cat([q.scale for q in qts], dim=1))


class QuantPolicy:
    """Maps a SO3krates parameter name to its serving kind for a mode."""

    def __init__(self, mode: str):
        if mode not in ("fp32", "w8a8", "w4a8"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode

    def kind_of(self, name: str, w: torch.Tensor) -> str:
        is_matmul = (name.endswith(_MATMUL_SUFFIXES)
                     or name in _MATMUL_GLOBALS)
        if self.mode == "fp32" or not is_matmul or w.ndim != 2:
            return "fp"
        if (self.mode == "w4a8" and name.endswith(_EQV_SUFFIXES)
                and w.shape[1] % 2 == 0):
            return "w4"
        return "w8"


def quantize_so3_params(params: Dict[str, torch.Tensor],
                        mode: str) -> QuantizedParams:
    """Convert fp32 SO3krates parameters to serving format: matmul weights
    become :class:`QTensor`s (``ops.prepare_w8`` / ``prepare_w4``),
    everything else passes through as float32 tensors."""
    policy = QuantPolicy(mode)
    out: QuantizedParams = {}
    for name, w in params.items():
        kind = policy.kind_of(name, w)
        if kind == "w8":
            out[name] = QTensor("w8", *ops.prepare_w8(w))
        elif kind == "w4":
            out[name] = QTensor("w4", *ops.prepare_w4(w))
        elif name.endswith(_MATMUL_SUFFIXES) or name in _MATMUL_GLOBALS \
                or name == "ro_w2":
            out[name] = QTensor("fp", w)
        else:
            out[name] = w
    return out


def serving_bytes(qparams: QuantizedParams) -> int:
    """Total parameter bytes in the serving representation."""
    return sum(v.nbytes if isinstance(v, QTensor)
               else v.numel() * v.element_size() for v in qparams.values())


def fp32_bytes(params: Dict[str, torch.Tensor]) -> int:
    return sum(v.numel() * 4 for v in params.values())


def serving_fp32_equiv(qparams: QuantizedParams) -> int:
    """fp32 byte count the qparams tree *would* occupy: the logical
    (unpacked, unscaled) element count at 4 bytes/element. Used when an
    engine is built straight from a packed artifact and no fp32 tree
    ever existed to measure."""
    total = 0
    for v in qparams.values():
        if isinstance(v, QTensor):
            total += (v.data.shape[0] * v.out_features * 4
                      if v.data.ndim == 2 else v.data.numel() * 4)
        else:
            total += v.numel() * 4
    return total
