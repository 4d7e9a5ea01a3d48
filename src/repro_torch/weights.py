"""Parameters crossing between the JAX package and the port as numpy.

The port never reproduces JAX's random bits: a JAX parameter tree is
handed over as ``{name: np.asarray(leaf)}`` and turned into the port's
tensors here, so both packages compute on the same weights. Serving-
format trees (quantized codes and scales, as a packed artifact holds
them) cross through :func:`qparams_from_numpy`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.qparams import QTensor

__all__ = ["params_from_numpy", "lm_params_from_numpy", "qparams_from_numpy"]


def params_from_numpy(params: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``{name: array}`` -> ``{name: float32 tensor on device}``."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(w, dtype=np.float32)).to(dev)
            for name, w in params.items()}


def _leaf(a, dev: torch.device) -> torch.Tensor:
    """A numpy leaf on ``dev``: float leaves as float32, integer leaves
    (int8 codes, uint8 nibbles) in their own dtype."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(dev)


def qparams_from_numpy(tree: Mapping[str, Any],
                       device: DeviceLike = None) -> Dict[str, Any]:
    """A serving-format SO3krates tree as numpy -> the port's
    ``QuantizedParams`` on ``device``. Each leaf is either QTensor-like
    (an object with ``kind``, ``data`` and ``scale``, such as the JAX
    package's ``QTensor``, or a ``(kind, data, scale)`` tuple) and
    becomes a :class:`~repro_torch.serving.qparams.QTensor`, or an array
    and becomes a tensor. Codes keep their integer dtype, so the port
    serves the same bytes."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for name, v in tree.items():
        if hasattr(v, "kind"):
            v = (v.kind, v.data, v.scale)
        if isinstance(v, tuple):
            kind, data, scale = v
            out[name] = QTensor(kind, _leaf(data, dev),
                                None if scale is None else _leaf(scale, dev))
        else:
            out[name] = _leaf(v, dev)
    return out


def lm_params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """An LM parameter tree as nested dicts of numpy arrays, with
    ``(q, scale)`` tuples where quantized, -> the same tree of tensors on
    ``device``. Integer leaves keep their dtype (int8 codes, uint8
    nibbles); float leaves become float32."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(convert(v) for v in node)
        return _leaf(node, dev)
    return convert(tree)
