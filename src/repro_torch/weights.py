"""Parameters crossing between the JAX package and the port as numpy.

The port never reproduces JAX's random bits: a JAX parameter tree is
handed over as ``{name: np.asarray(leaf)}`` and turned into the port's
tensors here, so both packages compute on the same weights.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["params_from_numpy", "lm_params_from_numpy"]


def params_from_numpy(params: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``{name: array}`` -> ``{name: float32 tensor on device}``."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(w, dtype=np.float32)).to(dev)
            for name, w in params.items()}


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
        a = np.asarray(node)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(dev)
    return convert(tree)
