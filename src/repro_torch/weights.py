"""Parameters crossing between the JAX package and the port as numpy.

The port never reproduces JAX's random bits: a JAX parameter tree is
handed over as ``{name: np.asarray(leaf)}`` and turned into the port's
tensors here, so both packages compute on the same weights.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["params_from_numpy"]


def params_from_numpy(params: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``{name: array}`` -> ``{name: float32 tensor on device}``."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(w, dtype=np.float32)).to(dev)
            for name, w in params.items()}
