"""Device rule of the port.

Every entry point (``QuantizedEngine.from_config``, ``init_params``, the
forward functions) runs on ``cuda`` unless the caller passes
``device="cpu"``. With no GPU and no explicit CPU request it raises: the
port never quietly runs on the CPU.

Float32 matrix products stay in full float32 on the card: TF32 is turned
off for cuBLAS and cuDNN here, once, when the package is imported
(``repro_torch/__init__.py``), because every parity tolerance of the
port is stated for float32 arithmetic.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "disable_tf32"]

DeviceLike = Union[str, torch.device, None]


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device, or raise when there is none;
    an explicit device is taken as given (a CUDA one must exist), and
    ``"cuda"`` with no index means the current CUDA device, so every
    resolved CUDA device has an index (``torch.cuda.set_device`` and
    tensor-device comparisons need one)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
