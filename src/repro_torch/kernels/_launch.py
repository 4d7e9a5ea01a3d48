"""Argument checks and launch counting shared by the kernel wrappers.

A wrapper hands raw pointers to a CUDA kernel, so everything the kernel
assumes (device, dtype, shape, contiguity) is checked here first and a
violation raises instead of reaching the card.

Each wrapper counts its launches in an attribute of its function
(``w8a8_matmul_f32a.launches``): callers set it to 0 and read it. Cluster
replicas and the autograd engine launch from several threads, and a bare
``+= 1`` is a read-modify-write that can lose a count between threads, so
:func:`count_launch` adds under one lock.

A thread may also name the work it launches for with :func:`launch_role`
(a cluster replica's worker: ``"flush:w4a8"``, ``"chunk:w4a8"``,
``"warmup:fp32"``); its launches are then tallied under that role as well,
so one window's launches split by the path that made them
(:func:`role_launches`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence

import torch

_COUNT_LOCK = threading.Lock()
_ROLE = threading.local()
_ROLE_LAUNCHES: Dict[str, Dict[str, int]] = {}


def count_launch(fn, attr: str = "launches") -> None:
    """``fn.<attr> += 1``, atomic across threads, and the same in the
    calling thread's role tally (key ``fn.__name__``, or
    ``"<name>.<attr>"`` for another attribute than ``launches``)."""
    role: Optional[str] = getattr(_ROLE, "name", None)
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)
        if role is not None:
            key = fn.__name__ if attr == "launches" \
                else f"{fn.__name__}.{attr}"
            tally = _ROLE_LAUNCHES.setdefault(role, {})
            tally[key] = tally.get(key, 0) + 1


@contextlib.contextmanager
def launch_role(role: str):
    """Tally the calling thread's launches inside the block under
    ``role`` too (nested blocks: the innermost role)."""
    prev = getattr(_ROLE, "name", None)
    _ROLE.name = role
    try:
        yield
    finally:
        _ROLE.name = prev


def role_launches() -> Dict[str, Dict[str, int]]:
    """{role: {counter: launches}} since :func:`reset_role_launches`."""
    with _COUNT_LOCK:
        return {r: dict(t) for r, t in _ROLE_LAUNCHES.items()}


def reset_role_launches() -> None:
    with _COUNT_LOCK:
        _ROLE_LAUNCHES.clear()


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: Sequence[int], device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_of(device: torch.device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
