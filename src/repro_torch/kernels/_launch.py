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

The counts are of launches executed on the card. A kernel launched while
a CUDA graph is being captured does not run then: a call made on a stream
that :func:`capturing_launches` has opened for a capture is tallied for
that capture instead (the autograd engine's backward thread launches on
the forward's stream, so it is seen too), and each replay of the graph
adds that tally to the counts and to the replaying thread's role
(:func:`add_launches`). Captures in other threads, on other streams, each
keep their own tally.

A kernel that keeps a buffer across calls (K6's split-combine tickets)
keeps it per stream; but while a program is warmed up and captured on a
stream (:func:`owning_buffers`), it keeps it in the program's own store
instead (:func:`owned_buffers`). A graph holds the raw pointer and no
reference to the tensor, so a buffer a graph may use must live as long
as the graph: a per-stream one would be replaced, and freed, by a later
call that needs a larger one.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

_COUNT_LOCK = threading.Lock()
_ROLE = threading.local()
_ROLE_LAUNCHES: Dict[str, Dict[str, int]] = {}
# the open captures' tallies, {(fn, attr): launches}, by capturing stream
Tally = Dict[Tuple[Callable, str], int]
_CAPTURES: Dict[int, Tally] = {}
# the stores of the programs being warmed up and captured, by stream
_OWNERS: Dict[int, dict] = {}


def count_launch(fn, attr: str = "launches") -> None:
    """``fn.<attr> += 1``, atomic across threads, and the same in the
    calling thread's role tally (key ``fn.__name__``, or
    ``"<name>.<attr>"`` for another attribute than ``launches``); on a
    stream being captured, one more in the capture's tally instead."""
    if _CAPTURES:
        tally = _CAPTURES.get(torch.cuda.current_stream().cuda_stream)
        if tally is not None:
            with _COUNT_LOCK:
                tally[(fn, attr)] = tally.get((fn, attr), 0) + 1
            return
    add_launches({(fn, attr): 1})


def add_launches(tally: Tally) -> None:
    """Add ``tally`` ({(fn, attr): n}) to the counts and to the calling
    thread's role: one replay of a captured program."""
    role: Optional[str] = getattr(_ROLE, "name", None)
    with _COUNT_LOCK:
        for (fn, attr), n in tally.items():
            setattr(fn, attr, getattr(fn, attr) + n)
            if role is not None:
                key = fn.__name__ if attr == "launches" \
                    else f"{fn.__name__}.{attr}"
                t = _ROLE_LAUNCHES.setdefault(role, {})
                t[key] = t.get(key, 0) + n


@contextlib.contextmanager
def capturing_launches(stream: int):
    """Open a capture's tally for the block: the launches made on
    ``stream`` (a raw stream handle) go to the yielded dict, not to the
    counts."""
    tally: Tally = {}
    with _COUNT_LOCK:
        if stream in _CAPTURES:
            raise RuntimeError("a launch tally is already open on this "
                               "stream")
        _CAPTURES[stream] = tally
    try:
        yield tally
    finally:
        with _COUNT_LOCK:
            del _CAPTURES[stream]


@contextlib.contextmanager
def owning_buffers(stream: int, store: dict):
    """Inside the block, kernels called on ``stream`` (a raw stream
    handle) keep their persistent buffers in ``store``, a program's."""
    with _COUNT_LOCK:
        if stream in _OWNERS:
            raise RuntimeError("a buffer store is already open on this "
                               "stream")
        _OWNERS[stream] = store
    try:
        yield store
    finally:
        with _COUNT_LOCK:
            del _OWNERS[stream]


def owned_buffers(stream: int) -> Optional[dict]:
    """The store :func:`owning_buffers` opened on ``stream``, or None."""
    with _COUNT_LOCK:
        return _OWNERS.get(stream)


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


def check_position(name: str, pos: torch.Tensor,
                   device: torch.device) -> None:
    """A position read on the device: a 0-d int32 tensor on ``device``."""
    if pos.dtype != torch.int32 or pos.dim() != 0:
        raise TypeError(f"{name}: a device position is a 0-d int32 tensor, "
                        f"got {pos.dtype} of shape {tuple(pos.shape)}")
    if pos.device != device:
        raise ValueError(f"{name}: on {pos.device}, expected {device}")


def stream_of(device: torch.device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
