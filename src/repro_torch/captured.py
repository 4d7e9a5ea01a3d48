"""Captured programs: the port's counterpart of ``jax.jit``.

The reference serves each loop as one XLA executable per shape: the
engine's jitted forwards, the MD engine's jitted ``lax.scan`` segment, the
LM launcher's jitted decode step. On the card the counterpart is a CUDA
graph: the kernels of one call captured once per shape class and replayed
with one launch, so the host no longer issues them one by one.

A :class:`CapturedProgram` holds

- the **static inputs**: fixed-shape device buffers, cloned from the
  first call's inputs (a tree of tensors: dicts, tuples, NamedTuples;
  other leaves are passed through as constants);
- the **graph**, captured after one eager warm-up run on a side stream
  (the run ``torch.cuda.graph`` needs: it builds the kernels, cuBLAS's
  workspace and the program's own K6 ticket buffer outside the graph's
  memory, kept in :attr:`buffers` for the program's life, since the
  graph holds its pointer). The warm-up runs on the static inputs, so its result is the
  first call's; all graphs of one owner (an engine, an MD engine, a
  served LM) share the owner's memory pool (:func:`new_pool`);
- the **static outputs**: what the captured call returned, overwritten
  by each replay;
- :attr:`launches`: per kernel counter, the launches made while
  capturing. Capturing adds nothing to the process tallies of
  ``kernels._launch``; each :meth:`replay` adds these, under the calling
  thread's launch role, so the counts stay "launches executed on the
  card".

:meth:`replay` copies the inputs into the buffers (an input that is the
buffer itself is not copied), replays on the caller's current stream and
returns the static outputs. Replays of one owner's programs must not run
concurrently (they share the pool), and their outputs must be read or
copied before the next replay. An input named in ``donate`` is not
copied: its tensors, already on the device, are the program's buffers
(the counterpart of ``donate_argnums``), so programs that carry one
state share it (:class:`Programs`).

Each thread warms up and captures on a stream of its own (one of
PyTorch's high-priority pooled streams, which nothing else in the port
takes, handed to no two live threads: a kernel another thread launched
on a capturing stream would land in the graph), in the
``"thread_local"`` capture error mode, so a cluster's replicas capture
in parallel threads, and while one thread captures, another may
allocate, copy, synchronize or capture for its own work without
invalidating the capture (the default ``"global"`` mode would forbid
it). Each capture keeps its own launch tally, keyed by its stream, and
while any capture is open Python's cyclic collector is off: a collection
in a capturing thread could destroy an earlier graph (its finalizer
calls into CUDA, which a capture forbids in that thread) and so
invalidate the capture. A capture that fails raises
``RuntimeError`` naming the program: nothing falls back to eager on the
card. On a CPU device the constructor raises, and the callers run their
eager functions there, as before.

:class:`Programs` holds one owner's programs by key, in one pool, with
the state they carry: the trainers' steps, the SO3 evaluation's batch,
the LEE force call and the NVE segment, which the reference jits. On
the CPU it calls the same functions eagerly.

Leaves may be DTensors (the LM launcher's state on its device mesh):
their buffers are compared, copied and cloned through their local
tensors' storage, with their placements kept.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Any, Callable, Dict, Hashable, Iterable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels._launch import (add_launches, capturing_launches,
                                        owning_buffers)

__all__ = ["CapturedProgram", "Programs", "new_pool", "pool_bytes",
           "map_tensors", "tree_tensors", "copy_into", "clone_tree"]

_STREAMS_LOCK = threading.Lock()
# (device index, raw stream) -> the thread that warms up and captures on it
_STREAMS: Dict[tuple, threading.Thread] = {}
_MINE = threading.local()


def _capture_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The calling thread's warm-up and capture stream on ``dev``: a
    high-priority pooled stream that no other live thread holds."""
    mine = _MINE.__dict__.setdefault("streams", {})
    if dev.index in mine:
        return mine[dev.index]
    me = threading.current_thread()
    with _STREAMS_LOCK:
        for _ in range(64):            # PyTorch pools 32 per priority
            stream = torch.cuda.Stream(dev, priority=-1)
            key = (dev.index, stream.cuda_stream)
            holder = _STREAMS.get(key)
            if holder is None or not holder.is_alive():
                _STREAMS[key] = me
                mine[dev.index] = stream
                return stream
    raise RuntimeError("every high-priority stream is held by a live "
                       "capturing thread")


_GC_LOCK = threading.Lock()
_GC_HOLDS = [0, True]        # open captures, the collector's state before
# A graph's capture_begin adds it to the CUDA generator's set of graphs and
# its destructor takes it out; on the card's torch (2.11) neither holds a
# lock, so threads that capture while others drop programs (a cluster's
# replicas) could corrupt the set and abort the process in a destructor.
# Both run under this lock.
_GRAPHS_LOCK = threading.RLock()


@contextlib.contextmanager
def _collector_off():
    """The cyclic collector off while any capture is open."""
    with _GC_LOCK:
        if _GC_HOLDS[0] == 0:
            _GC_HOLDS[1] = gc.isenabled()
            gc.disable()
        _GC_HOLDS[0] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_HOLDS[0] -= 1
            if _GC_HOLDS[0] == 0 and _GC_HOLDS[1]:
                gc.enable()


def new_pool():
    """A memory pool handle for one owner's graphs."""
    return torch.cuda.graph_pool_handle()


def pool_bytes(pool) -> Optional[int]:
    """Bytes the caching allocator holds in ``pool``'s segments (None
    where the allocator's snapshot does not name pools)."""
    try:
        segments = torch.cuda.memory_snapshot()
    except (RuntimeError, AttributeError):
        return None
    want = tuple(pool)
    total, named = 0, False
    for seg in segments:
        if "segment_pool_id" not in seg:
            continue
        named = True
        if tuple(seg["segment_pool_id"]) == want:
            total += int(seg["total_size"])
    return total if named else None


def map_tensors(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the matching leaves
    of ``rest``), keeping dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_tensors(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out) if isinstance(tree, tuple) else out
    return tree


def tree_tensors(tree):
    """The tensor leaves of ``tree``, in :func:`map_tensors`' order."""
    out = []
    map_tensors(lambda t: out.append(t), tree)
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (its storage; a DTensor's own
    ``data_ptr()`` reads 0), or ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def copy_into(dst, src) -> None:
    """Copy the tensor leaves of ``src`` into those of ``dst`` (same
    structure), skipping a leaf that already is its destination."""
    def copy(d, s):
        if d is not s and _local(d).data_ptr() != _local(s).data_ptr():
            d.copy_(s)
        return d
    map_tensors(copy, dst, src)


def clone_tree(tree, device: Optional[torch.device] = None):
    """Fresh buffers holding ``tree``'s tensor leaves (on ``device``, or
    each leaf's own), detached; a DTensor stays a DTensor of the same
    placements."""
    def clone(t):
        return torch.empty_like(t, device=device or t.device).copy_(
            t.detach())
    return map_tensors(clone, tree)


class CapturedProgram:
    """One call of ``fn(**inputs)`` captured as a CUDA graph.

    ``fn`` must be capturable: no host sync, no host-to-device copy of
    pageable memory, no host value read from a device tensor. ``inputs``
    maps names to trees of tensors (on any device: they are copied to
    ``device``), but for those named in ``donate``, which are the
    program's buffers as they are; ``name`` labels errors. Construction
    copies the inputs into the static buffers, runs ``fn`` on them once
    eagerly (its result kept as :attr:`first_result`) and captures, and
    records the seconds of each: :attr:`warmup_seconds` and
    :attr:`capture_seconds`, which :attr:`instantiate_seconds` (the
    graph's instantiation) ends.
    """

    def __init__(self, fn: Callable[..., Any], inputs: Dict[str, Any], *,
                 device: torch.device, pool=None, name: str = "program",
                 donate: Iterable[str] = ()):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise RuntimeError(f"{name}: a captured program needs a CUDA "
                               f"device, got {dev}; the CPU runs eager")
        self.name = name
        self.device = dev
        t0 = time.perf_counter()
        caller = torch.cuda.current_stream(dev)
        donate = set(donate)
        for k in donate:
            if any(t.device != dev for t in tree_tensors(inputs[k])):
                raise ValueError(f"{name}: the donated input {k!r} is not "
                                 f"all on {dev}")
        self.static = {k: v if k in donate else clone_tree(v, dev)
                       for k, v in inputs.items()}
        self.graph = torch.cuda.CUDAGraph()
        side = _capture_stream(dev)
        side.wait_stream(caller)
        # kernels' persistent buffers, made in the warm-up, used by the graph
        self.buffers: Dict[Any, torch.Tensor] = {}
        with torch.cuda.stream(side), \
                owning_buffers(side.cuda_stream, self.buffers):
            # the warm-up: counted launches, on the capture's stream
            self.first_result = fn(**self.static)
        map_tensors(lambda t: _local(t).record_stream(caller),
                    self.first_result)
        side.synchronize()
        t1 = time.perf_counter()
        self._capture(fn, side, pool)
        caller.wait_stream(side)
        t2 = time.perf_counter()
        # the warm-up run, and the capture with its instantiation
        self.warmup_seconds, self.capture_seconds = t1 - t0, t2 - t1

    def _capture(self, fn, side, pool) -> None:
        name = self.name
        # the warm-up's freed blocks stay cached for the default pool, which
        # a graph's private pool cannot draw on, and the allocator frees no
        # cached block while a capture is open: release them first, as
        # torch.cuda.graph does, unless another thread is capturing
        with _GC_LOCK:
            if _GC_HOLDS[0] == 0:
                torch.cuda.empty_cache()
        with capturing_launches(side.cuda_stream) as tally, \
                owning_buffers(side.cuda_stream, self.buffers), \
                _collector_off():
            with torch.cuda.stream(side):
                with _GRAPHS_LOCK:
                    self.graph.capture_begin(
                        pool=pool, capture_error_mode="thread_local")
                try:
                    self.outputs = fn(**self.static)
                except BaseException as exc:
                    try:
                        self.graph.capture_end()
                    except RuntimeError:
                        pass
                    raise RuntimeError(
                        f"capture of {name} failed: {exc}") from exc
                t = time.perf_counter()
                try:
                    self.graph.capture_end()
                except RuntimeError as exc:
                    raise RuntimeError(
                        f"capture of {name} failed: {exc}") from exc
                self.instantiate_seconds = time.perf_counter() - t
        self.launches = dict(tally)

    def __del__(self):
        graph = self.__dict__.pop("graph", None)
        if graph is not None:
            with _GRAPHS_LOCK:          # its destructor, if this is the last
                del graph               # reference (see _GRAPHS_LOCK)

    def launch_counts(self) -> Dict[str, int]:
        """:attr:`launches` by counter name (``fn.__name__``, or
        ``"<name>.<attr>"`` for a counter other than ``launches``)."""
        return {(fn.__name__ if attr == "launches"
                 else f"{fn.__name__}.{attr}"): n
                for (fn, attr), n in self.launches.items()}

    def replay(self, **inputs):
        """Copy ``inputs`` into the static buffers, replay the graph on the
        current stream, add :attr:`launches` to the counts and return the
        static outputs."""
        for k, v in inputs.items():
            copy_into(self.static[k], v)
        self.graph.replay()
        add_launches(self.launches)
        return self.outputs


class Programs:
    """One owner's captured programs by key, in one graph pool, and the
    state they carry from call to call: the counterpart of the
    reference's jitted functions (``jax.jit``; with ``donate_argnums``
    where a state is carried).

    :meth:`run` calls ``fn(**inputs)``, with ``state=`` :attr:`state`
    first when the owner carries one, as the program of ``key``: on a
    CUDA device captured on the key's first call (the capture's eager
    warm-up is that call, and its result the call's) and replayed after;
    on the CPU ``fn`` runs eagerly. A body that carries the state ends by
    copying its new state into the tensors of the ``state`` it was given
    (:func:`copy_into`). Those tensors are donated to every program, so
    all of the owner's programs read and write the same buffers: give a
    state that nothing else writes (a clone of a tree the caller keeps).
    A replay's outputs are its program's static outputs, overwritten by
    its next replay: read or clone them before that. A capture that fails
    raises; nothing falls back to eager on the card.
    """

    def __init__(self, *, device: torch.device, name: str, state=None):
        self.device = torch.device(device)
        self.name = name
        self.state = state
        self.programs: Dict[Hashable, CapturedProgram] = {}
        self.pool = None

    def run(self, key: Hashable, fn: Callable[..., Any], **inputs):
        """``fn``'s outputs for ``inputs`` through the program of ``key``
        (eagerly on the CPU)."""
        if self.state is not None:
            inputs = dict(state=self.state, **inputs)
        if self.device.type != "cuda":
            return fn(**inputs)
        prog = self.programs.get(key)
        if prog is not None:
            return prog.replay(**inputs)
        if self.pool is None:
            self.pool = new_pool()
        prog = CapturedProgram(fn, inputs, device=self.device, pool=self.pool,
                               name=f"{self.name} [{key}]",
                               donate=() if self.state is None
                               else ("state",))
        self.programs[key] = prog
        return prog.first_result
