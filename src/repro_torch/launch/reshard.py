"""Reshard where DTensor refuses: the dry run's counterpart of the
reshards GSPMD inserts.

The reference's rules (``launch/sharding.py``) put a projection's output
on the model axis whatever its head count. Where a later reshape cannot
keep that split (7 heads over a model axis of 2), XLA's GSPMD inserts a
reshard and compiles on; DTensor refuses instead ("Please redistribute
the tensor before this operation"), or, in older releases, plans shards
of the wrong size that the local op then rejects. :class:`ReshardMode`
is a ``TorchDispatchMode`` that does what that message asks. It calls
each aten op that has DTensor arguments; if DTensor's dispatch of the op
raises (its sharding propagation, its redistribute planner, or the local
op on the shards it planned), it replicates the op's DTensor arguments
one placement at a time and retries after each: the arguments in order
of local bytes, smallest first, and on each the ``model`` mesh dim
first, then ``data``, then ``pod``. A ``Shard`` (or strided shard)
becomes an all-gather, a ``Partial`` an all-reduce. The first retry that
succeeds ends the search, so the fewest bytes move. An argument the op
writes in place is resharded in place: the same DTensor, holding the
same global value, now on the new placements. Where DTensor has no rule
for the op at all (``NotImplementedError``), the op runs on the full
tensors of its replicated arguments and its result is replicated, as
GSPMD replicates an op it cannot partition; so does an op whose rule
gives its output placements that do not fit the mesh (torch 2.11 pads a
tensor on a 2-D mesh to one placement), the first such output taken as
DTensor's refusal.

One reshard needs no exception. DTensor carries the vocab-sharded
lookup's masked partial sum (``_MaskPartial``, whose mask has the shape
of the lookup's output) through a view or an index, and the mask then
no longer fits its tensor; the reduction fails later, far from the op.
Where an op's output carries such a mask, the mode reduces the masked
argument first (an all-reduce while the mask still fits) and reruns it.

It is narrow: it judges an exception by where it was raised (the
innermost frame of its traceback that is neither torch's op-call
plumbing, nor the op's own meta kernel, nor a dispatch mode passing the
op on must lie in ``torch.distributed.tensor``), so anything raised
elsewhere propagates untouched; and once every DTensor argument is fully
replicated, where DTensor's plan is the op itself, it re-raises the
original exception. So a fault of the model or of the caller is never
swallowed.

It is counted: each reshard runs under its own
:class:`hlo_analysis.CollectiveCounter` and is logged in :attr:`log`
(the op, the argument's position, shape and dtype, the placements from
and to, and its collective bytes and counts by kind). Entered innermost
(last), its collectives also reach every mode entered before it, such as
the dry run's counter of the whole step. An attempt that DTensor
refuses, or whose output is dropped, takes whatever collectives it
issued back out of that counter when the mode is given it: a deployment
would not move them. Identical reshards (same op, argument and
placements) share one entry with their number in ``n``; where the dry
run's scan charges a step instead of running it
(``models/lm/scan.py``), :meth:`ReshardMode.charge` adds the step's
reshards to ``n``.
"""
from __future__ import annotations

import os
import traceback
from typing import Dict, List, Optional, Set, Tuple

import torch
import torch.distributed.tensor as dtensor_pkg
from torch.distributed.tensor import DTensor, Replicate
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.hlo_analysis import CollectiveCounter

__all__ = ["ReshardMode", "raised_by_dtensor", "reshard_totals"]

_DTENSOR_DIR = os.path.dirname(os.path.abspath(dtensor_pkg.__file__)) + os.sep
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
# frames an op's error passes through on its way up: the op call (a C++
# error surfaces in its Python caller here), its eager wrappers, and the
# op's own meta kernel where torch writes it in Python (with its checks)
_PLUMBING_FILES = {os.path.join(_TORCH_DIR, *p) for p in (
    ("_ops.py",), ("_compile.py",), ("_dynamo", "eval_frame.py"),
    ("__init__.py",), ("_meta_registrations.py",))}
_PLUMBING_DIRS = tuple(os.path.join(_TORCH_DIR, d) + os.sep for d in (
    "_refs", "_prims", "_prims_common", "_decomp"))
# mesh dims replicated first to last; any other name after these
_DIM_ORDER = ("model", "data", "pod")


def raised_by_dtensor(exc: BaseException) -> bool:
    """Whether ``exc`` was raised by DTensor: walking its traceback out
    from where it was raised, past torch's op-call plumbing and past
    dispatch modes that passed the op on (a ``__torch_dispatch__`` frame
    that is not the one raising), the first frame lies in
    ``torch.distributed.tensor``."""
    frames = []
    tb = exc.__traceback__
    while tb is not None:
        frames.append(tb.tb_frame.f_code)
        tb = tb.tb_next
    for depth, code in enumerate(reversed(frames)):
        path = os.path.abspath(code.co_filename)
        if path.startswith(_DTENSOR_DIR):
            return True
        if (path in _PLUMBING_FILES or path.startswith(_PLUMBING_DIRS)
                or (depth and code.co_name == "__torch_dispatch__")):
            continue
        return False
    return False


def _local_bytes(x: DTensor) -> int:
    t = x.to_local()
    return t.numel() * t.element_size()


def _dim_order(mesh) -> List[int]:
    names = list(mesh.mesh_dim_names or ())
    known = [names.index(n) for n in _DIM_ORDER if n in names]
    return known + [i for i in range(mesh.ndim) if i not in known]


def _masks(x: DTensor):
    """(mesh dim, mask) of each materialized ``_MaskPartial`` of ``x``."""
    for d, p in enumerate(x.placements):
        data = getattr(getattr(p, "mask_buffer", None), "data", None)
        if data is not None:
            yield d, data


def _stale_mask(out) -> bool:
    """Whether a DTensor of ``out`` carries a mask that fits neither its
    local shard (a gather's mask) nor the shard less its last dim (a
    lookup's)."""
    for x in pytree.tree_leaves(out):
        if isinstance(x, DTensor):
            local = tuple(x.to_local().shape)
            if any(tuple(m.shape) not in (local, local[:-1])
                   for _, m in _masks(x)):
                return True
    return False


def _misplaced(out) -> bool:
    """Whether a DTensor of ``out`` has more or fewer placements than its
    mesh has dims (torch 2.11's rule for ``constant_pad_nd`` gives one)."""
    return any(isinstance(x, DTensor)
               and len(x.placements) != x.device_mesh.ndim
               for x in pytree.tree_leaves(out))


def _written(func, args, kwargs) -> Set[int]:
    """ids of the DTensor arguments ``func`` writes in place."""
    ids = set()
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            ids.update(id(t) for t in pytree.tree_leaves(v)
                       if isinstance(t, DTensor))
    return ids


class ReshardMode(TorchDispatchMode):
    """Retries a DTensor op that DTensor refuses, after the smallest
    reshard to ``Replicate`` that cures it (the module docstring).
    ``log``: one dict per distinct reshard. ``counter``: the collective
    counter of the whole run, if any, entered before this mode: an
    attempt of an op that DTensor refuses or whose output is dropped
    takes back out of it whatever collectives it issued, which a
    deployment would not move."""

    def __init__(self, counter: Optional[CollectiveCounter] = None):
        super().__init__()
        self.counter = counter
        self.log: List[dict] = []
        self._index: Dict[tuple, dict] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        mark = self._mark()
        out, exc = self._attempt(func, args, kwargs)
        if out is _REFUSED:
            out = self._retry(func, args, kwargs, exc)
        if out is _REFUSED:
            if exc is None:
                raise RuntimeError(f"DTensor's rule for {func} places its "
                                   "output off its mesh")
            raise exc
        _forget(exc)
        if _stale_mask(out):
            self._rewind(mark)
            out = self._reduce_masks(func, args, kwargs)
        return out

    def _mark(self):
        return None if self.counter is None else self.counter.mark()

    def _rewind(self, mark):
        if mark is not None:
            self.counter.rewind(mark)

    # the dry run's scans (models/lm/scan.py) count reshards through these

    def mark(self):
        """A point in the log to count from (:meth:`since`,
        :meth:`rewind`)."""
        return len(self.log), [e["n"] for e in self.log]

    def since(self, mark) -> tuple:
        """The reshards since ``mark``: ((entry's index in the log,
        reshards), ...)."""
        i, ns = mark
        return tuple((j, e["n"] - (ns[j] if j < i else 0))
                     for j, e in enumerate(self.log)
                     if j >= i or e["n"] != ns[j])

    def charge(self, reshards, times: int):
        """Adds ``reshards`` (from :meth:`since`) ``times`` more times to
        their entries' ``n``: a charged step's reshards."""
        for j, n in reshards:
            self.log[j]["n"] += times * n

    def rewind(self, mark):
        """Takes back the reshards logged since ``mark``."""
        i, ns = mark
        for e, n in zip(self.log, ns):
            e["n"] = n
        kept = {id(e) for e in self.log[:i]}
        del self.log[i:]
        self._index = {k: e for k, e in self._index.items()
                       if id(e) in kept}

    def _attempt(self, func, args, kwargs):
        """(``func``'s output, None), or (_REFUSED, DTensor's exception,
        or None where the output is placed off its mesh), its collectives
        taken back; an exception raised elsewhere propagates."""
        mark = self._mark()
        try:
            out = func(*args, **kwargs)
        except Exception as exc:
            if not raised_by_dtensor(exc):
                raise
            self._rewind(mark)
            return _REFUSED, exc
        if _misplaced(out):
            self._rewind(mark)
            return _REFUSED, None
        return out, None

    def _retry(self, func, args, kwargs, exc):
        flat, spec = pytree.tree_flatten((args, kwargs))
        written = _written(func, args, kwargs)
        order = sorted((i for i, x in enumerate(flat)
                        if isinstance(x, DTensor)),
                       key=lambda i: _local_bytes(flat[i]))
        for i in order:
            for d in _dim_order(flat[i].device_mesh):
                if flat[i].placements[d].is_replicate():
                    continue
                try:
                    flat[i] = self._reshard(func, i, flat[i], d,
                                            id(flat[i]) in written)
                except Exception as err:
                    if not raised_by_dtensor(err):
                        raise
                    _forget(err)
                    return _REFUSED
                out, exc = self._attempt(func,
                                         *pytree.tree_unflatten(flat, spec))
                _forget(exc)
                if out is not _REFUSED:
                    return out
        # every argument replicated: where DTensor has no rule for the op
        # (it raises NotImplementedError, or its rule places the output off
        # the mesh: exc None), run the op on the full tensors
        if (exc is None or isinstance(exc, NotImplementedError)) \
                and not written:
            try:
                return _replicated(func, flat, spec)
            except Exception as err:  # the caller re-raises DTensor's
                _forget(err)          # refusal
                return _REFUSED
        return _REFUSED

    def _reduce_masks(self, func, args, kwargs):
        """``func`` rerun after each masked argument is reduced over the
        mesh dims of its masks."""
        flat, spec = pytree.tree_flatten((args, kwargs))
        for i, x in enumerate(flat):
            if isinstance(x, DTensor):
                for d, _ in list(_masks(x)):
                    flat[i] = self._reshard(func, i, flat[i], d, False)
        a, k = pytree.tree_unflatten(flat, spec)
        return func(*a, **k)

    def _reshard(self, func, pos: int, x: DTensor, dim: int,
                 in_place: bool) -> DTensor:
        """``x`` with mesh dim ``dim`` replicated (into ``x`` itself when
        ``in_place``), logged."""
        to = list(x.placements)
        to[dim] = Replicate()
        key = (str(func), pos, tuple(x.shape), str(x.dtype),
               str(x.placements), str(tuple(to)))
        with CollectiveCounter() as counter:
            y = x.redistribute(x.device_mesh, to)
        entry = self._index.get(key)
        if entry is None:
            names = x.device_mesh.mesh_dim_names
            entry = self._index[key] = {
                "op": key[0], "arg": pos, "shape": list(x.shape),
                "dtype": key[3], "from": key[4], "to": key[5],
                "mesh_dim": names[dim] if names else dim,
                "bytes": {k: v for k, v in counter.bytes.items() if v},
                "counts": {k: v for k, v in counter.counts.items() if v},
                "n": 0}
            self.log.append(entry)
        entry["n"] += 1
        if not in_place:
            return y
        x._local_tensor, x._spec = y._local_tensor, y._spec
        return x


_REFUSED = object()


def _forget(exc: Optional[BaseException]):
    """Drops the traceback of a refusal that is not raised (and of its
    causes and contexts). Its frames hold the op's local shards, and
    DTensor's hold cells that refer back to the exception: a cycle that
    kept those shards alive, and counted by the dry run's memory tracker,
    until the cyclic collector happened to run."""
    seen, todo = set(), [exc]
    while todo:
        e = todo.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        traceback.clear_frames(e.__traceback__)
        e.__traceback__ = None
        todo += [e.__cause__, e.__context__]


def _replicated(func, flat, spec):
    """``func`` on the local tensors of its fully replicated DTensor
    arguments, each tensor of the result a replicated DTensor: an op
    DTensor has no rule for, run as GSPMD runs an op it cannot
    partition."""
    mesh = next(x for x in flat if isinstance(x, DTensor)).device_mesh
    a, k = pytree.tree_unflatten([x.to_local() if isinstance(x, DTensor)
                                  else x for x in flat], spec)
    return pytree.tree_map_only(
        torch.Tensor, lambda t: DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False),
        func(*a, **k))


def reshard_totals(log) -> Tuple[int, Dict[str, int], Dict[str, int]]:
    """(reshards, bytes by collective kind, collectives by kind) of a
    :class:`ReshardMode` log."""
    n, nbytes, counts = 0, {}, {}
    for e in log:
        n += e["n"]
        for k, v in e["bytes"].items():
            nbytes[k] = nbytes.get(k, 0) + v * e["n"]
        for k, v in e["counts"].items():
            counts[k] = counts.get(k, 0) + v * e["n"]
    return n, nbytes, counts
