"""Collective traffic of an eager step: the counterpart of
``repro/launch/hlo_analysis.py``.

The reference parses XLA's optimized HLO text and multiplies each
while-loop body's collectives by its trip count, because XLA compiles a
``lax.scan`` body once. The port makes no HLO, so there is no text to
walk; PyTorch runs a loop's iterations eagerly, and each collective a
step issues is seen as it runs. The one exception is the port's own
``models/lm/scan.py``: under the dry run it runs a loop's steps until
two agree and charges the rest with the steady step's collectives
(:meth:`CollectiveCounter.charge`), the reference's trip count made
exact. :class:`CollectiveCounter` is a ``TorchDispatchMode`` that records each
collective op as it is dispatched: the functional collectives DTensor
issues when it redistributes (``_c10d_functional.all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``) and the in-place ``c10d`` ops that
``torch.distributed``'s own calls dispatch (``optim/compression.int8_psum``
uses ``torch.distributed.all_reduce``). It lets a DTensor op pass through
to its subclass dispatch (it returns ``NotImplemented`` for it) and stays
on the mode stack, so the collectives inside that dispatch reach it on
the local shards.

Charging convention, the reference's: each collective op is charged its
RESULT tensor bytes, per device (all-reduce: operand size; all-gather:
gathered size; reduce-scatter: scattered size; all-to-all /
collective-permute: transferred size). ``collective-permute`` counts
point-to-point sends (``c10d.send``), if any.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["COLLECTIVES", "CollectiveCounter", "analyze_collectives"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives: charged their result
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# in-place c10d ops: charged their first argument (the output tensors)
_INPLACE = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def _kind(func) -> Tuple[str, bool]:
    """(collective kind or "", charged on the result?) of an op."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns == "_c10d_functional" and name in _FUNCTIONAL:
        return _FUNCTIONAL[name], True
    if ns == "c10d" and name in _INPLACE:
        return _INPLACE[name], False
    return "", False


class CollectiveCounter(TorchDispatchMode):
    """Records every collective dispatched while it is active:
    ``bytes[kind]`` and ``counts[kind]`` over :data:`COLLECTIVES`, and
    ``ops``, the (op name, bytes) of each that ran, in order. Steps that a
    scan charges (:meth:`charge`) add to ``bytes`` and ``counts`` only:
    ``ops`` keeps the collectives that ran."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.ops = []
        self._kinds = []            # the kind of each entry of ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # its local ops come back through here
        out = func(*args, **kwargs)
        kind, on_result = _kind(func)
        if kind:
            n = _tensor_bytes(out if on_result else args[0])
            self.bytes[kind] += n
            self.counts[kind] += 1
            self.ops.append((str(func), n))
            self._kinds.append(kind)
        return out

    def mark(self):
        """A point to count from (:meth:`since`, :meth:`rewind`)."""
        return len(self.ops), dict(self.bytes), dict(self.counts)

    def since(self, mark) -> tuple:
        """The collectives that ran since ``mark``: ((op, kind, bytes),
        ...) in order."""
        i = mark[0]
        return tuple((name, kind, n) for (name, n), kind
                     in zip(self.ops[i:], self._kinds[i:]))

    def charge(self, ops, times: int):
        """Charges the collectives ``ops`` (from :meth:`since`) ``times``
        times more."""
        for _, kind, n in ops:
            self.bytes[kind] += times * n
            self.counts[kind] += times

    def rewind(self, mark):
        """Takes back everything counted since ``mark``."""
        i, nbytes, counts = mark
        self.bytes.update(nbytes)
        self.counts.update(counts)
        del self.ops[i:], self._kinds[i:]


def analyze_collectives(counter: CollectiveCounter
                        ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """(bytes per collective kind, op executions per kind), the
    reference's pair, from a counter that has run."""
    return dict(counter.bytes), dict(counter.counts)
