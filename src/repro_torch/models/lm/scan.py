"""A loop over one axis that threads a carry and stacks an output per
step: the port's counterpart of ``jax.lax.scan``.

Outside the dry run, :func:`scan` is the plain loop: ``body(carry, x_t,
*consts) -> (carry, y_t)`` for t in 0..S-1, with ``x_t = xs.select(axis,
t)``, and the ``y_t`` stacked on ``axis``; nothing else runs, so its
results are the loop's bit for bit on any device.

Under the dry run (``launch/dryrun.py`` enters :func:`charging` with its
meter), the reference's method applies. XLA compiles a scan body once,
and the reference's ``analyze_collectives`` multiplies the body's
collectives by the loop's trip count. The port does better than scaling
a guess, because its tensors carry no values (``meta`` shards): what a
step dispatches depends only on the shapes, dtypes and placements it is
given. So the scan runs real steps until two consecutive ones, k-1 and
k, have the same signature: the carry's shapes, dtypes and placements
coming in and going out, the output's, and what the meter saw (local
FLOPs, each collective's kind and bytes in order, the reshards logged,
and the bytes left alive). Step k then hands step k+1 what step k was
handed, and so on to the end: every later step is step k again. The
scan charges those steps with step k's counts (``meter.charge``) instead
of running them. If no such pair appears within :data:`MAX_UNSTEADY`
steps, it runs the whole loop and notes that; it never charges a guess.
Charging needs value-free tensors: on tensors with values the scan runs
the plain loop whatever the meter.

The charged steps' outputs are stacked as the loop stacks them: one
``torch.stack`` over S outputs, step k's output standing for each charged
step's (the same shape, dtype and placement, and no values), so the stack
makes the loop's own redistributions and output. A stand-in ``meta``
allocation holds what the charged steps would leave alive (step k's
bytes each, the loop's list of outputs), so the dry run's memory tracker
sees it, and is released where the loop releases it.

With gradients on, the scan is a ``torch.autograd.Function``
(:class:`_Scan`). Its forward keeps the autograd graphs of the real
steps: the head (steps 0..k) and a tail of the last
``min(TAIL, S - k - 1)`` steps, run from step k's carry (they
equal step k, and the scan checks that), and the stand-in holds the
charged steps' residuals, as XLA's scan stacks its residuals. Its
backward runs the steps' backward from the last (each a
``torch.autograd.grad`` over that step's graph, with the output's
gradient selected from the stacked gradient, as ``stack``'s backward
selects it, and the inputs' gradients summed as the autograd engine sums
them) until two consecutive steps agree in the same sense, charges the
charged steps' backward with that step's counts, and then runs the
head's. Where the tail settles no backward, the charged steps are
rebuilt one at a time with the meter rewound over their forward, and
their backward runs, until a pair agrees or the loop ends.

The meter (duck-typed) has ``mark()``; ``since(mark)``, a hashable
record of what was counted since; ``charge(record, times)``;
``rewind(mark)``; ``live_bytes()``; and ``note(entry)``, which receives
one dict per pass of each scan: ``{"pass": "forward" | "backward",
"length": S, "ran": n, "charged": m, "steady_at": k or None}``.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.autograd.graph import get_gradient_edge, saved_tensors_hooks

__all__ = ["scan", "charging", "MAX_UNSTEADY", "TAIL"]

# Steps a scan runs looking for a steady pair. The sLSTM settles at its third step in
# the forward (step 0 starts from plain zeros, step 1 from the first
# step's placements) and its backward at the third from the end (the
# last step gets no carry gradient, the one before gets it only from h);
# 8 leaves room for a body whose placements take a few steps more.
MAX_UNSTEADY = 8
# the last steps a gradient scan runs on its graph (after the charged
# ones), where its backward looks for its steady pair
TAIL = MAX_UNSTEADY

_METER: ContextVar = ContextVar("scan_meter", default=None)


@contextlib.contextmanager
def charging(meter):
    """Scans inside charge their steady steps to ``meter`` (the module
    docstring)."""
    token = _METER.set(meter)
    try:
        yield meter
    finally:
        _METER.reset(token)


def scan(body: Callable, carry: Tuple, xs: torch.Tensor, axis: int = 1,
         consts: Sequence[torch.Tensor] = ()):
    """(final carry, ys): ``body(carry, x_t, *consts) -> (carry, y_t)``
    over t in 0..S-1, ``x_t = xs.select(axis, t)``, ``ys`` the ``y_t``
    stacked on ``axis``. ``carry`` is a tuple of tensors; ``consts`` are
    the tensors the body reads at every step, passed to it as they are
    (a gradient scan differentiates through them)."""
    meter = _METER.get()
    carry = tuple(carry)
    if meter is None or not all(_value_free(t) for t in (xs, *carry)):
        return _loop(body, carry, xs, axis, consts)
    tensors = (xs, *carry, *consts)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        run = _Run(meter, body, axis, len(carry), len(consts),
                   xs.shape[axis])
        out = _Scan.apply(run, xs, *carry, *consts)
        return tuple(out[1:]), out[0]
    return _charged(meter, body, carry, xs, axis, consts)


def _loop(body, carry, xs, axis, consts):
    ys = []
    for t in range(xs.shape[axis]):
        carry, y = body(carry, xs.select(axis, t), *consts)
        ys.append(y)
    return carry, torch.stack(ys, dim=axis)


# --- signatures --------------------------------------------------------------

def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


def _value_free(t) -> bool:
    return isinstance(t, torch.Tensor) and _local(t).is_meta


def _sig(t) -> Optional[tuple]:
    """Shape, dtype, placement and local shape of a tensor, and whether it
    requires grad (None for None)."""
    if t is None:
        return None
    placements = getattr(t, "placements", None)
    return (tuple(t.shape), str(t.dtype), tuple(_local(t).shape),
            None if placements is None else str(tuple(placements)),
            t.requires_grad)


def _sigs(ts) -> tuple:
    return tuple(_sig(t) for t in ts)


def _nbytes(t) -> int:
    loc = _local(t)
    return loc.numel() * loc.element_size()


def _storage(t) -> int:
    return _local(t).untyped_storage()._cdata


def _stand_in(n: int) -> Optional[torch.Tensor]:
    """A value-free allocation of ``n`` bytes that the memory tracker
    sees."""
    return torch.empty((n,), dtype=torch.uint8, device="meta") if n > 0 \
        else None


# what a step's signature holds, in order
_PARTS = ("carry in", "carry out", "output", "counts", "live bytes")


class _Steady:
    """Finds, within :data:`MAX_UNSTEADY` steps, a step whose signature
    equals the one before's; afterwards every step must equal it."""

    def __init__(self):
        self.n, self.last, self.sig = 0, None, None

    def add(self, sig) -> bool:
        """Whether the pair is steady (now or before)."""
        if self.sig is not None:
            if sig != self.sig:
                parts = [f"{_PARTS[i]}: {a} against {b}"
                         for i, (a, b) in enumerate(zip(sig, self.sig))
                         if a != b]
                raise RuntimeError("scan: a step after the steady pair "
                                   "differs from it in " + "; ".join(parts))
            return True
        self.n += 1
        if self.n <= MAX_UNSTEADY and sig == self.last:
            self.sig = sig
            return True
        self.last = sig
        return False

    @property
    def given_up(self) -> bool:
        return self.sig is None and self.n >= MAX_UNSTEADY


# --- forward without gradients ---------------------------------------------------

def _charged(meter, body, carry, xs, axis, consts):
    S = xs.shape[axis]
    ys, steady = [], _Steady()
    live = meter.live_bytes()
    for t in range(S):
        mark, sig_in = meter.mark(), _sigs(carry)
        carry, y = body(carry, xs.select(axis, t), *consts)
        ys.append(y)
        now = meter.live_bytes()
        counts = meter.since(mark)
        if steady.add((sig_in, _sigs(carry), _sig(y), counts, now - live)):
            rest = S - t - 1
            meter.charge(counts, rest)
            meter.note({"pass": "forward", "length": S, "ran": t + 1,
                        "charged": rest, "steady_at": t})
            held = _stand_in(rest * max(now - live, 0))  # the loop's list
            out = torch.stack(ys + [y] * rest, dim=axis)
            del held
            return carry, out
        live = now
        if steady.given_up:
            break
    for t in range(len(ys), S):
        carry, y = body(carry, xs.select(axis, t), *consts)
        ys.append(y)
    meter.note({"pass": "forward", "length": S, "ran": S, "charged": 0,
                "steady_at": None})
    return carry, torch.stack(ys, dim=axis)


# --- the gradient scan ----------------------------------------------------------

class _Attach(torch.autograd.Function):
    """A view of ``x`` whose gradient edge holds no tensor: the scan
    captures its inputs' gradients there without keeping the inputs
    alive (a leaf's accumulator would)."""

    @staticmethod
    def forward(ctx, anchor, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


def _edge(t):
    return get_gradient_edge(t) if t is not None and t.requires_grad \
        else None


class _Step:
    """One real step's graph: the gradient edges of its carry in and out,
    its output and its xs (edges hold the graph, not the tensors), and
    the storages its graph saved."""

    def __init__(self, t, carry_in, carry_out, y, xs_edge, saved):
        self.t, self.xs, self.saved = t, xs_edge, saved
        self.ins = [_edge(c) for c in carry_in]
        self.outs = [_edge(c) for c in carry_out]
        self.y = _edge(y)


class _Run:
    """One gradient scan, from its forward to its backward."""

    def __init__(self, meter, body, axis, n_carry, n_consts, S):
        self.meter, self.body, self.axis = meter, body, axis
        self.n_carry, self.n_consts, self.S = n_carry, n_consts, S

    # forward ---------------------------------------------------------------

    def _attach(self, x):
        return _Attach.apply(self.anchor, x.detach()) if x.requires_grad \
            else x.detach()

    def _step(self, t, carry, xs_a, ys=None):
        """Step t on a graph of its own (its carry attached afresh, so
        that its backward ends at its inputs): (carry out, its
        :class:`_Step`)."""
        carry = tuple(self._attach(c) for c in carry)
        saved = set()

        def pack(x):
            saved.add(_storage(x))
            return x
        with saved_tensors_hooks(pack, lambda x: x):
            out, y = self.body(carry, xs_a.select(self.axis, t),
                               *self.consts)
        if ys is not None:
            ys.append(y)
        return out, _Step(t, carry, out, y, _edge(xs_a), saved)

    def forward(self, xs, carry, consts):
        meter, S, axis = self.meter, self.S, self.axis
        self.anchor = torch.empty(0, device="meta", requires_grad=True)
        self.head, self.tail, self.middle, self.held = [], [], 0, None
        with torch.enable_grad():
            xs_a = self._attach(xs)
            self.consts = [self._attach(c) for c in consts]
            self.const_edges = [_edge(c) for c in self.consts]
            ys, steady = [], _Steady()
            for t in range(S):
                live, mark, sig_in = (meter.live_bytes(), meter.mark(),
                                      _sigs(carry))
                # the step's input carry is released here, as the loop's
                carry, step = self._step(t, carry, xs_a, ys)
                counts = meter.since(mark)
                sig = (sig_in, _sigs(carry), _sig(ys[-1]), counts,
                       meter.live_bytes() - live)
                self.head.append(step)
                if steady.add(sig) or steady.given_up:
                    break
            if steady.sig is None:             # the whole loop
                for t in range(len(self.head), S):
                    carry, step = self._step(t, carry, xs_a, ys)
                    self.head.append(step)
                meter.note({"pass": "forward", "length": S, "ran": S,
                            "charged": 0, "steady_at": None})
                stacked = ys
            else:
                k = len(self.head) - 1
                n_tail = min(TAIL, S - k - 1)
                self.middle = S - k - 1 - n_tail
                self.per_step = max(sig[-1], 0)
                meter.charge(counts, self.middle)
                self.held = _stand_in(self.middle * self.per_step)
                self.steady_carry = [_spec(c) for c in carry]
                self.xs_spec = _spec(xs)
                for t in range(S - n_tail, S):   # step k again, graphed
                    live, mark, sig_in = (meter.live_bytes(), meter.mark(),
                                          _sigs(carry))
                    carry, step = self._step(t, carry, xs_a, ys)
                    steady.add((sig_in, _sigs(carry), _sig(ys[-1]),
                                meter.since(mark),
                                meter.live_bytes() - live))
                    self.tail.append(step)
                meter.note({"pass": "forward", "length": S,
                            "ran": k + 1 + n_tail, "charged": self.middle,
                            "steady_at": k})
                stacked = ys[:k + 1] + [ys[k]] * self.middle + ys[k + 1:]
                # an output no later step saves lived only in the list
                y_saved = _storage(ys[k - 1]) in self.head[k].saved
        with torch.no_grad():
            out = torch.stack(stacked, dim=axis)
        if self.middle and not y_saved:
            self.held = None
            self.held = _stand_in(self.middle * max(
                self.per_step - _nbytes(ys[k]), 0))
        return (out,) + tuple(c.detach() for c in carry)

    # backward --------------------------------------------------------------

    def _vjp(self, step, g_ys, g_carry, acc):
        """Step ``step``'s backward from its carry-out gradients: its
        output's gradient selected from ``g_ys`` (as ``stack``'s backward
        selects it), its xs and consts gradients added into ``acc`` (as
        the autograd engine sums them); returns its carry-in gradients."""
        outs, grads = [], []
        if g_ys is not None and step.y is not None:
            outs.append(step.y)
            grads.append(g_ys.select(self.axis, step.t))
        for e, g in zip(step.outs, g_carry):
            if e is not None and g is not None:
                outs.append(e)
                grads.append(g)
        wrt = [(None, e) for e in step.ins] + [(0, step.xs)] + [
            (1 + i, e) for i, e in enumerate(self.const_edges)]
        wrt = [(i, e) for i, e in wrt if e is not None]
        got = (torch.autograd.grad(outs, [e for _, e in wrt], grads,
                                   allow_unused=True) if outs
               else [None] * len(wrt))
        g_in = iter(got[:sum(e is not None for e in step.ins)])
        for (i, _), g in zip(wrt, got):
            if i is not None and g is not None:
                acc[i] = g if acc[i] is None else acc[i] + g
        return [next(g_in) if e is not None else None for e in step.ins]

    def _backward_step(self, step, g_ys, g_carry, acc, steady):
        """(carry-in gradients, counts, steady) of ``step``'s backward."""
        meter = self.meter
        mark, sig_in = meter.mark(), _sigs(g_carry)
        g_carry = self._vjp(step, g_ys, g_carry, acc)
        counts = meter.since(mark)
        return g_carry, counts, steady.add(
            (sig_in, _sigs(g_carry), _sigs(acc), counts))

    def backward(self, g_ys, g_carry):
        meter, S = self.meter, self.S
        acc = [None] * (1 + self.n_consts)      # xs, then consts
        g_carry, steady = list(g_carry), _Steady()
        ran, charged, counts, steady_at = 0, 0, None, None
        for step in reversed(self.tail):
            g_carry, counts, same = self._backward_step(step, g_ys, g_carry,
                                                        acc, steady)
            ran += 1
            if same and steady_at is None:
                steady_at = step.t
        self.tail = []
        if self.middle:
            if steady_at is not None:
                meter.charge(counts, self.middle)
                charged, self.held = self.middle, None
            else:
                g_carry, n, charged, steady_at = self._rebuild_middle(
                    g_ys, g_carry, acc, steady)
                ran += n
        for step in reversed(self.head):
            g_carry, _, _ = self._backward_step(step, g_ys, g_carry, acc,
                                                _Steady())
            ran += 1
        self.head = []
        meter.note({"pass": "backward", "length": S, "ran": ran,
                    "charged": charged, "steady_at": steady_at})
        return (acc[0],) + tuple(g_carry) + tuple(acc[1:])

    def _rebuild_middle(self, g_ys, g_carry, acc, steady):
        """The charged steps' backward where the tail settled none: each
        step's graph rebuilt from value-free inputs with the meter rewound
        over its forward, then its backward run, until a pair agrees (the
        rest charged) or the steps run out. Returns (carry gradients,
        steps run, steps charged, the steady step or None)."""
        meter = self.meter
        first, last = self.k + 1, self.k + self.middle
        xs_a = self._attach(_make(self.xs_spec))
        for t in range(last, first - 1, -1):
            self.held = None                     # one step's residuals
            self.held = _stand_in((t - first) * self.per_step)
            mark = meter.mark()
            with torch.enable_grad():
                _, step = self._step(t, [_make(s) for s in self.steady_carry],
                                     xs_a)
            meter.rewind(mark)
            g_carry, counts, same = self._backward_step(step, g_ys, g_carry,
                                                        acc, steady)
            if same:
                meter.charge(counts, t - first)
                self.held = None
                return g_carry, last - t + 1, t - first, t
        self.held = None
        return g_carry, self.middle, 0, None

    @property
    def k(self) -> int:
        return len(self.head) - 1


def _spec(t):
    """What :func:`_make` needs for a value-free tensor like ``t``:
    (shape, stride, dtype, (mesh, placements) or None, local shape,
    requires grad)."""
    mesh = getattr(t, "device_mesh", None)
    return (tuple(t.shape), tuple(t.stride()), t.dtype,
            None if mesh is None else (mesh, tuple(t.placements)),
            tuple(_local(t).shape), t.requires_grad)


def _make(spec) -> torch.Tensor:
    shape, stride, dtype, placed, local, grad = spec
    if placed is None:
        t = torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    else:
        from torch.distributed.tensor import DTensor
        t = DTensor.from_local(
            torch.empty(local, dtype=dtype, device="meta"), placed[0],
            placed[1], run_check=False, shape=shape, stride=stride)
    return t.requires_grad_(grad)


class _Scan(torch.autograd.Function):
    """The gradient scan under a meter (the module docstring)."""

    @staticmethod
    def forward(ctx, run, xs, *flat):
        ctx.set_materialize_grads(False)
        ctx.run = run
        return run.forward(xs, flat[:run.n_carry], flat[run.n_carry:])

    @staticmethod
    def backward(ctx, g_ys, *g_carry):
        run = ctx.run
        del ctx.run
        return (None,) + run.backward(g_ys, g_carry)
