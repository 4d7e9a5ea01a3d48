"""The reductions the per-layer readers share, from a driver's
:class:`~perfbench.common.Outcome`: its trace (device kernels of the
profiled units), its counters (units of work, the forward calls of a
unit and their shapes, the unprofiled window's host-clock length)
and the roofline entries in ``rooflines/``. Each returns None
when there is nothing to read.

The profiler slows launches from the moment it is prepared (a replayed
QAT step takes ~2x as long), so a closed-loop driver profiles a few
units after its window, and a share
of time divides by what the traced units take without the profiler:
the window's seconds per unit (``counters["untraced"]``: seconds,
units). An open-loop driver, whose arrivals set the window's length,
gives none, and the traced window's own length stands."""
from __future__ import annotations

import re
from typing import Optional

from perfbench import flops, peaks
from perfbench.common import HERE, load_module


def unit_seconds(outcome) -> Optional[float]:
    """Host seconds per unit of work of the unprofiled window, or None."""
    seconds, units = outcome.counters.get("untraced", (0.0, 0))
    return seconds / units if units and seconds > 0 else None


def paced_seconds(outcome) -> Optional[float]:
    """The seconds the traced units take unprofiled: their count times
    the untraced seconds per unit; an open-loop window's own length."""
    tr = outcome.trace
    if tr is None or not tr.units:
        return None
    if "untraced" not in outcome.counters:
        return tr.window_s if tr.window_s > 0 else None
    per_unit = unit_seconds(outcome)
    return None if per_unit is None else per_unit * tr.units


def idle_share(outcome) -> Optional[float]:
    """1 - the traced units' device busy time over what they take
    unprofiled."""
    tr, span = outcome.trace, paced_seconds(outcome)
    if span is None or not tr.kernels:
        return None
    return 1.0 - tr.busy_s() / span


def kernels_per_unit(outcome) -> Optional[float]:
    tr = outcome.trace
    if tr is None or not tr.units or not tr.kernels:
        return None
    return len(tr.kernels) / tr.units


def roofline_entries():
    return [load_module("rooflines", p.stem)
            for p in sorted((HERE / "rooflines").glob("*.py"))]


def kernel_roofline(outcome, entries=None) -> Optional[float]:
    """Sum of the operations' least times over the traced units over the
    device time of the kernels matched to them, in percent. The traced
    part's forward calls are ``trace_forwards`` where a driver counts
    them apart from the window's (``forwards``)."""
    tr, c = outcome.trace, outcome.counters
    if tr is None or not tr.units:
        return None
    least = device = 0.0
    for entry in entries if entries is not None else roofline_entries():
        per_unit = 0.0
        for fwd in c.get("trace_forwards", c["forwards"]):
            work = entry.work(c["dims"], fwd)
            if work is not None:
                n_bytes, ops = work
                per_unit += fwd.get("calls", 1) \
                    * peaks.least_time(n_bytes, ops)
        if per_unit == 0.0:
            continue
        pattern = re.compile(entry.PATTERN)
        seconds, n = tr.kernel_time(lambda name: bool(pattern.search(name)))
        if n == 0:
            continue
        least += per_unit * tr.units
        device += seconds
    if device == 0.0:
        return None
    return 100.0 * least / device


def mfu(outcome) -> Optional[float]:
    """Counted model FLOPs over the seconds they took times the
    configuration's peak, in percent: the untraced part's units (its
    forward calls are ``forwards``), or an open-loop driver's traced
    ones (``trace_forwards`` where it counts them apart)."""
    c, tr = outcome.counters, outcome.trace
    if tr is None:
        return None
    if "untraced" in c:
        (seconds, units), fwd = c["untraced"], c["forwards"]
    else:
        seconds, units = tr.window_s, tr.units
        fwd = c.get("trace_forwards", c["forwards"])
    if not units or seconds <= 0:
        return None
    total = flops.window_flops(c["dims"], fwd, units)
    return 100.0 * total / (seconds * peaks.OPS_PER_S[c["peak"]])
