"""What every driver of the benchmark shares: finding a cell's files by
name, the seeded inputs, the window clock, the traced sub-window, and the
comparison's numbers beside their limits.

A cell is the workload entry of ``BENCHMARK.json`` plus the files found
by its names: ``configs/<config>.json`` (the model's sizes and modes),
``traffic/<traffic>.json`` (the mix: which driver, and its parameters)
and ``cells/<workload>.json`` (the limits of its comparison). A driver
is ``drivers/<driver>.py``; a per-layer metric ``metrics/<metric>.py``;
an operation's roofline ``rooflines/<operation>.py``. Adding any of them
is adding a file and an entry.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that may not be loaded in a measured process, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    cell_file = load_json(HERE / "cells" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, w, config, traffic, cell_file["limits"], e2e, per_layer)


# --- inputs from the seed ------------------------------------------------------

def generator(seed: int, device: torch.device, stream: int = 0
              ) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of ``seed``
    (streams keep the weights and the traffic apart)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def param_shapes(dims) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Each So3krates leaf's shape and the scale of its normal draw
    (1/sqrt(fan_in); embedding 0.5; the energy head 0.1/sqrt(fan_in));
    the layer norm's gain and bias are ones and zeros (scale 0)."""
    F, Fv, K = dims.feat, dims.vec_feat, dims.n_rbf
    out = {"embed": ((dims.n_species, F), 0.5)}

    def dense(a, b, s=1.0):
        return ((a, b), s / math.sqrt(a))
    for i in range(dims.n_layers):
        L = f"layer{i}"
        out.update({f"{L}/wq": dense(F, F), f"{L}/wk": dense(F, F),
                    f"{L}/wm": dense(F, F), f"{L}/rbf_m": dense(K, F),
                    f"{L}/rbf_bias": dense(K, 1), f"{L}/wa": dense(F, Fv),
                    f"{L}/rbf_a": dense(K, Fv), f"{L}/wb": dense(F, Fv),
                    f"{L}/rbf_b": dense(K, Fv), f"{L}/w_upd1": dense(F, F),
                    f"{L}/w_upd2": dense(F, F), f"{L}/w_vnorm": dense(Fv, F),
                    f"{L}/ln_g": ((F,), 0.0), f"{L}/ln_b": ((F,), 0.0)})
    out["ro_w1"] = dense(F + Fv, F)
    out["ro_w2"] = dense(F, 1, 0.1)
    return out


def make_params(dims, seed: int, device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """float32 weights from ``seed``, drawn on ``device`` in one call."""
    shapes = param_shapes(dims)
    total = sum(math.prod(s) for s, _ in shapes.values())
    flat = torch.randn(total, generator=generator(seed, device, 1),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, (shape, scale) in shapes.items():
        n = math.prod(shape)
        if name.endswith("/ln_g"):
            out[name] = torch.ones(shape, device=device)
        elif name.endswith("/ln_b"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = (flat[at:at + n] * scale).reshape(shape).contiguous()
        at += n
    return out


# --- clocks and the trace --------------------------------------------------------

def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SetupClock:
    """Seconds of each set-up stage, printed to standard error."""

    def __init__(self, device: torch.device):
        self.device = device
        self.last = time.perf_counter()

    def mark(self, stage: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        print(f"setup {stage} {now - self.last:.3f} s", file=sys.stderr,
              flush=True)
        self.last = now

    def done(self) -> float:
        sync(self.device)
        return time.perf_counter()


@dataclasses.dataclass
class Trace:
    """What one profiled sub-window saw: device kernels (name, start,
    duration; ns on the profiler's clock), the host annotations made by
    the drivers, and the sub-window's host-clock length."""
    kernels: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]
    window_s: float
    units: int = 0          # driver's units of work inside (steps, ...)

    def busy_s(self) -> float:
        """Seconds in which some kernel ran (overlaps merged)."""
        busy, end = 0, None
        for _, t0, dur in sorted(self.kernels, key=lambda k: k[1]):
            t1 = t0 + dur
            if end is None or t0 >= end:
                busy += dur
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        return busy * 1e-9

    def kernel_time(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        ks = [k for k in self.kernels if match(k[0])]
        return sum(k[2] for k in ks) * 1e-9, len(ks)

    def top_ops(self, n: int = 10) -> List[List[Any]]:
        tot: Dict[str, int] = {}
        for name, _, dur in self.kernels:
            tot[name] = tot.get(name, 0) + dur
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[List[Any]]:
        """The longest gaps between kernels, each named by the driver's
        annotation that was open on the host when the gap began."""
        ks = sorted(self.kernels, key=lambda k: k[1])
        gaps, end = [], None
        for _, t0, dur in ks:
            if end is not None and t0 > end:
                gaps.append((end, t0 - end))
            end = t0 + dur if end is None else max(end, t0 + dur)
        gaps.sort(key=lambda g: -g[1])
        out = []
        for start, length in gaps[:n]:
            label = "host: outside the driver's annotations"
            for name, h0, hdur in self.host:
                if h0 <= start < h0 + hdur:
                    label = f"host: {name}"
            out.append([label, length * 1e-9])
        return out


# device activities that are copies, not kernels
_NOT_KERNELS = ("Memcpy", "Memset")


class Profiled:
    """A profiled run of a few units of work, after the window: once
    prepared (its start-up takes seconds), the profiler slows every
    launch, recorded or not (a replayed QAT step's launch ~48 ms against
    ~0.8). :meth:`start` begins recording and :meth:`stop`, given the
    units of work done in between, ends it and returns the
    :class:`Trace`. Both synchronize the device."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=acts)
        self.prof.prepare_trace()

    def start(self) -> None:
        sync(self.device)
        self.prof.start_trace()
        self.t0 = time.perf_counter()

    def stop(self, units: int) -> Trace:
        sync(self.device)
        window = time.perf_counter() - self.t0
        self.prof.stop_trace()
        kernels, host = [], []
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            item = (name, ev.start_ns(), ev.duration_ns())
            if name.startswith("bench:"):
                # a driver's span; on the device side its shadow over the
                # kernels launched inside it, which is no kernel
                if "CUDA" not in str(ev.device_type()):
                    host.append((name[len("bench:"):],) + item[1:])
            elif "CUDA" in str(ev.device_type()):
                if not name.startswith(_NOT_KERNELS):
                    kernels.append(item)
            elif self.device.type != "cuda" and name.startswith("aten::"):
                # the CPU has no device kernels: its operators stand in,
                # so the reductions can be exercised off the card (a run
                # off the card reports nothing)
                kernels.append(item)
        return Trace(kernels, host, window, units)


def annotate(name: str):
    """A host span the trace's idle gaps are named by."""
    return torch.profiler.record_function(f"bench:{name}")


# --- the comparison ----------------------------------------------------------------

@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks_from(readings: Dict[str, float], limits: Dict[str, float]
                ) -> List[Check]:
    missing = set(limits) - set(readings)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    return [Check(k, float(readings[k]), float(limits[k])) for k in limits]


def worst_gap(got: torch.Tensor, want: torch.Tensor,
              scale: Optional[torch.Tensor] = None) -> float:
    """Largest |got - want| over ``scale`` (default: the RMS of want)."""
    got = got.detach().to(torch.float64)
    want = want.detach().to(torch.float64)
    if scale is None:
        scale = want.pow(2).mean().sqrt()
    return float((got - want).abs().max() / scale.clamp_min(1e-30))


@dataclasses.dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""
    e2e: Dict[str, float]
    setup_end: float                # perf_counter at the window's start
    attempted: int
    failed: int
    memory_peak_bytes: int
    readings: Dict[str, float]      # numbers compared, by limit name
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Optional[Trace] = None
