"""Multi-pod dry run: place and run every (arch x shape x mesh) cell's step
on one rank of the production mesh, with no card and no memory:
counterpart of ``repro/launch/dryrun.py``, with its flags and
``run_cell`` keywords.

The reference lowers and compiles each cell on 512 placeholder host
devices. The port has no compiler to ask, so it runs the cell's step as
rank 0 of a fake process group of 256 (or 512) ranks in this one process
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once and move no data). Every leaf is a DTensor placed by the sharding
rules (``launch/sharding.py``) whose local shard is a ``meta`` tensor of
the shard's shape: DTensor propagates the placements op by op and
redistributes where an op needs it, and nothing is allocated or
computed. (``FakeTensorMode`` fails here: DTensor computes the index
sets of a strided shard, which a view merging batch and heads makes,
with tensor ops it then reads back, and a fake tensor has no values.
``meta`` local shards leave those helpers on real CPU tensors.) The
mesh's device type is ``cpu``, so DTensor lowers an all-to-all into an
all-gather and a chunk, as it does for any CPU process group.

The step runs under :class:`hlo_analysis.CollectiveCounter` (each
collective charged its result's bytes per device),
``torch.utils.flop_counter``'s formulas applied to the ops each shard
dispatches (FLOPs per device), and ``torch.distributed._tools``'
``MemTracker`` (peak bytes of the meta shards). The record is the
reference's, key for key, at
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__<tag>].json``:
``memory.argument_bytes`` / ``output_bytes`` are the local shards' bytes
of the step's arguments and results, ``temp_bytes`` the tracker's peak
beyond the arguments and ``peak_bytes`` its peak (-1 where it fails);
``flops`` the counted FLOPs per device; ``bytes_accessed`` -1 (PyTorch
counts none); ``lower_s`` the placement's seconds and ``compile_s`` the
step's; the ``analytic_*`` fields, ``model_flops`` and the parameter
counts from ``launch/costs.py``. Where DTensor refuses an op that GSPMD
would reshard past, the step runs on after the smallest reshard to
``Replicate`` that cures it (``launch/reshard.ReshardMode``, entered
innermost, so the counters above charge its collectives): the record
keeps the reference's keys, and the CLI writes the reshard log beside
it, ``<arch>__<shape>__<mesh>[__<tag>].reshards.json``. A cell whose
step fails otherwise still writes its record, with ``"error"``: the
exception's class and first line. The CLI then prints ``FAIL`` and
exits 1.

The sLSTM's loop over time (``models/lm/scan.py``, the reference's
``lax.scan``) runs its steps only until two consecutive ones agree in
everything the step sees and counts (shapes, dtypes and placements in
and out, FLOPs, collectives, reshards, bytes left alive), then charges
the remaining steps with that step's counts, forward and backward: XLA
compiles a scan body once and the reference multiplies its collectives
by the trip count, and on meta shards the port's charge is exact. The
FLOPs keep the port's convention (every step counted; XLA's
``cost_analysis`` counts the body once). The CLI prints, after its
``ok:`` line, the steps the scans ran and charged.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch musicgen-large \\
      --shape train_4k --mesh single [--quant serve_w8a8] [--kv-quant]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import sys
import time
import traceback
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs, tree
from repro_torch.launch import costs as costs_lib
from repro_torch.launch import sharding as shd
from repro_torch.launch.hlo_analysis import (CollectiveCounter,
                                             analyze_collectives)
from repro_torch.launch.reshard import ReshardMode, reshard_totals
from repro_torch.launch.steps import (abstract_cache, abstract_opt_state,
                                      abstract_params, input_specs,
                                      make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models.lm import scan as scan_lib
from repro_torch.models.lm.config import SHAPES
from repro_torch.optim.adamw import AdamW, AdamWState

__all__ = ["run_cell", "run_cell_and_reshards", "cell_path",
           "reshards_path", "fake_world", "scan_line", "main"]

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                   "dryrun_torch")

_MESHES = {"single": ((16, 16), ("data", "model")),
           "multi": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_world(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A fake process group of ``prod(shape)`` ranks, this process rank 0,
    laid out as a ``cpu`` DeviceMesh; destroyed on exit."""
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already open; the dry run "
                           "opens its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


class _LocalFlops(TorchDispatchMode):
    """FLOPs of the ops dispatched on local shards, by
    ``FlopCounterMode``'s formulas (2 per multiply-add): a DTensor op is
    passed to its subclass dispatch and its local ops come back here.
    DTensor's sharding propagation runs an op it has not seen under a
    fake mode of its own to learn its output's shape; those runs are not
    the step's, and are not counted (as ``MemTracker`` does not track
    them), so a count does not depend on what ran before in the
    process."""

    def __init__(self):
        super().__init__()
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0

    def __enter__(self):
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        formula = self.registry.get(func._overloadpacket)
        if formula is not None and active_fake_mode() is self._fake_on_entry:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        return out


class _MemTracker(MemTracker):
    """``MemTracker`` that does not track what DTensor's sharding
    propagation allocates under its own fake mode for an op it has not
    seen: those tensors are not the step's. torch 2.13's tracker skips
    them itself; 2.11's tracked them, so a cell's peak depended on what
    had run before it in the process."""

    def __enter__(self):
        self._fake_at_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (active_fake_mode() is not self._fake_at_entry
                and not any(issubclass(t, DTensor) for t in types)):
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class _Meter:
    """What the step's scans (``models/lm/scan.py``) read and charge: the
    local FLOPs, the collective counter, the reshard log and the memory
    tracker's live bytes. ``scans`` gets one note per pass of each
    scan."""

    def __init__(self, flops, coll, reshards, tracker):
        self.flops, self.coll, self.reshards = flops, coll, reshards
        self.tracker = tracker
        self.scans = []

    def mark(self):
        return self.flops.flops, self.coll.mark(), self.reshards.mark()

    def since(self, mark) -> tuple:
        return (self.flops.flops - mark[0], self.coll.since(mark[1]),
                self.reshards.since(mark[2]))

    def charge(self, counts, times: int):
        flops, coll, reshards = counts
        self.flops.flops += times * flops
        self.coll.charge(coll, times)
        self.reshards.charge(reshards, times)

    def rewind(self, mark):
        self.flops.flops = mark[0]
        self.coll.rewind(mark[1])
        self.reshards.rewind(mark[2])

    def live_bytes(self) -> int:
        """The tracker's bytes alive, after a cyclic collection: a shard
        that only a reference cycle holds is not the step's."""
        if self.tracker is None:
            return 0
        gc.collect()
        snap = self.tracker.get_tracker_snapshot("current")
        return int(sum(v.get("Total", 0) for v in snap.values()))

    def note(self, entry: dict):
        self.scans.append(entry)


def _on_mesh(x: torch.Tensor, spec, mesh) -> DTensor:
    """A DTensor of ``x``'s global shape and dtype placed by ``spec``,
    whose local shard is a meta tensor."""
    local = torch.empty(shd.local_shape(x.shape, spec, mesh), dtype=x.dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, shd.placements(spec, mesh),
                              run_check=False, shape=x.shape,
                              stride=torch.empty(x.shape,
                                                 device="meta").stride())


def _placed(abstract, specs, mesh):
    flat = dict(shd.spec_items(specs))
    return tree.unflatten(abstract, {k: _on_mesh(v, flat[k], mesh)
                                     for k, v in tree.items(abstract)})


def _local_bytes(values) -> int:
    total = 0
    for leaf in tree.leaves(values):
        if isinstance(leaf, torch.Tensor):
            t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            total += t.numel() * t.element_size()
    return total


def _peak(tracker) -> int:
    snap = tracker.get_tracker_snapshot("peak")
    return int(sum(v.get("Total", 0) for v in snap.values()))


def run_cell(arch: str, shape_name: str, mesh_kind: str, **knobs) -> dict:
    """The cell's record (the module docstring); ``knobs`` are
    :func:`run_cell_and_reshards`'s keywords."""
    return run_cell_and_reshards(arch, shape_name, mesh_kind, **knobs)[0]


def run_cell_and_reshards(arch: str, shape_name: str, mesh_kind: str,
                          quant_mode: str = "none", kv_quant: bool = False,
                          kv_bits: int = 8, kv_replicate: int = 1,
                          attn_chunk_q: int = 1024, remat: bool = False,
                          act_sharding: str = "none", policy: str = "tp",
                          norm_f32: bool = True, grad_rs: bool = False,
                          mlstm_state_shard: bool = False, tag: str = "",
                          mesh_shape: Optional[Tuple[int, ...]] = None,
                          smoke: bool = False, seq_len: Optional[int] = None,
                          full_loop: bool = False,
                          scan_log: Optional[list] = None
                          ) -> Tuple[dict, list]:
    """(The cell's record, the :class:`reshard.ReshardMode` log of its
    step): the reshards are how the step got past DTensor's refusals, and
    their collectives are inside the record's. The keywords are the
    reference's ``run_cell``'s; ``mesh_shape`` replaces the production
    mesh's shape (its axes ``("data", "model")`` or ``("pod", "data",
    "model")`` by length), ``smoke`` the arch's config by its smoke
    config, ``seq_len`` the cell's sequence length, and ``full_loop``
    runs every step of the scans (no charging), all for tests.
    ``scan_log``, a list, receives the scans' notes
    (``models/lm/scan.py``)."""
    cell = next(s for s in SHAPES if s.shape_name == shape_name)
    if seq_len is not None:
        cell = dataclasses.replace(cell, seq_len=seq_len)
    knobs = dict(quant_mode=quant_mode, kv_quant=kv_quant, kv_bits=kv_bits,
                 kv_replicate=kv_replicate, attn_chunk_q=attn_chunk_q,
                 remat=remat, act_sharding=act_sharding, norm_f32=norm_f32)
    base = (configs.get_smoke_config(arch) if smoke
            else configs.get_config(arch))
    cfg = dataclasses.replace(base, **knobs)
    shape, names = _MESHES[mesh_kind] if mesh_shape is None else (
        tuple(mesh_shape), _MESHES["single" if len(mesh_shape) == 2
                                   else "multi"][1])
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "quant_mode": quant_mode, "kv_quant": kv_quant, "tag": tag,
        "act_sharding": act_sharding, "policy": policy,
        "kind": cell.kind, "seq_len": cell.seq_len,
        "global_batch": cell.global_batch,
        "n_devices": math.prod(shape),
        "lower_s": -1.0, "compile_s": -1.0,
        "flops": -1.0, "bytes_accessed": -1.0,
        "memory": {"argument_bytes": -1, "output_bytes": -1,
                   "temp_bytes": -1, "peak_bytes": -1},
        "collective_bytes": {}, "collective_counts": {},
        "analytic_flops": costs_lib.cell_flops(cfg, cell),
        "analytic_hbm_bytes": costs_lib.cell_hbm_bytes(cfg, cell),
        "model_flops": costs_lib.model_flops(cfg, cell),
        "param_count": base.param_count(),
        "active_param_count": base.active_param_count(),
    }
    coll = CollectiveCounter()
    reshards = ReshardMode(coll)
    try:
        with fake_world(shape, names) as mesh:
            scans = _run_step(rec, cfg, cell, mesh, policy, grad_rs,
                              mlstm_state_shard, coll, reshards, full_loop)
            if scan_log is not None:
                scan_log.extend(scans)
    except Exception as exc:        # the record says why; the CLI fails
        traceback.print_exc()
        lines = str(exc).strip().splitlines()
        rec["error"] = f"{type(exc).__name__}: {lines[0] if lines else ''}"
    return rec, reshards.log


def _run_step(rec, cfg, cell, mesh, policy, grad_rs, mlstm_state_shard,
              coll, reshards, full_loop=False):
    """Runs the cell's step into ``rec``; returns the scans' notes."""
    t0 = time.monotonic()
    params = abstract_params(cfg)
    p_specs = shd.param_specs(params, cfg, mesh, policy)
    b_specs = shd.batch_specs(cfg, cell, mesh, policy)
    batch = {k: _on_mesh(v, b_specs[k], mesh)
             for k, v in input_specs(cfg, cell).items()}
    p = _placed(params, p_specs, mesh)
    if cell.kind == "train":
        opt = AdamW(lr=1e-4, weight_decay=0.1)
        state = abstract_opt_state(cfg, opt)
        # AdamW mu/nu mirror the parameter shardings; step count replicated
        state = AdamWState(
            step=_on_mesh(state.step, shd.P(), mesh),
            mu=_placed(state.mu, p_specs, mesh),
            nu=_placed(state.nu, p_specs, mesh))
        step = make_train_step(cfg, opt,
                               grad_specs=p_specs if grad_rs else None)
        args = (p, state, batch)
    elif cell.kind == "prefill":
        step = make_prefill_step(cfg)
        args = (p, batch)
    else:  # decode: one new token against a full cache
        cache = abstract_cache(cfg, cell)
        c_specs = shd.cache_specs(cache, cfg, cell, mesh,
                                  mlstm_state_shard=mlstm_state_shard)
        step = make_serve_step(cfg)
        args = (p, _placed(cache, c_specs, mesh),
                batch.get("tokens", batch.get("embeds")), cell.seq_len - 1)
    rec["lower_s"] = round(time.monotonic() - t0, 2)
    arg_bytes = _local_bytes(args)
    flops, tracker = _LocalFlops(), _MemTracker()
    t1 = time.monotonic()
    with contextlib.ExitStack() as stack:
        stack.enter_context(implicit_replication())
        try:
            tracker.track_external(*[x.to_local() for x in tree.leaves(args)
                                     if isinstance(x, DTensor)])
            stack.enter_context(tracker)
        except Exception:           # the peak is -1 where it cannot track
            tracker = None
        stack.enter_context(coll)
        stack.enter_context(flops)
        stack.enter_context(reshards)       # innermost: the others see it
        meter = _Meter(flops, coll, reshards, tracker)
        if not full_loop:
            stack.enter_context(scan_lib.charging(meter))
        out = step(*args)
    rec["compile_s"] = round(time.monotonic() - t1, 2)
    peak = _peak(tracker) if tracker is not None else -1
    coll_bytes, coll_counts = analyze_collectives(coll)
    rec.update({
        "flops": float(flops.flops),
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": _local_bytes(out),
                   "temp_bytes": max(peak - arg_bytes, 0) if peak >= 0
                   else -1,
                   "peak_bytes": peak},
        "collective_bytes": coll_bytes, "collective_counts": coll_counts})
    return meter.scans


def scan_line(scans) -> str:
    """The CLI's line on the scans' notes (``models/lm/scan.py``):
    passes, steps, steps run and charged, and the passes that found no
    steady pair (``tools/dryrun_sweep`` reads it)."""
    unsteady = sum(e["steady_at"] is None for e in scans)
    line = (f"  scans: {len(scans)} passes, "
            f"{sum(e['length'] for e in scans)} steps, ran "
            f"{sum(e['ran'] for e in scans)}, charged "
            f"{sum(e['charged'] for e in scans)}")
    if unsteady:
        line += (f"; {unsteady} passes found no steady pair in "
                 f"{scan_lib.MAX_UNSTEADY} steps and ran their whole loop")
    return line


def cell_path(arch, shape, mesh_kind, tag=""):
    name = f"{arch}__{shape}__{mesh_kind}" + (f"__{tag}" if tag else "")
    return os.path.join(ART, name + ".json")


def reshards_path(arch, shape, mesh_kind, tag=""):
    """The reshard log beside the cell's record."""
    return cell_path(arch, shape, mesh_kind, tag)[:-len(".json")] + \
        ".reshards.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--quant", default="none")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--kv-bits", type=int, default=8)
    ap.add_argument("--kv-replicate", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--attn-chunk-q", type=int, default=1024)
    ap.add_argument("--act-sharding", default="none",
                    choices=["none", "dp", "dp_sp"])
    ap.add_argument("--policy", default="tp",
                    choices=["tp", "fsdp", "zero3", "cp"])
    ap.add_argument("--norm-bf16", action="store_true")
    ap.add_argument("--grad-rs", action="store_true")
    ap.add_argument("--mlstm-state-shard", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(ART, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s.shape_name) for a in configs.ARCH_IDS
                 for s in configs.shapes_for(a)]
    else:
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        for mk in meshes:
            path = cell_path(arch, shape, mk, args.tag)
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {path}")
                continue
            print(f"[dryrun] {arch} x {shape} x {mk} "
                  f"quant={args.quant} kv={args.kv_quant}", flush=True)
            scans = []
            try:
                rec, log = run_cell_and_reshards(
                    arch, shape, mk, quant_mode=args.quant,
                    kv_quant=args.kv_quant, kv_bits=args.kv_bits,
                    kv_replicate=args.kv_replicate, remat=args.remat,
                    attn_chunk_q=args.attn_chunk_q,
                    act_sharding=args.act_sharding, policy=args.policy,
                    norm_f32=not args.norm_bf16, grad_rs=args.grad_rs,
                    mlstm_state_shard=args.mlstm_state_shard, tag=args.tag,
                    scan_log=scans)
            except Exception as e:     # a fault outside the step itself
                failures += 1
                print(f"  FAIL: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
                continue
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)
            with open(reshards_path(arch, shape, mk, args.tag), "w") as f:
                json.dump(log, f, indent=2)
            n_rs, rs_bytes, _ = reshard_totals(log)
            if "error" in rec:
                failures += 1
                print(f"  FAIL: {rec['error']}", flush=True)
                continue
            print(f"  ok: flops={rec['flops']:.3e} "
                  f"bytes={rec['bytes_accessed']:.3e} "
                  f"coll={sum(rec['collective_bytes'].values()):.3e} "
                  f"reshards={n_rs} ({sum(rs_bytes.values()):.3e} B) "
                  f"compile={rec['compile_s']}s", flush=True)
            if scans:
                print(scan_line(scans), flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
