#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and prints the build seconds.
2. Holds every kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it (paper config, bucket 32, 8
   molecules per batch): the quantized matmuls bit for bit, the edge
   softmax to 1e-5 (and its gradients to 1e-4 rel / 1e-5 abs), the MDDQ
   encode codes exactly. Times each kernel (CUDA events over back-to-back
   calls, which at these sizes include the host's launch gaps, and its
   device time from torch.profiler), its plain version and, where one
   PyTorch call computes the same function, that call (a yardstick only:
   the port never calls it), beside the card's least time for the same
   work.
3. Serves 16 molecules of 9-24 atoms through ``QuantizedEngine`` at the
   paper's full width (W4A8, MDDQ through the encode kernel) on the
   sparse path, then the dense path, with every kernel's launch count
   set to 0 just before each run and read just after. Checks finite
   results, sparse against dense, and the card against the CPU plain
   path on the same weights. Splits the w4a8 sparse-vs-dense gap (the
   same batch with MDDQ off; the MDDQ codes that differ per layer).
   Prints per-batch latency, the device idle share and the LEE.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that. Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12

M_ROWS = 256                 # 8 molecules x 32-atom bucket
TRUNK_W8 = (64, 192)         # wq | wk | wm
TRUNK_W4 = (64, 32)          # wa | wb
OTHER_W8 = {"w_upd": (64, 64), "w_vnorm": (16, 64), "ro_w1": (80, 64)}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(torch, fn, reps: int = 20, rounds: int = 11) -> float:
    """Median over ``rounds`` of CUDA-event time for ``reps`` calls, per
    call (warmed up first)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return statistics.median(per)


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _device_rows(torch, prof):
    """(ms, count, name) of the device-side events of a profile (kernels,
    copies), longest first: the host ops that launch them carry the same
    device time again, so only these are summed."""
    from torch.autograd import DeviceType
    rows = [(_device_us(e) / 1e3, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted((r for r in rows if r[0] > 0), reverse=True)


def device_ms(torch, fn, reps: int = 20):
    """Device time per call of what ``fn`` launches, from torch.profiler;
    None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(r[0] for r in _device_rows(torch, prof))
    return total / reps if total > 0 else None


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --- phase 2: kernels against their plain versions ---------------------------

def check_quant_matmul(torch, dev, gen):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quant_matmul import w4a8_matmul, w8a8_matmul
    rows = []
    shapes = [("trunk_w8", *TRUNK_W8)] + [(k, *v) for k, v in
                                           OTHER_W8.items()]
    for w4 in (False, True):
        for name, k, n in ([("trunk_w4", *TRUNK_W4)] if w4 else shapes):
            x = torch.randn(M_ROWS, k, generator=gen, device=dev)
            w = torch.randn(k, n, generator=gen, device=dev)
            a_q, a_s = ops.quantize_activations(x)
            w_q, w_s = ops.prepare_w4(w) if w4 else ops.prepare_w8(w)
            kern = w4a8_matmul if w4 else w8a8_matmul
            plain = ref.w4a8_matmul_ref if w4 else ref.w8a8_matmul_ref
            got = kern(a_q, a_s, w_q, w_s)
            want = plain(a_q, a_s, w_q, w_s)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            print(f"  {kern.__name__} {name} M={M_ROWS} K={k} N={n}: "
                  f"bit-identical={torch.equal(got, want)} max_abs_err={err}")
            require(torch.equal(got, want),
                    f"{kern.__name__} {name} differs from its plain version")
            if name.startswith("trunk"):
                ms = time_ms(torch, lambda: kern(a_q, a_s, w_q, w_s))
                dev_ms = device_ms(torch, lambda: kern(a_q, a_s, w_q, w_s))
                plain_ms = time_ms(torch, lambda: plain(a_q, a_s, w_q, w_s))
                lib_ms = None
                if not w4:
                    lib_ms = time_ms(torch, lambda: torch._int_mm(a_q, w_q)
                                     .to(torch.float32) * a_s * w_s)
                w_bytes = k * n // 2 if w4 else k * n
                n_bytes = M_ROWS * k + 4 * M_ROWS + w_bytes + 4 * n \
                    + 4 * M_ROWS * n
                b_ms, b_by = bound(n_bytes, 2 * M_ROWS * n * k,
                                   INT8_OPS_PER_S)
                rows.append({
                    "name": kern.__name__, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
                    "replaces": ("src/repro/kernels/quant_matmul.py:119"
                                 if w4 else
                                 "src/repro/kernels/quant_matmul.py:83"),
                    "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "shape": f"M={M_ROWS} K={k} N={n}"})
    return rows


def serving_edge_list(graphs, cutoff):
    """The edge list of the first 8-molecule batch the engine serves."""
    from repro_torch.serving import (BucketSpec, build_edge_list,
                                     pad_graphs, plan_batches)
    plan = plan_batches(graphs, [BucketSpec(32, max_batch=8,
                                            edge_capacity=1024)])[0]
    _, coords, mask = pad_graphs(graphs, plan)
    el = build_edge_list(coords, mask, cutoff, 1024)
    require(el is not None, "edge list overflowed its capacity")
    return el, plan.batch_size * 32


def check_edge_softmax(torch, dev, gen, graphs, cfg):
    from repro_torch.core.attention_norm import l2_normalize
    from repro_torch.kernels import ops
    from repro_torch.kernels.edge_softmax import edge_softmax_fused
    from repro_torch.kernels.ref import edge_softmax_ref
    el, n = serving_edge_list(graphs, cfg.cutoff)
    F, W = cfg.feat, cfg.feat + 3 * cfg.vec_feat
    E = el.senders.shape[0]
    s = torch.from_numpy(el.senders).to(dev)
    r = torch.from_numpy(el.receivers).to(dev)
    m = torch.from_numpy(el.edge_mask).to(dev)
    q = cfg.tau * l2_normalize(torch.randn(n, F, generator=gen, device=dev))
    k = l2_normalize(torch.randn(n, F, generator=gen, device=dev))
    bias = torch.randn(E, generator=gen, device=dev)
    vals = torch.randn(E, W, generator=gen, device=dev)
    got = edge_softmax_fused(q, k, bias, vals, s, r, m, 32)
    want = edge_softmax_ref(q, k, bias, s, r, m, vals, n)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    has_edge = torch.zeros(n, dtype=torch.bool, device=dev)
    has_edge[r[m].long()] = True
    n_empty = int((~has_edge).sum())
    empty_zero = bool((got[~has_edge] == 0).all())
    print(f"  edge_softmax N={n} E={E} real={el.n_real} F={F} W={W}: "
          f"max_abs_err={err}, {n_empty} empty receivers exactly 0: "
          f"{empty_zero}")
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
            f"edge_softmax differs from its plain version by {err}")
    require(empty_zero, "edge_softmax: an empty receiver is not exactly 0")

    # the Function's backward against plain autograd, both fed one output
    # cotangent: a loss such as sum(out**2) would also feed the backward
    # the two forwards' 1e-7 differences, which the tau-scaled logits
    # amplify past 1e-5 on gradients of size ~150 (seen on the card).
    # Both backwards sum with index_add, on atomics; deterministic
    # algorithms give both one summation order.
    g_out = torch.randn(n, W, generator=gen, device=dev)

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, bias, vals)]
        return torch.autograd.grad(fn(*ins), ins, g_out)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        g_ker = grads(lambda q_, k_, b_, v_: ops.edge_softmax(
            q_, k_, b_, v_, s, r, m, cap=32))
        g_ref = grads(lambda q_, k_, b_, v_: edge_softmax_ref(
            q_, k_, b_, s, r, m, v_, n))
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    for name, a, b in zip(("q", "k", "bias", "values"), g_ker, g_ref):
        require(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
                f"edge_softmax gradient wrt {name} off by "
                f"{float((a - b).abs().max())}")
    print("  edge_softmax gradients (autograd.Function vs plain autograd, "
          "one cotangent): within 1e-4 rel / 1e-5 abs")

    ms = time_ms(torch, lambda: edge_softmax_fused(q, k, bias, vals, s, r,
                                                   m, 32))
    dev_ms = device_ms(torch, lambda: edge_softmax_fused(q, k, bias, vals, s,
                                                         r, m, 32))
    plain_ms = time_ms(torch, lambda: edge_softmax_ref(q, k, bias, s, r, m,
                                                       vals, n))
    e_r = el.n_real
    n_bytes = 2 * n * F * 4 + e_r * (4 + 4 * W + 4 + 4 + 1) + n * W * 4
    b_ms, b_by = bound(n_bytes, e_r * (2 * F + 3 * W + 8), FP32_OPS_PER_S)
    return [{"name": "edge_softmax_fused", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/edge_softmax.cu",
             "replaces": "src/repro/kernels/edge_softmax.py:100",
             "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None,
             "shape": f"N={n} E={E} real={e_r} F={F} W={W}"}]


def check_mddq_encode(torch, dev, gen, cfg):
    from repro_torch.core.codebook import make_codebook
    from repro_torch.kernels.mddq_kernel import mddq_encode_kernel
    from repro_torch.kernels.ref import mddq_encode_ref
    n = M_ROWS * cfg.vec_feat
    cb = make_codebook(cfg.dir_bits, device=dev)
    C = cb.shape[0]
    v = torch.randn(n, 3, generator=gen, device=dev) \
        * torch.exp(2 * torch.randn(n, 1, generator=gen, device=dev))
    v[:8] = 0.0                                  # zero vectors (padding)
    v[8:16] = cb[:8] * 3.0                       # exact codewords
    idx, mag = mddq_encode_kernel(v, cb)
    idx_p, mag_p = mddq_encode_ref(v, cb)
    torch.cuda.synchronize()
    n_idx = int((idx != idx_p).sum())
    n_mag = int((mag != mag_p).sum())
    err = float(max((idx - idx_p).abs().max(), (mag - mag_p).abs().max()))
    print(f"  mddq_encode N={n} C={C}: idx mismatches {n_idx}, "
          f"mag mismatches {n_mag}")
    require(n_idx == 0 and n_mag == 0,
            "mddq_encode codes differ from its plain version")
    ms = time_ms(torch, lambda: mddq_encode_kernel(v, cb), reps=10)
    dev_ms = device_ms(torch, lambda: mddq_encode_kernel(v, cb), reps=10)
    plain_ms = time_ms(torch, lambda: mddq_encode_ref(v, cb), reps=3,
                       rounds=5)
    b_ms, b_by = bound(12 * n + 12 * C + 8 * n, 5 * n * C, FP32_OPS_PER_S)
    return [{"name": "mddq_encode_kernel", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/mddq_encode.cu",
             "replaces": "src/repro/kernels/mddq_kernel.py:51",
             "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None, "shape": f"N={n} C={C}"}]


# --- phase 3: the engine -----------------------------------------------------

def kernel_counters():
    from repro_torch.kernels.edge_softmax import edge_softmax_fused
    from repro_torch.kernels.mddq_kernel import mddq_encode_kernel
    from repro_torch.kernels.quant_matmul import w4a8_matmul, w8a8_matmul
    return [w8a8_matmul, w4a8_matmul, edge_softmax_fused, mddq_encode_kernel]


def counted_run(fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before;
    return (result, {kernel: launches})."""
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    out = fn()
    return out, {c.__name__: c.launches for c in counters}


def max_rel(a_results, b_results):
    """(max |energy diff|, max |force diff|), each over the largest
    |value| on the b side."""
    de = max(abs(a.energy - b.energy) for a, b in zip(a_results, b_results))
    df = max(float(np.abs(a.forces - b.forces).max())
             for a, b in zip(a_results, b_results))
    e_scale = max(abs(b.energy) for b in b_results)
    f_scale = max(float(np.abs(b.forces).max()) for b in b_results)
    return de / e_scale, df / f_scale


def profile_batch(torch, eng, graphs, reps: int = 7):
    """Device busy time of one sparse 8-molecule batch (torch.profiler),
    as a share of the median unprofiled latency of the same batch (host
    clock, ``reps`` runs) and of the profiled batch's own wall time, which
    the profiler inflates; and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        eng.infer_batch(graphs)
        lat.append((time.perf_counter() - t0) * 1e3)
    plain_ms = statistics.median(lat)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.infer_batch(graphs)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(torch, prof)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        print("  profiler: no device time recorded (device busy share "
              "not measured)")
        return
    print(f"  profiled sparse batch: device busy {busy_ms:.3f} ms, "
          f"{sum(r[1] for r in rows)} device events; unprofiled latency "
          f"{plain_ms:.3f} ms (median of {reps}) -> idle share "
          f"{1 - busy_ms / plain_ms:.3f}; profiled wall {wall_ms:.3f} ms "
          f"-> idle share {1 - busy_ms / wall_ms:.3f}")
    for t_ms, count, key in rows[:10]:
        print(f"    {t_ms:9.4f} ms  x{count:<4d} {key[:90]}")


def stage_times(torch, eng, graphs, reps: int = 5):
    """Host-clock split of one sparse 8-molecule batch into the engine's
    stages, each ended by a synchronize: host prep (plan, pad, numpy edge
    list), copies to the card, forward, backward (forces), copy back.
    Medians over ``reps``."""
    from repro_torch.core.codebook import make_codebook
    from repro_torch.serving import build_edge_list, pad_graphs, plan_batches
    from repro_torch.serving.forward import sparse_energy
    cfg, dev = eng.model_cfg, eng.device
    codebook = make_codebook(cfg.dir_bits, device=dev)
    stages = {k: [] for k in ("prep", "to_card", "forward", "backward",
                              "to_host")}
    for _ in range(reps):
        t0 = time.perf_counter()
        plan = plan_batches(graphs, eng.serve.buckets())[0]
        species, coords, mask = pad_graphs(graphs, plan)
        el = build_edge_list(coords, mask, cfg.cutoff, plan.bucket.edges)
        t1 = time.perf_counter()
        args = [torch.from_numpy(a).to(dev) for a in (
            species, coords, mask, el.senders, el.receivers, el.edge_mask)]
        args[1].requires_grad_()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        e = sparse_energy(eng.qparams, cfg, *args, codebook,
                          mddq_kernel=eng.serve.mddq_kernel)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        (grad,) = torch.autograd.grad(e.sum(), args[1])
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        _ = (e.detach().cpu().numpy(), grad.cpu().numpy())
        t5 = time.perf_counter()
        for k, a, b in zip(stages, (t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
            stages[k].append((b - a) * 1e3)
    split = {k: statistics.median(v) for k, v in stages.items()}
    print("  sparse batch stages (host clock, median of "
          f"{reps}, ms): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in split.items()))


def split_sparse_dense_gap(torch, dev, cfg, params, common, graphs):
    """Where the w4a8 sparse-vs-dense gap comes from, on one 8-molecule
    batch: the gap with MDDQ off (A8 activations and W4/W8 weights still
    rounded), and per layer the MDDQ codes that differ between the two
    paths, whose inputs differ only by the paths' summation orders. The
    serve-time quantizer is wrapped for this one run so that each call
    records the codes it finds. Returns the MDDQ-off (rel_e, rel_f) and
    per layer (moved direction codes, moved magnitude codes, nonzero
    vectors)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import QuantizedEngine, ServeConfig

    def serve(path, **kw):
        return QuantizedEngine(cfg, params, ServeConfig(
            path=path, **dict(common, **kw)), device=dev).infer_batch(graphs)
    no_vq = {p: serve(p, quant_vectors=False) for p in ("sparse", "dense")}
    rel_e, rel_f = max_rel(no_vq["sparse"], no_vq["dense"])
    print(f"  w4a8 with MDDQ off, sparse vs dense: energy {rel_e}, "
          f"forces {rel_f}")

    qdq, codes = ops.mddq_qdq_kernel, {}

    def recording(v, mddq_cfg, codebook):
        idx, mag = ops.mddq_encode(v.detach(), codebook,
                                   mag_bits=mddq_cfg.magnitude_bits,
                                   m_min=mddq_cfg.m_min,
                                   m_max=mddq_cfg.m_max)
        nonzero = (v.detach() ** 2).sum(-1) > 0
        codes[path].append((idx.reshape(-1), mag.reshape(-1),
                            nonzero.reshape(-1)))
        return qdq(v, mddq_cfg, codebook)
    ops.mddq_qdq_kernel = recording
    try:
        for path in ("sparse", "dense"):
            codes[path] = []
            serve(path)
    finally:
        ops.mddq_qdq_kernel = qdq
    per_layer = []
    for (i_s, m_s, nz_s), (i_d, m_d, nz_d) in zip(codes["sparse"],
                                                  codes["dense"]):
        nz = nz_s | nz_d
        per_layer.append((int((i_s != i_d)[nz].sum()),
                          int((m_s != m_d)[nz].sum()), int(nz.sum())))
    print("  MDDQ codes that differ, sparse vs dense, per layer "
          "(direction, magnitude, of nonzero vectors): "
          + ", ".join(f"{a}/{b}/{n}" for a, b, n in per_layer))
    return (rel_e, rel_f), per_layer


def run_engine(torch, dev, cfg, graphs):
    from repro_torch.models.so3krates import init_params
    from repro_torch.serving import QuantizedEngine, ServeConfig
    params = init_params(cfg, seed=0, device=dev)
    common = dict(mode="w4a8", bucket_sizes=(32,), max_batch=8,
                  edge_capacity=1024, mddq_kernel=True)
    engines = {p: QuantizedEngine(cfg, params, ServeConfig(path=p, **common),
                                  device=dev)
               for p in ("sparse", "dense")}
    kinds = {n: engines["sparse"].qparams[f"layer0/{n}"].kind
             for n in ("wq", "wa", "w_upd1")}
    require(kinds == {"wq": "w8", "wa": "w4", "w_upd1": "w8"},
            f"unexpected w4a8 weight kinds {kinds}")
    for p, eng in engines.items():
        print(f"  warmup {p}: {eng.warmup():.3f} s")

    results, launches = {}, {}
    for p, eng in engines.items():
        eng.reset_stats()
        results[p], launches[p] = counted_run(lambda: eng.infer_batch(graphs))
        print(f"  {p}: dispatch {eng.dispatch_stats}, launches {launches[p]}")
    require(engines["sparse"].dispatch_stats["sparse"] == 2,
            "the sparse engine did not run both batches sparse")
    for name, n in launches["sparse"].items():
        require(n > 0, f"{name} was not launched on the sparse path")
    for name in ("w8a8_matmul", "w4a8_matmul", "mddq_encode_kernel"):
        require(launches["dense"][name] > 0,
                f"{name} was not launched on the dense path")

    for p, res in results.items():
        for g, r in zip(graphs, res):
            require(r.forces.shape == (g.n_atoms, 3), f"{p}: forces shape")
            require(np.isfinite(r.energy) and np.isfinite(r.forces).all(),
                    f"{p}: non-finite result")
    rel_e, rel_f = max_rel(results["sparse"], results["dense"])
    print(f"  sparse vs dense (rel. to the largest |value|): energy {rel_e}, "
          f"forces {rel_f}")
    # the two paths sum in different orders, and an ulp that crosses an
    # MDDQ direction boundary moves a vector by a whole codebook spacing
    # (~0.014 rad at 16 bits): the split below counts the moved codes
    require(rel_e < 1e-2 and rel_f < 1e-2,
            f"sparse and dense disagree: {rel_e}, {rel_f}")

    # the same sums on card and CPU except in the edge softmax, so codes
    # rarely move: held to the CPU parity tests' quantized-mode tolerance
    cpu = QuantizedEngine(cfg, {k: v.cpu() for k, v in params.items()},
                          ServeConfig(path="sparse", **common), device="cpu")
    ref = cpu.infer_batch(graphs[:8])
    rel_e, rel_f = max_rel(results["sparse"][:8], ref)
    print(f"  card vs CPU plain path, 8 molecules: energy {rel_e}, "
          f"forces {rel_f}")
    require(rel_e < 1e-4 and rel_f < 1e-4,
            f"card and CPU plain path disagree: {rel_e}, {rel_f}")

    # fp32 mode has no rounding to amplify an ulp: the edge-softmax kernel
    # inside the full model is held to the dense oracle tightly
    fp32 = {p: QuantizedEngine(cfg, params, ServeConfig(
        path=p, **dict(common, mode="fp32")), device=dev).infer_batch(graphs)
        for p in ("sparse", "dense")}
    rel_e, rel_f = max_rel(fp32["sparse"], fp32["dense"])
    print(f"  fp32 mode, sparse vs dense: energy {rel_e}, forces {rel_f}")
    require(rel_e < 1e-5 and rel_f < 1e-5,
            f"fp32 sparse and dense disagree: {rel_e}, {rel_f}")

    # with MDDQ off the paths agree as closely as in fp32 (no A8 code
    # moves), so the w4a8 gap above is the moved MDDQ codes: a handful
    # per layer, held under 0.5% of the vectors
    (rel_e, rel_f), moved = split_sparse_dense_gap(torch, dev, cfg, params,
                                                   common, graphs[:8])
    require(rel_e < 1e-5 and rel_f < 1e-5,
            f"w4a8 with MDDQ off: sparse and dense disagree: {rel_e}, "
            f"{rel_f}")
    require(all(d <= 0.005 * n and m <= 0.005 * n for d, m, n in moved),
            f"too many MDDQ codes differ between the paths: {moved}")

    for p, eng in engines.items():
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            eng.infer_batch(graphs)
        per_batch = (time.perf_counter() - t0) / (2 * reps) * 1e3
        print(f"  {p}: {per_batch:.3f} ms per 8-molecule batch "
              f"(host clock over {reps} x 16 requests, forces included)")
    profile_batch(torch, engines["sparse"], graphs[:8])
    stage_times(torch, engines["sparse"], graphs[:8])
    lee = engines["sparse"].lee_diagnostic(graphs, seed=0, n_rotations=4)
    print(f"  LEE over 4 rotations (sparse): {lee}")
    require(np.isfinite(lee["lee_max"]), "LEE is not finite")
    return launches["sparse"]


def main() -> int:
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no {src / 'repro_torch'}: run it from the root "
              "of a checkout of the repo", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.models.so3krates import So3kratesConfig
    from repro_torch.serving import random_graphs

    dev = torch.device("cuda", 0)
    print(gpu_identity())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    _build.library()
    print(f"phase 1: kernels built and loaded in "
          f"{_build.build_seconds():.1f} s")

    cfg = So3kratesConfig(feat=64, vec_feat=16, n_layers=3, n_rbf=16,
                          cutoff=10.0, dir_bits=16)
    graphs = random_graphs(16, 9, 24, cfg.n_species, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print("phase 2: kernels against their plain versions")
    rows = check_quant_matmul(torch, dev, gen)
    rows += check_edge_softmax(torch, dev, gen, graphs, cfg)
    rows += check_mddq_encode(torch, dev, gen, cfg)
    for r in rows:
        print(f"  {r['name']} ({r['shape']}): {r['ms']:.5f} ms per call "
              f"(CUDA events, back to back), device {r['device_ms']} ms "
              f"(profiler), plain {r['plain_ms']:.5f} ms, library "
              f"{r['library_ms']} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})")

    print("phase 3: QuantizedEngine, paper config, w4a8, MDDQ kernel")
    launches = run_engine(torch, dev, cfg, graphs)
    for row in rows:
        row["launches"] = launches[row["name"]]
    require("jax" not in sys.modules and "repro" not in sys.modules,
            "the smoke run imported JAX or the JAX package")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
