"""End-to-end paper-experiment pipeline (Tables II/III/IV, Fig. 3):
counterpart of ``repro/training/pipeline.py``.

Runs: FP32 training -> QAT finetunes (GAQ W4A8, naive INT8, Degree-Quant,
SVQ-KMeans) -> accuracy eval -> LEE eval -> NVE stability -> latency and
memory microbenchmark, on the card unless ``--device cpu``. Saves
checkpoints (the JAX package's ``.npz`` layout: a file written by either
package loads in the other) and ``metrics.json`` under
``artifacts/so3_torch/``; a checkpoint found there is resumed unless
``PIPELINE_FRESH`` is set.

Run:  PYTHONPATH=src python -m repro_torch.training.pipeline [--fast]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.captured import Programs
from repro_torch.core.codebook import make_codebook
from repro_torch.core.lee import lee, random_rotations
from repro_torch.core.quantizers import abs_max_scale, quantize
from repro_torch.data.synthetic_md import MASSES, make_ff, sample_dataset_md
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.md.nve import energy_drift_rate, init_state, nve_trajectory
from repro_torch.models import so3krates as so3
from repro_torch.training.so3_trainer import (TrainConfig, evaluate,
                                              to_device, train)
from repro_torch.weights import params_from_numpy

__all__ = ["ART", "BASE", "METHODS", "save_params", "load_params",
           "lee_eval", "nve_eval", "latency_eval", "main"]

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                   "so3_torch")

BASE = dict(feat=64, vec_feat=16, n_layers=3)
METHODS = {
    "fp32": dict(quant="none"),
    # dir_bits=12 (4096-pt codebook, delta=0.04 rad, 20 bits/vector), as
    # the JAX package's pipeline; LEE is also evaluated with a 16-bit
    # codebook swap (the codebook is not trained)
    "gaq_w4a8": dict(quant="gaq_w4a8", dir_bits=12),
    "naive_int8": dict(quant="naive_int8", robust_attention=False),
    "degree_quant": dict(quant="degree_quant", robust_attention=False),
    "svq_kmeans": dict(quant="svq_kmeans", robust_attention=False,
                       dir_bits=12),
}


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """``np.savez`` of every leaf as float32 numpy, keyed by name."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in params.items()})


def load_params(path: str, device: DeviceLike = None
                ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    with np.load(path) as z:
        return params_from_numpy({k: z[k] for k in z.files}, dev)


def _codebook(cfg, dev):
    return make_codebook(cfg.dir_bits, device=dev) \
        if cfg.quant != "none" else None


def lee_eval(cfg, params, data, n_rot: int = 8, n_cfg: int = 8,
             device: DeviceLike = None) -> float:
    """Mean LEE over the first ``n_cfg`` frames x ``n_rot`` rotations
    (numpy seed 123). The force call is the reference's jitted one: on
    the card a captured program per atom count, each result cloned
    before the next (``lee`` calls it twice)."""
    dev = resolve_device(device)
    data = to_device(data, dev)
    codebook = _codebook(cfg, dev)
    rots = torch.from_numpy(random_rotations(123, n_rot)).to(dev)

    def forces(coords):
        return so3.forces(params, cfg, data["species"], coords, codebook)
    progs = Programs(device=dev, name="the LEE force call")

    def force_fn(c):
        return progs.run(c.shape[0], forces, coords=c).clone()
    errs = [float(lee(force_fn, data["coords"][i], rots[r]))
            for i in range(n_cfg) for r in range(n_rot)]
    return float(np.mean(errs))


def nve_eval(cfg, params, data, n_steps: int, dt_fs: float = 0.5,
             record_every: int = 50, device: DeviceLike = None):
    """NVE run of the azobenzene equilibrium geometry at 300 K (numpy seed
    7) with the learned force field; returns energies and drift rate. The
    reference jits the whole trajectory; here each record segment is a
    captured program on the card (``md.nve.nve_trajectory``)."""
    dev = resolve_device(device)
    data = to_device(data, dev)
    codebook = _codebook(cfg, dev)
    species = data["species"]
    e_scale = float(data["e_scale"])
    masses = torch.tensor(MASSES, dtype=torch.float32, device=dev)

    def force_fn(c):
        return so3.forces(params, cfg, species, c, codebook) * e_scale

    def energy_fn(c):
        with torch.no_grad():
            return so3.energy(params, cfg, species, c, codebook) * e_scale
    eq, _, _ = make_ff(dev)
    t0 = time.monotonic()
    state = init_state(7, eq, masses, force_fn, 300.0)
    _, energies = nve_trajectory(state, masses, force_fn, energy_fn, dt_fs,
                                 n_steps, record_every)
    e = energies.cpu().numpy()
    wall = time.monotonic() - t0
    return {
        "energies": e.tolist(),
        "drift_ev_per_atom_ps": energy_drift_rate(e, dt_fs, record_every, 24),
        "blew_up": bool(~np.isfinite(e).all()
                        or np.abs(e - e[0]).max() > 100.0),
        "wall_s": wall,
        "n_steps": n_steps,
        "dt_fs": dt_fs,
    }


def latency_eval(cfg, params, dim: int = 2048, n_mats: int = 8,
                 device: DeviceLike = None) -> Dict[str, float]:
    """Bandwidth-multiplier microbenchmark (Table IV analogue) on the
    device: ``n_mats`` dim x dim weights (128 MB fp32, beyond the H100's
    50 MB L2) streamed by an elementwise touch in fp32, int8 and packed
    int4 bytes, the f32 GEMV over them, and the int8 -> f32 dequantize;
    microseconds per call (CUDA events on the card, the host clock on the
    CPU), beside the exact model footprint per precision."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    mats = [torch.randn(dim, dim, generator=gen, device=dev)
            for _ in range(n_mats)]
    scales = [abs_max_scale(w, 8) for w in mats]
    ws8 = [quantize(w, s, 8) for w, s in zip(mats, scales)]
    ws4 = [w.view(torch.uint8)[:, :dim // 2].contiguous() for w in ws8]
    x = torch.ones(dim, device=dev)
    reps = 10

    def bench(fn) -> float:
        fn()  # warm
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / reps * 1e3
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6

    results: Dict[str, float] = {"device": (
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")}
    # weight-I/O rows: an elementwise touch reads and writes every byte
    results["weight_io_fp32_us"] = bench(lambda: [w + 1.0 for w in mats])
    results["weight_io_int8_us"] = bench(lambda: [w + 1 for w in ws8])
    results["weight_io_int4_us"] = bench(lambda: [w + 1 for w in ws4])
    results["gemv_us"] = bench(lambda: sum((x @ w).sum() for w in mats))
    results["quant_overhead_us"] = bench(
        lambda: [w.to(torch.float32) * s for w, s in zip(ws8, scales)])
    results["bytes_fp32"] = int(n_mats * dim * dim * 4)
    results["bytes_int8"] = int(n_mats * dim * dim)
    results["bytes_int4"] = int(n_mats * dim * dim // 2)
    # exact model footprint per precision (weights only)
    n_weights = int(sum(v.numel() for v in params.values()))
    results["model_bytes_fp32"] = n_weights * 4
    results["model_bytes_w8"] = n_weights
    results["model_bytes_w4"] = n_weights // 2
    return results


def _split_data(data, n_train):
    def part(sl):
        return {**data, "coords": data["coords"][sl],
                "energy": data["energy"][sl], "forces": data["forces"][sl]}
    return part(slice(None, n_train)), part(slice(n_train, None))


def main(fast: bool = False, device: DeviceLike = None) -> Dict[str, dict]:
    dev = resolve_device(device)
    os.makedirs(ART, exist_ok=True)
    t_start = time.monotonic()
    wall: Dict[str, float] = {}
    n_train, n_test = (96, 32) if fast else (384, 128)
    # rMD17 protocol: train/test frames drawn from a 300K MD trajectory
    data = sample_dataset_md(0, n_train + n_test, device=dev)
    train_data, test_data = _split_data(data, n_train)
    wall["data"] = time.monotonic() - t_start

    fp32_epochs = 15 if fast else 150
    qat_epochs = 6 if fast else 40
    warm = 2 if fast else 5
    nve_steps = 2000 if fast else 40000
    fresh = bool(os.environ.get("PIPELINE_FRESH"))

    metrics: Dict[str, dict] = {"units": {
        "e_scale_eV": float(data["e_scale"]),
        "note": "MAEs stored in scaled units; multiply by e_scale*1000 "
                "for meV",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")}}

    # ---- FP32 baseline (resumes from checkpoint if present) ---------------
    cfg32 = so3.So3kratesConfig(**BASE, **METHODS["fp32"])
    t0 = time.monotonic()
    fp32_ckpt = os.path.join(ART, "ckpt_fp32.npz")
    if os.path.exists(fp32_ckpt) and not fresh:
        params32 = load_params(fp32_ckpt, dev)
        hist = {"loss": [float("nan")]}
        print("[fp32] resumed from", fp32_ckpt, flush=True)
    else:
        params32, hist = train(cfg32, train_data,
                               TrainConfig(epochs=fp32_epochs,
                                           warmup_epochs=0, batch_size=32,
                                           lr=5e-3), verbose=True, device=dev)
        save_params(fp32_ckpt, params32)
    ev = evaluate(cfg32, params32, test_data, device=dev)
    metrics["fp32"] = {**ev, "train_s": time.monotonic() - t0,
                       "final_loss": hist["loss"][-1]}
    print("[fp32]", metrics["fp32"], flush=True)

    # ---- QAT finetunes (resume from checkpoints when present) -------------
    params_of = {"fp32": params32}
    for name in ["gaq_w4a8", "naive_int8", "degree_quant", "svq_kmeans"]:
        cfg = so3.So3kratesConfig(**BASE, **METHODS[name])
        t0 = time.monotonic()
        ckpt = os.path.join(ART, f"ckpt_{name}.npz")
        if os.path.exists(ckpt) and not fresh:
            params = load_params(ckpt, dev)
            hist = {"loss": [0.0]}
            print(f"[{name}] resumed from {ckpt}", flush=True)
        else:
            params, hist = train(cfg, train_data,
                                 TrainConfig(epochs=qat_epochs,
                                             warmup_epochs=warm,
                                             batch_size=32, lr=1e-3,
                                             lee_weight=1.0,
                                             lee_rotations=2),
                                 init=params32, verbose=True, device=dev)
            save_params(ckpt, params)
        params_of[name] = params
        ev = evaluate(cfg, params, test_data, device=dev)
        metrics[name] = {**ev, "train_s": time.monotonic() - t0,
                         "final_loss": hist["loss"][-1],
                         "diverged": not np.isfinite(hist["loss"][-1])}
        print(f"[{name}]", metrics[name], flush=True)

    # ---- LEE (Table III) --------------------------------------------------
    t0 = time.monotonic()
    for name in ["fp32", "gaq_w4a8", "naive_int8", "degree_quant"]:
        cfg = so3.So3kratesConfig(**BASE, **METHODS[name])
        metrics[name]["lee"] = lee_eval(cfg, params_of[name], test_data,
                                        device=dev)
        print(f"[lee] {name}: {metrics[name]['lee']:.6f}", flush=True)
    # eval-only codebook refinement: same gaq weights, 16-bit directions
    cfg16 = so3.So3kratesConfig(**BASE, quant="gaq_w4a8", dir_bits=16)
    metrics["gaq_w4a8"]["lee_dir16"] = lee_eval(
        cfg16, params_of["gaq_w4a8"], test_data, n_rot=4, n_cfg=4,
        device=dev)
    print(f"[lee] gaq dir16: {metrics['gaq_w4a8']['lee_dir16']:.6f}",
          flush=True)
    wall["lee"] = time.monotonic() - t0

    # ---- NVE (Fig. 3) -----------------------------------------------------
    t0 = time.monotonic()
    for name in ["fp32", "gaq_w4a8", "naive_int8"]:
        cfg = so3.So3kratesConfig(**BASE, **METHODS[name])
        metrics[name]["nve"] = nve_eval(cfg, params_of[name], test_data,
                                        nve_steps, device=dev)
        print(f"[nve] {name}: drift="
              f"{metrics[name]['nve']['drift_ev_per_atom_ps']:.2e} "
              f"blew_up={metrics[name]['nve']['blew_up']}", flush=True)
    wall["nve"] = time.monotonic() - t0

    # ---- latency / memory (Table IV) --------------------------------------
    t0 = time.monotonic()
    metrics["latency"] = latency_eval(cfg32, params32, device=dev)
    print("[latency]", metrics["latency"], flush=True)
    wall["latency"] = time.monotonic() - t0
    wall["total"] = time.monotonic() - t_start
    # each method's training and evaluation: metrics[name]["train_s"]
    metrics["wall_s"] = wall
    print("[wall_s]", wall, flush=True)

    with open(os.path.join(ART, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print("pipeline done ->", os.path.join(ART, "metrics.json"))
    return metrics


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="96/32 frames, 15 fp32 and 6 QAT epochs, 2,000 "
                    "NVE steps")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the current one)")
    args = ap.parse_args()
    main(args.fast, args.device)
