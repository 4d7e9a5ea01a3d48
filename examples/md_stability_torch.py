"""NVE molecular dynamics with a learned (and quantized) force field, on
the PyTorch/CUDA port.

The twin of ``examples/md_stability.py`` through ``repro_torch`` (the
paper's Fig. 3 experiment at reduced scale). Uses the port pipeline's
fp32 checkpoint (``artifacts/so3_torch/ckpt_fp32.npz``) if present, else
trains a quick FP32 model. Builds a serving engine from the trained
weights, bridges it into an MD engine (``engine.md_engine()``: MD and
serving share one set of quantized parameters), runs NVE (each record
segment a captured program on the card, the skin list rebuilt on the
device), and reports the energy drift rate, the skin-rebuild frequency,
and how closely the served (quantized, batched) forces track the fp32
model, with the served model's LEE diagnostic. ``--steps``, ``--frames``
and ``--epochs`` shrink a run; ``--ckpt`` names another checkpoint.

Run:  PYTHONPATH=src python examples/md_stability_torch.py [--steps 4000]
      [--device cpu]
"""
import argparse
import os
import time

import numpy as np

from repro_torch.data.synthetic_md import MASSES, sample_dataset
from repro_torch.device import resolve_device
from repro_torch.md import MDConfig, energy_drift_rate, pad_replicas
from repro_torch.models import so3krates as so3
from repro_torch.serving import Graph, QuantizedEngine, ServeConfig
from repro_torch.training import pipeline as pipe
from repro_torch.training.so3_trainer import TrainConfig, train

# skin 1.0 A: azobenzene's H atoms vibrate fast, and at 24 atoms the extra
# edge slots are cheap next to fewer rebuilds
REC_EVERY = 50


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--dt-fs", type=float, default=0.25)
    ap.add_argument("--serve-mode", default="w8a8",
                    choices=["fp32", "w8a8", "w4a8"])
    ap.add_argument("--replicas", type=int, default=1,
                    help="independent NVE replicas integrated in one batch")
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=30,
                    help="epochs of the quick fp32 training")
    ap.add_argument("--ckpt", default=os.path.join(pipe.ART,
                                                   "ckpt_fp32.npz"))
    ap.add_argument("--device", default=None,
                    help="the current CUDA device by default; cpu runs "
                         "every kernel's plain PyTorch version")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = sample_dataset(0, args.frames, device=dev)
    if os.path.exists(args.ckpt):
        cfg = so3.So3kratesConfig(**pipe.BASE, **pipe.METHODS["fp32"])
        params = pipe.load_params(args.ckpt, dev)
        print("using pipeline checkpoint", args.ckpt)
    else:
        cfg = so3.So3kratesConfig(feat=32, vec_feat=8, n_layers=2)
        params, _ = train(cfg, data, TrainConfig(
            epochs=args.epochs, warmup_epochs=0, batch_size=32, lr=5e-3),
            device=dev)

    # deployment step: fold the label standardization into the (linear)
    # energy head, so the served model emits physical eV directly
    e_scale = float(data["e_scale"])
    params = {**params, "ro_w2": params["ro_w2"] * e_scale}

    # --- serving engine + device-resident MD off the same quantized weights
    engine = QuantizedEngine.from_config(
        cfg, params=params, serve=ServeConfig(
            mode=args.serve_mode, bucket_sizes=(32,), max_batch=8),
        device=dev)
    mem = engine.memory_report()
    print(f"serving mode={args.serve_mode} device={engine.device}: fp32 "
          f"{mem['fp32_bytes'] / 1e3:.1f} KB -> "
          f"{mem['served_bytes'] / 1e3:.1f} KB ({mem['compression_x']}x)")

    md = engine.md_engine(MDConfig(mode=args.serve_mode, dt_fs=args.dt_fs,
                                   record_every=REC_EVERY, skin=1.0))
    species = data["species"].cpu().numpy().astype(np.int32)
    eq = data["coords"][0].cpu().numpy()
    masses = np.asarray(MASSES, np.float32)
    spec_b, co_b, mask_b = pad_replicas(species, eq, args.replicas)
    masses_b = np.broadcast_to(masses, mask_b.shape)

    state = md.init_state(7, spec_b, co_b, mask_b, masses_b,
                          temperature_K=300.0)
    t0 = time.time()
    state, rec = md.run(state, spec_b, mask_b, masses_b, n_steps=args.steps)
    wall = time.time() - t0
    e = rec["e_tot"][:, 0]
    # the drift fit wants uniform spacing: drop any tail record
    drift = energy_drift_rate(e[:args.steps // REC_EVERY], args.dt_fs,
                              REC_EVERY, species.shape[0])
    blew_up = bool(~np.isfinite(e).all() or np.abs(e - e[0]).max() > 100.0)
    print(f"\nNVE ({args.serve_mode}, device-resident) {args.steps} steps "
          f"@{args.dt_fs}fs x{args.replicas} replica(s): "
          f"drift {drift * 1000:.3f} meV/atom/ps, blew_up={blew_up}, "
          f"wall {wall:.1f}s ({args.steps * args.replicas / wall:.0f} "
          f"steps/s), skin rebuilds {rec['n_rebuilds']} "
          f"(every ~{args.steps / max(rec['n_rebuilds'], 1):.0f} steps)")

    # --- deployment check: served forces track the fp32 model -------------
    frames = [Graph(species=species, coords=data["coords"][i].cpu().numpy())
              for i in range(8)]
    served = engine.infer_batch(frames)
    f_ref = np.stack([so3.forces(params, cfg, data["species"],
                                 data["coords"][i]).cpu().numpy()
                      for i in range(8)])
    f_srv = np.stack([r.forces for r in served])
    fmae = float(np.abs(f_srv - f_ref).mean())
    print(f"served vs fp32 forces on 8 test frames: MAE {fmae:.4f} (eV/A)")
    diag = engine.lee_diagnostic(frames[:4], seed=3, n_rotations=2)
    print(f"served-model LEE: mean {diag['lee_mean']:.3e} "
          f"max {diag['lee_max']:.3e}")


if __name__ == "__main__":
    main()
