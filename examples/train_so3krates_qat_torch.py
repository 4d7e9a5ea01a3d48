"""The paper's full workflow at laptop scale, on the PyTorch/CUDA port.

The twin of ``examples/train_so3krates_qat.py`` through ``repro_torch``:
FP32-train a So3krates force field on the synthetic azobenzene dataset,
then QAT-finetune it with GAQ (W4A8 + MDDQ + geometric STE + LEE
regularization), and compare against naive INT8. On the card every
training step, evaluation batch and LEE force call replays a captured
program. ``--frames``, ``--epochs`` and ``--qat-epochs`` shrink a run.

Run:  PYTHONPATH=src python examples/train_so3krates_qat_torch.py
      [--device cpu]
"""
import argparse

from repro_torch.data.synthetic_md import sample_dataset
from repro_torch.device import resolve_device
from repro_torch.models import so3krates as so3
from repro_torch.training.pipeline import lee_eval
from repro_torch.training.so3_trainer import TrainConfig, evaluate, train

BASE = dict(feat=32, vec_feat=8, n_layers=2)
METHODS = (("GAQ W4A8", dict(quant="gaq_w4a8", dir_bits=12)),
           ("naive INT8", dict(quant="naive_int8", robust_attention=False)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the current CUDA device by default; cpu runs "
                         "every kernel's plain PyTorch version")
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=30,
                    help="fp32 epochs")
    ap.add_argument("--qat-epochs", type=int, default=8,
                    help="QAT epochs per method, the first 2 warm-up")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = sample_dataset(0, args.frames, device=dev)
    mev = float(data["e_scale"]) * 1000

    print("== FP32 training ==")
    cfg32 = so3.So3kratesConfig(**BASE, quant="none")
    params32, _ = train(cfg32, data, TrainConfig(
        epochs=args.epochs, warmup_epochs=0, batch_size=32, lr=5e-3),
        verbose=True, device=dev)
    ev = evaluate(cfg32, params32, data, device=dev)
    print(f"fp32: E-MAE {ev['e_mae'] * mev:.1f} meV, "
          f"F-MAE {ev['f_mae'] * mev:.1f} meV/A")

    for name, kw in METHODS:
        print(f"== QAT finetune: {name} ==")
        cfg = so3.So3kratesConfig(**BASE, **kw)
        params, _ = train(cfg, data, TrainConfig(
            epochs=args.qat_epochs, warmup_epochs=2, batch_size=32, lr=1e-3,
            lee_weight=1.0), init=params32, verbose=True, device=dev)
        ev = evaluate(cfg, params, data, device=dev)
        lee = lee_eval(cfg, params, data, n_rot=4, n_cfg=4, device=dev)
        print(f"{name}: E-MAE {ev['e_mae'] * mev:.1f} meV, "
              f"F-MAE {ev['f_mae'] * mev:.1f} meV/A, LEE {lee * mev:.2f} "
              f"meV/A")


if __name__ == "__main__":
    main()
