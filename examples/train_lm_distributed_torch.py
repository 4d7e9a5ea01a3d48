"""End-to-end distributed-style LM training on the PyTorch/CUDA port (a
smoke-sized model, a few hundred steps) with checkpoint and auto-resume
and QAT.

The twin of ``examples/train_lm_distributed.py``: runs
``repro_torch.launch.train`` in a process of its own with the
reference's arguments (llama3.2-3b smoke, qat_w4a8, ef8 gradient
compression, a checkpoint every 100 steps) and ``--device`` passed
through; each step replays the launcher's captured step on the card.
``--steps`` shrinks a run; ``--ckpt-dir`` moves the checkpoints from the
launcher's default (``artifacts/ckpt/<name>`` under the working
directory, where a second run resumes).

Run:  PYTHONPATH=src python examples/train_lm_distributed_torch.py
      [--device cpu]
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.device import resolve_device

SRC = Path(__file__).resolve().parents[1] / "src"


def launcher_args(steps: int = 200, ckpt_dir=None):
    """The launcher's argument list, as the reference passes it."""
    return (["--arch", "llama3.2-3b", "--smoke", "--steps", str(steps),
             "--batch", "8", "--seq", "128", "--ckpt-every", "100",
             "--quant", "qat_w4a8", "--grad-compression", "ef8"]
            + (["--ckpt-dir", ckpt_dir] if ckpt_dir else []))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="the current CUDA device by default; cpu runs "
                         "the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + ([path] if path else [])))
    subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                    *launcher_args(args.steps, args.ckpt_dir),
                    "--device", str(dev)], check=True, env=env)


if __name__ == "__main__":
    main()
