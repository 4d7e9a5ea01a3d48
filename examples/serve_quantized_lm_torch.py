"""Quantized serving for both workloads via ``repro_torch.launch.serve``.

The twin of ``examples/serve_quantized_lm.py`` on the PyTorch/CUDA port:
1. LM decode (memory-wall fix): fp32 vs W8A8 vs W4A8 (+ int8 KV cache,
   written and read by the KV-write and decode-attention kernels on the
   card), memory footprint and tokens/s on the qwen2-0.5b smoke config.
2. SO(3) force-field inference: the same quantized-kernel path behind
   ``repro_torch.serving.QuantizedEngine``: batched, bucketed,
   variable-size molecules (see examples/md_stability_torch.py for the
   trained-model variant).
Each runs the launcher in a process of its own, with ``--device`` passed
through.

Run:  PYTHONPATH=src python examples/serve_quantized_lm_torch.py
      [--device cpu]
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.device import resolve_device

SRC = Path(__file__).resolve().parents[1] / "src"
LM_RUNS = (("none", False), ("serve_w8a8", True), ("serve_w4a8", True))


def runs():
    """(title, the launcher's argument list) of each run, as the
    reference passes them."""
    out = [(f"lm quant={quant} kv_quant={kv}",
            ["--workload", "lm", "--arch", "qwen2-0.5b", "--smoke", "--quant",
             quant, "--tokens", "16", "--batch", "2", "--cache-len", "64"]
            + (["--kv-quant"] if kv else []))
           for quant, kv in LM_RUNS]
    out.append(("so3 batched quantized engine (w8a8)",
                ["--workload", "so3", "--mode", "w8a8", "--graphs", "8",
                 "--min-atoms", "6", "--max-atoms", "24", "--buckets", "16",
                 "32", "--lee"]))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the current CUDA device by default; cpu runs "
                         "every kernel's plain PyTorch version")
    dev = resolve_device(ap.parse_args(argv).device)
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + ([path] if path else [])))
    for title, args in runs():
        print(f"\n== {title} ==", flush=True)
        subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *args, "--device", str(dev)], check=True, env=env)


if __name__ == "__main__":
    main()
