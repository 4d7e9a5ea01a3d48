"""The LM prefill's two comparisons on the CPU, at qwen2-0.5b's width.

    PYTHONPATH=src python -m repro_torch.tools.lm_prefill_gap 1 2 4 8 12

For each depth given (layers of qwen2-0.5b's published config, every
width kept; serve_w8a8 weights from numpy seed 0, bf16 activations),
prefills B=2 x S=160 random tokens (numpy seed 0) through the port's
``forward`` and prints, over the largest |logit|:

- chunk invariance: the logits with ``attn_chunk_q`` = S (one query
  block) against S / 8;
- the gap of the int8-KV decode (the kernels' plain versions on the CPU,
  teacher-forced over all S positions) to the bf16 prefill, and the
  share of equal argmaxes.

``chip_smoke.py`` phase 10 makes the same comparisons on the card at 24
layers, B=8, S=1,024; its bounds are derived from these numbers. A few
seconds and ~2 GB per depth (the 151,936 x 896 embedding dominates).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models.lm import transformer as tfm


def gaps(n_layers: int, batch: int = 2, seq: int = 160):
    cfg = dataclasses.replace(configs.get_config("qwen2-0.5b"),
                              n_layers=n_layers, quant_mode="serve_w8a8",
                              kv_quant=True, attn_chunk_q=seq)
    lm = serve.build_lm(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, seq)))
    full, _ = tfm.forward(lm.params, cfg, tokens=toks)
    chunked, _ = tfm.forward(lm.params, dataclasses.replace(
        cfg, attn_chunk_q=seq // 8), tokens=toks)
    cache = tfm.init_cache(cfg, batch, seq, "cpu")
    dec = torch.stack([serve.decode(lm, cache, toks[:, i:i + 1], i)
                       for i in range(seq)], dim=1)
    scale = full.abs().max()
    return (float((chunked - full).abs().max() / scale),
            float((dec - full).abs().max() / scale),
            float((dec.argmax(-1) == full.argmax(-1)).float().mean()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("layers", type=int, nargs="+")
    args = ap.parse_args(argv)
    for n in args.layers:
        t0 = time.perf_counter()
        chunk, kv, same = gaps(n)
        print(f"qwen2-0.5b width, {n} layers, B=2 S=160 bf16 (CPU): chunk "
              f"160 vs 20 {chunk}; int8-KV decode vs prefill {kv}, argmax "
              f"equal {same:.4f} ({time.perf_counter() - t0:.1f} s)",
              flush=True)


if __name__ == "__main__":
    main()
