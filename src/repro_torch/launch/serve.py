"""Quantized LM decode serving: counterpart of ``run_lm`` in
``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch qwen2-0.5b --quant serve_w8a8 --kv-quant --tokens 64 \\
        --batch 8 --cache-len 1024                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch qwen2-0.5b --smoke --quant serve_w8a8 --kv-quant \\
        --tokens 8 --batch 2 --cache-len 64 --device cpu

It builds the model from random weights (numpy seed), quantizes them,
allocates the KV cache and runs a greedy decode loop from token 0 at
position 0, then prints the weight bytes (float32 -> served), the
KV-cache bytes and the decode rate, as the JAX launcher does. The
``--smoke`` configs run in float32, the full ones in ``cfg.dtype``
(bf16). The SO3 workload's CLI (``--workload so3``) is not ported yet:
serve molecules through ``repro_torch.serving.QuantizedEngine``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import transformer as tfm
from repro_torch.models.lm.config import LMConfig
from repro_torch.quant.apply import quantize_params_tree, quantized_bytes

__all__ = ["ServedLM", "DecodeRun", "lm_config", "build_lm", "decode",
           "greedy_decode", "run_lm", "main"]


@dataclasses.dataclass
class ServedLM:
    """A model ready to decode: config, served parameters, the output
    projection made once (``transformer.lm_head``) and the byte counts."""
    cfg: LMConfig
    params: tfm.Params
    head: torch.Tensor
    device: torch.device
    fp32_bytes: int
    served_bytes: int


@dataclasses.dataclass
class DecodeRun:
    tokens: torch.Tensor        # (B, n_tokens) generated ids
    seconds: float              # host clock over steps 1..n_tokens-1
    cache_bytes: int
    steps_timed: int


def lm_config(arch: str, *, smoke: bool = False, quant: str = "none",
              kv_quant: bool = False) -> LMConfig:
    """The launcher's config: the arch's full or smoke config in the given
    serving mode; smoke configs run in float32, as in the JAX launcher."""
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    return dataclasses.replace(cfg, quant_mode=quant, kv_quant=kv_quant,
                               dtype=torch.float32 if smoke else cfg.dtype)


def build_lm(cfg: LMConfig, seed: int = 0,
             device: DeviceLike = None) -> ServedLM:
    """Random float weights from ``seed``, quantized for ``cfg.quant_mode``
    (unless it is ``none``)."""
    dev = resolve_device(device)
    params = tfm.init_lm(dataclasses.replace(cfg, quant_mode="none"), seed,
                         dev)
    fp32_bytes = quantized_bytes(params)
    if cfg.quant_mode != "none":
        params = quantize_params_tree(params, cfg)
    return ServedLM(cfg, params, tfm.lm_head(params, cfg), dev, fp32_bytes,
                    quantized_bytes(params))


def decode(lm: ServedLM, cache: tfm.Params, tokens: torch.Tensor,
           cur_index: int) -> torch.Tensor:
    """One decode step of ``lm``: logits (B, V) f32; ``cache`` is
    updated in place."""
    logits, _ = tfm.decode_step(lm.params, lm.cfg, cache, tokens, cur_index,
                                head=lm.head)
    return logits


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def greedy_decode(lm: ServedLM, batch: int, cache_len: int, n_tokens: int,
                  cache: Optional[tfm.Params] = None) -> DecodeRun:
    """Greedy decode of ``n_tokens`` tokens from token 0 at position 0.
    The first step warms up; the host clock runs over the other
    ``n_tokens - 1`` steps and ends in a synchronize."""
    if not 1 <= n_tokens <= cache_len:
        raise ValueError(f"n_tokens={n_tokens} must be in [1, cache_len="
                         f"{cache_len}]")
    if cache is None:
        cache = tfm.init_cache(lm.cfg, batch, cache_len, lm.device)
    cache_bytes = quantized_bytes(cache)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=lm.device)
    out = []
    tok = decode(lm, cache, tok, 0).argmax(-1, keepdim=True)
    out.append(tok)
    _sync(lm.device)
    t0 = time.perf_counter()
    for i in range(1, n_tokens):
        tok = decode(lm, cache, tok, i).argmax(-1, keepdim=True)
        out.append(tok)
    _sync(lm.device)
    return DecodeRun(torch.cat(out, dim=1), time.perf_counter() - t0,
                     cache_bytes, n_tokens - 1)


def run_lm(args) -> DecodeRun:
    cfg = lm_config(args.arch, smoke=args.smoke, quant=args.quant,
                    kv_quant=args.kv_quant)
    lm = build_lm(cfg, seed=args.seed, device=args.device)
    run = greedy_decode(lm, args.batch, args.cache_len, args.tokens)
    print(f"arch={cfg.name} quant={args.quant} kv_quant={args.kv_quant} "
          f"device={lm.device}")
    print(f"weights: fp32 {lm.fp32_bytes / 1e6:.2f} MB -> served "
          f"{lm.served_bytes / 1e6:.2f} MB "
          f"({lm.fp32_bytes / max(lm.served_bytes, 1):.2f}x)")
    print(f"kv-cache: {run.cache_bytes / 1e6:.2f} MB for B={args.batch} "
          f"S={args.cache_len}")
    steps = max(run.steps_timed, 1)
    print(f"decode: {run.steps_timed * args.batch / max(run.seconds, 1e-9):.1f}"
          f" tok/s ({run.seconds / steps * 1e3:.1f} ms/step)")
    return run


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="lm", choices=["lm", "so3"])
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="none",
                    choices=["none", "serve_w8a8", "serve_w4a8"])
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs every kernel's "
                         "plain PyTorch version")
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    if args.workload == "so3":
        ap.error("--workload so3 is not ported to this CLI yet: serve "
                 "molecules through repro_torch.serving.QuantizedEngine")
    if not args.arch:
        ap.error("--workload lm requires --arch")
    run_lm(args)


if __name__ == "__main__":
    main()
