"""Step functions of the LM (prefill and serve) and the input specs of a
shape cell: counterpart of ``repro/launch/steps.py``.

``make_prefill_step`` and ``make_serve_step`` return plain callables over
the port's ``forward`` and ``decode_step`` (the JAX launcher jits its
own with shardings; the port runs them eagerly on one device).
``input_specs`` gives the same shapes and dtypes as the JAX function's
``ShapeDtypeStruct``s, as tensors on the ``meta`` device.

``make_train_step`` belongs to ROADMAP.md §A item 1b (the LM's training
path), and ``abstract_params``, ``abstract_cache`` and
``abstract_opt_state`` to item 3 (the launcher's dry-run tooling).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models.lm import transformer as tfm
from repro_torch.models.lm.config import LMConfig, ShapeCell

__all__ = ["make_prefill_step", "make_serve_step", "input_specs"]


def make_prefill_step(cfg: LMConfig) -> Callable:
    """(params, batch) -> logits (B, S, V) float32. Inference prefill: the
    full forward over ``batch["tokens"]`` or ``batch["embeds"]``, with no
    cache write-back."""

    def prefill_step(params, batch):
        logits, _ = tfm.forward(params, cfg, tokens=batch.get("tokens"),
                                embeds=batch.get("embeds"))
        return logits

    return prefill_step


def make_serve_step(cfg: LMConfig) -> Callable:
    """(params, cache, tokens, cur_index) -> (logits, cache). One new
    token (or (B, 1, d) embedding) against the KV cache, updated in
    place."""

    def serve_step(params, cache, tokens, cur_index):
        return tfm.decode_step(params, cfg, cache, tokens, cur_index)

    return serve_step


def input_specs(cfg: LMConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Stand-ins (``meta`` tensors) for every model input of this cell."""
    B, S = cell.global_batch, cell.seq_len

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    tok = spec((B, S), torch.int32)
    if cell.kind in ("train", "prefill"):
        x = ({"tokens": tok} if cfg.frontend == "token"
             else {"embeds": spec((B, S, cfg.d_model), cfg.dtype)})
        return dict(x, labels=tok) if cell.kind == "train" else x
    # decode: one new token against a cache of length S
    if cfg.frontend == "token":
        return {"tokens": spec((B, 1), torch.int32)}
    return {"embeds": spec((B, 1, cfg.d_model), cfg.dtype)}
