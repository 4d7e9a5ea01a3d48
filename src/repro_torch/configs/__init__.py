"""Architecture registry of the port: ``--arch <id>`` ids map to
``LMConfig`` factories, as in ``repro/configs``. Only the dense SwiGLU
transformers whose decode the port serves are registered; every other id
of the JAX package raises ``NotImplementedError``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import llama3p2_3b, qwen2_0p5b
from repro_torch.models.lm.config import LMConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]

_MODULES = {
    "llama3.2-3b": llama3p2_3b,
    "qwen2-0.5b": qwen2_0p5b,
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported (ported: {', '.join(ARCH_IDS)}; "
            "the rest of repro/configs is listed in ROADMAP.md §A)")
    return _MODULES[arch]


def get_config(arch: str, **overrides) -> LMConfig:
    cfg = _module(arch).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str) -> LMConfig:
    return _module(arch).smoke()
