"""Architecture registry of the port: ``--arch <id>`` ids map to
``LMConfig`` factories, as in ``repro/configs``: the JAX registry's ten
archs in its order (dense, MoE, Mamba2-hybrid and xLSTM families), each
module with its published ``config()`` and a reduced ``smoke()`` of the
same family. An unknown id raises ``KeyError``. ``so3krates_paper``
holds the paper's own So3krates config and, as in the JAX registry, is
not an arch."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (chameleon_34b, llama3p2_3b,
                                 moonshot_v1_16b_a3b, musicgen_large,
                                 nemotron4_15b, qwen1p5_110b, qwen2_0p5b,
                                 qwen3_moe_30b_a3b, so3krates_paper,
                                 xlstm_1p3b, zamba2_1p2b)
from repro_torch.models.lm.config import SHAPES, LMConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "shapes_for",
           "so3krates_paper"]

_MODULES = {
    "zamba2-1.2b": zamba2_1p2b,
    "musicgen-large": musicgen_large,
    "xlstm-1.3b": xlstm_1p3b,
    "qwen1.5-110b": qwen1p5_110b,
    "llama3.2-3b": llama3p2_3b,
    "nemotron-4-15b": nemotron4_15b,
    "qwen2-0.5b": qwen2_0p5b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "chameleon-34b": chameleon_34b,
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r} (known: "
                       f"{', '.join(ARCH_IDS)})")
    return _MODULES[arch]


def get_config(arch: str, **overrides) -> LMConfig:
    cfg = _module(arch).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str) -> LMConfig:
    return _module(arch).smoke()


def shapes_for(arch: str) -> tuple:
    """The assigned input shapes for this arch; long_500k only for
    sub-quadratic (SSM/hybrid) families."""
    cfg = _module(arch).config()
    return tuple(s for s in SHAPES
                 if s.shape_name != "long_500k" or cfg.sub_quadratic)
