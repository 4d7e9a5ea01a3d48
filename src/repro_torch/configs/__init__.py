"""Architecture registry of the port: ``--arch <id>`` ids map to
``LMConfig`` factories, as in ``repro/configs``. The six dense
transformer-pattern archs are registered, in the JAX registry's order;
the MoE, SSM and xLSTM ids raise ``NotImplementedError`` (ROADMAP.md §A
item 2). ``so3krates_paper`` holds the paper's own So3krates config and,
as in the JAX registry, is not an arch."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (chameleon_34b, llama3p2_3b, musicgen_large,
                                 nemotron4_15b, qwen1p5_110b, qwen2_0p5b,
                                 so3krates_paper)
from repro_torch.models.lm.config import SHAPES, LMConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "shapes_for",
           "so3krates_paper"]

_MODULES = {
    "musicgen-large": musicgen_large,
    "qwen1.5-110b": qwen1p5_110b,
    "llama3.2-3b": llama3p2_3b,
    "nemotron-4-15b": nemotron4_15b,
    "qwen2-0.5b": qwen2_0p5b,
    "chameleon-34b": chameleon_34b,
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported (ported: {', '.join(ARCH_IDS)}; "
            "the MoE, SSM and xLSTM archs are ROADMAP.md §A item 2)")
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
