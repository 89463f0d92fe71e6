"""Architecture registry of the port.

Each ``configs/<arch>.py`` defines ``CONFIG`` (the published configuration)
and ``SMOKE`` (a reduced same-family configuration for CPU tests), copied
from the JAX package's registry: all ten of its architectures.
"""

from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig

ARCHS: List[str] = ["llama3_2_1b", "granite_moe_3b_a800m", "zamba2_7b",
                    "granite_8b", "minitron_4b", "stablelm_3b",
                    "mixtral_8x7b", "xlstm_350m", "seamless_m4t_medium",
                    "phi3_vision_4_2b"]


def _module(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r}; expected one of "
                         f"{ARCHS}")
    return importlib.import_module(f"{__name__}.{arch}")


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["ARCHS", "get", "get_smoke"]
