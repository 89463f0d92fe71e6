"""Architecture registry of the port.

Each ``configs/<arch>.py`` defines ``CONFIG`` (the published configuration)
and ``SMOKE`` (a reduced same-family configuration for CPU tests), copied
from the JAX package's registry: all ten of its architectures.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import SHAPES, SMOKE_SHAPES, ModelConfig, ShapeConfig

# In the JAX registry's order (``repro/configs/base.py``).
ARCHS: List[str] = ["seamless_m4t_medium", "zamba2_7b", "minitron_4b",
                    "granite_8b", "stablelm_3b", "llama3_2_1b",
                    "mixtral_8x7b", "granite_moe_3b_a800m",
                    "phi3_vision_4_2b", "xlstm_350m"]

# Archs whose long_500k cell runs (sub-quadratic decode state).
LONG_CONTEXT_OK = {"zamba2_7b", "mixtral_8x7b", "xlstm_350m"}


def _module(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r}; expected one of "
                         f"{ARCHS}")
    return importlib.import_module(f"{__name__}.{arch}")


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def shapes_for(arch: str, smoke: bool = False) -> Dict[str, ShapeConfig]:
    """The (shape -> ShapeConfig) cells this arch runs, with the documented
    skips applied."""
    table = SMOKE_SHAPES if smoke else SHAPES
    return {name: sc for name, sc in table.items()
            if name != "long_500k" or arch in LONG_CONTEXT_OK}


__all__ = ["ARCHS", "LONG_CONTEXT_OK", "get", "get_smoke", "shapes_for"]
