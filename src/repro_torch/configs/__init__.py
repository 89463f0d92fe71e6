"""Architecture registry of the port.

Each ``configs/<arch>.py`` defines ``CONFIG`` (the published configuration)
and ``SMOKE`` (a reduced same-family configuration for CPU tests), copied
from the JAX package's registry.  The port carries the architectures it
serves; the others come with the slices that port their families
(ROADMAP.md, queue A).
"""

from __future__ import annotations

import importlib
from typing import List

from ..models.config import ModelConfig

ARCHS: List[str] = ["llama3_2_1b", "granite_moe_3b_a800m", "zamba2_7b"]


def _module(arch: str):
    if arch not in ARCHS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet; the port serves "
            f"{ARCHS} (ROADMAP.md queue A item 10 brings the other "
            f"families)")
    return importlib.import_module(f"{__name__}.{arch}")


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["ARCHS", "get", "get_smoke"]
