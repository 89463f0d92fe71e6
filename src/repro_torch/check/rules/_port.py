"""The scope of the rules restated for the port (DET01, DET02, KRN01,
SPMD01): Python files with a ``repro_torch`` directory in their path, and
every CUDA source."""

from __future__ import annotations

import os

from ..registry import CUDA_SUFFIX


def in_port(path: str) -> bool:
    if path.endswith(CUDA_SUFFIX):
        return True
    return "repro_torch" in os.path.normpath(path).split(os.sep)[:-1]
