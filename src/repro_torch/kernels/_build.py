"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, compiled on first use for ``sm_90a``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  The build directory,
``kernels/build/``, is listed in ``.gitignore``.  ``build_all`` starts one
``nvcc`` per source, all at once.
Nothing here runs at import time: this module imports on a machine that has
no ``nvcc``, and fails only when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message holds its stderr."""


# One loaded library per source per process, and the build log of each
# (nvcc's stderr, where ``-Xptxas -v`` reports registers and spills).
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def build_dir() -> str:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(path, exist_ok=True)
    return path


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the CUDA "
        "kernels build only on a machine with the CUDA toolkit")


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for ``name`` unless its library is already built."""
    target = _target(name)
    if os.path.exists(target):
        return None
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    target = _target(name)
    if proc is None:
        BUILD_LOGS.setdefault(name, "(reused an earlier build)")
        return
    _, err = proc.communicate()
    tmp = proc.args[proc.args.index("-o") + 1]
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{err}")
    os.replace(tmp, target)              # atomic: concurrent builders agree
    BUILD_LOGS[name] = err


def build_all() -> Dict[str, str]:
    """Build every source in ``csrc/``, one nvcc process each, all started
    together.  Returns the build log per source."""
    names = sources()
    procs = {name: _start(name) for name in names}
    for name in names:
        _finish(name, procs[name])
    return {name: BUILD_LOGS[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(_target(name))
        _LIBS[name] = lib
    return lib
