"""KRN01 fixture: an unchecked launch result, an uncounted wrapper, and a
launch inside a try that falls back silently."""

import ctypes
import functools

import torch

from . import _build, ref

LAUNCHES = {"scale": 0, "shift": 0}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _build.load("scale")


def scale_cuda(x):
    out = torch.empty_like(x)
    _lib().scale_launch(x.data_ptr(), out.data_ptr())
    LAUNCHES["scale"] += 1
    return out


def _launch(x):
    out = torch.empty_like(x)
    err = _lib().shift_launch(x.data_ptr(), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"shift launch failed: CUDA error {err}")
    return out


def shift_cuda(x):
    return _launch(x)


def scale(x):
    try:
        return scale_cuda(x)
    except RuntimeError:
        return ref.scale(x)
