"""KRN01 clean fixture: every launch tested and raised, every public
wrapper counted (directly or in the helper that launches), and dispatch
by device, not by catching a failed launch."""

import ctypes
import functools

import torch

from . import _build, ref

LAUNCHES = {"scale": 0, "shift": 0}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("scale")
    lib.scale_launch.restype = ctypes.c_int
    return lib


def scale_cuda(x):
    out = torch.empty_like(x)
    err = _lib().scale_launch(x.data_ptr(), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"scale launch failed: CUDA error {err}")
    LAUNCHES["scale"] += 1
    return out


def _launch(x):
    out = torch.empty_like(x)
    if _lib().shift_launch(x.data_ptr(), out.data_ptr()) != 0:
        raise RuntimeError("shift launch failed")
    LAUNCHES["shift"] += 1
    return out


def shift_cuda(x):
    return _launch(x)


def scale(x):
    if x.is_cuda:
        return scale_cuda(shift_cuda(x))
    return ref.scale(x)
