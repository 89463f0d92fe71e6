"""The SSD (Mamba2) intra-chunk block on the card — the wrapper of
``csrc/ssd_scan.cu``.

The CUDA kernel replaces the TPU kernel ``ssd_scan_pallas``
(``repro/kernels/ssd_scan.py``): for each chunk row and head,
``y[i,h,p] = sum_{j<=i} (C_i . B_j) exp(acum[i,h] - acum[j,h]) dt[j,h]
x[j,h,p]`` with ``a = dt * A`` and no initial state, in f32.  The source
note in the ``.cu`` file states the design and the bound.

``ssd_scan_cuda`` checks what the kernel takes and raises on anything else,
launches on PyTorch's current stream, raises if the launch is refused, and
adds one to ``LAUNCHES["ssd_scan"]``.  It never falls back to the plain
version: ``kernels.ops`` sends CPU tensors to ``ref.ssd_reference`` and CUDA
tensors here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from . import _build

# Launches per entry point: a run reads these to show that its path went
# through the kernel.
LAUNCHES: Dict[str, int] = {"ssd_scan": 0}

HEAD_DIMS = (32, 64)               # P: the instantiations in the .cu file
MAX_CHUNK = 256                    # Q
MAX_STATE = 128                    # N
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared."""
    lib = _build.load("ssd_scan")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                    ci, ci, vp]
    lib.ssd_scan_launch.restype = ci
    return lib


def _check(x, dt, A, Bm, Cm) -> None:
    tensors = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(
                f"SSD kernel: {name} is on {t.device}, expected every input "
                f"on {x.device} (a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"SSD kernel: {name} must be contiguous")
        want = torch.float32 if name in ("dt", "A") else x.dtype
        if t.dtype != want:
            raise ValueError(f"SSD kernel: {name} is {t.dtype}, expected "
                             f"{want}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"SSD kernel takes x, Bm and Cm in float32 or "
                         f"bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"SSD kernel: x is {tuple(x.shape)}, expected "
                         f"(Bc, Q, H, P)")
    Bc, Q, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if dt.shape != (Bc, Q, H) or A.shape != (H,) or \
            Bm.shape != (Bc, Q, N) or Cm.shape != Bm.shape:
        raise ValueError(
            f"SSD kernel: dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
            f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not match x "
            f"{tuple(x.shape)}: expected (Bc, Q, H), (H,), (Bc, Q, N) twice")
    if P not in HEAD_DIMS:
        raise ValueError(f"SSD kernel takes head_dim P in {HEAD_DIMS}, got "
                         f"{P}")
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"SSD kernel takes a chunk of 1 to {MAX_CHUNK} "
                         f"positions, got {Q}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"SSD kernel takes a state of 1 to {MAX_STATE}, got "
                         f"{N}")
    if Bc == 0 or H == 0:
        raise ValueError(f"SSD kernel: nothing to compute (Bc={Bc}, H={H})")


def ssd_scan_cuda(x, dt, A, Bm, Cm) -> torch.Tensor:
    """One-chunk SSD per row.  x: (Bc,Q,H,P); dt: (Bc,Q,H) f32; A: (H,)
    f32; Bm/Cm: (Bc,Q,N) in x's dtype.  Returns y (Bc,Q,H,P) f32."""
    _check(x, dt, A, Bm, Cm)
    Bc, Q, H, P = x.shape
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    err = _lib().ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), Bc, Q, H, P, Bm.shape[-1],
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"SSD kernel launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan"] += 1
    return y
