"""Grouped-expert SwiGLU on the card — the wrapper of ``csrc/moe_gemm.cu``.

The CUDA kernel replaces the TPU kernel ``moe_grouped_ffn_pallas``
(``repro/kernels/moe_gemm.py``): rows sorted into ragged per-group
segments, each group's expert SwiGLU ``(silu(x Wg) * (x Wu)) Wd`` in f32,
an optional ``group_experts`` group -> weight-row map.  It is bound by the
bytes of the experts' weights; the source note in the ``.cu`` file states
the design (two launches, h in an f32 scratch, one thread's serial loop
per output element, so a row's bits depend on the row alone).

The entry point checks what the kernel takes and raises on anything else,
never reads the group sizes on the host (they stay on the device, so a
layer does not wait for the card), launches on PyTorch's current stream,
raises if a launch is refused, and adds one to ``LAUNCHES``.  It never
falls back to the plain version: ``kernels.ops`` sends CPU tensors there
and CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from . import _build

# Launches of the entry point — a run reads this to show that its path
# went through the kernel.  ``reset_launches`` zeroes it.
LAUNCHES: Dict[str, int] = {"moe_grouped_ffn": 0}

MAX_GROUPS = 1024                # kMaxGroups in csrc/moe_gemm.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = _build.load("moe_gemm")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.moe_grouped_ffn_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.moe_grouped_ffn_launch.restype = ci
    return lib


def _check(x, w_gate, w_up, w_down, group_sizes, group_experts) -> None:
    tensors = {"x": x, "w_gate": w_gate, "w_up": w_up, "w_down": w_down,
               "group_sizes": group_sizes}
    if group_experts is not None:
        tensors["group_experts"] = group_experts
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(
                f"grouped FFN kernel: {name} is on {t.device}, expected "
                f"every input on {x.device} (a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"grouped FFN kernel: {name} must be "
                             f"contiguous")
    if x.dtype not in _DTYPES:
        raise ValueError(f"grouped FFN kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    for name in ("w_gate", "w_up", "w_down"):
        if tensors[name].dtype != x.dtype:
            raise ValueError(f"grouped FFN kernel: {name} is "
                             f"{tensors[name].dtype}, x is {x.dtype}")
    for name in ("group_sizes", "group_experts"):
        if name in tensors and tensors[name].dtype != torch.int32:
            raise ValueError(f"grouped FFN kernel: {name} must be int32")
    if x.dim() != 2:
        raise ValueError(f"grouped FFN kernel: x shaped {tuple(x.shape)}, "
                         f"expected (T, d)")
    d = x.shape[1]
    if w_gate.dim() != 3 or w_gate.shape[1] != d:
        raise ValueError(f"grouped FFN kernel: w_gate shaped "
                         f"{tuple(w_gate.shape)}, expected (E, {d}, f)")
    E, _, f = w_gate.shape
    if w_up.shape != w_gate.shape or tuple(w_down.shape) != (E, f, d):
        raise ValueError(f"grouped FFN kernel: w_up {tuple(w_up.shape)} / "
                         f"w_down {tuple(w_down.shape)} do not match w_gate "
                         f"{tuple(w_gate.shape)}")
    if group_sizes.dim() != 1 or group_sizes.shape[0] == 0:
        raise ValueError(f"grouped FFN kernel: group_sizes shaped "
                         f"{tuple(group_sizes.shape)}, expected (G,) with "
                         f"G >= 1")
    G = group_sizes.shape[0]
    if group_experts is None and G != E:
        raise ValueError(f"grouped FFN kernel: {G} groups over {E} experts "
                         f"need a group_experts map")
    if group_experts is not None and tuple(group_experts.shape) != (G,):
        raise ValueError(f"grouped FFN kernel: group_experts shaped "
                         f"{tuple(group_experts.shape)}, expected ({G},)")
    if G > MAX_GROUPS:
        raise ValueError(f"grouped FFN kernel takes up to {MAX_GROUPS} "
                         f"groups, got {G}")


def moe_grouped_ffn_cuda(x, w_gate, w_up, w_down, group_sizes,
                         group_experts: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """x: (T, d) rows sorted by group; w_gate/w_up: (E, d, f); w_down:
    (E, f, d); group_sizes: (G,) int32 on the device; group_experts:
    optional (G,) int32 group -> weight-row map (None: G == E).  Returns
    (T, d) in x's dtype, rows past ``sum(group_sizes)`` zero."""
    _check(x, w_gate, w_up, w_down, group_sizes, group_experts)
    T, d = x.shape
    E, _, f = w_gate.shape
    out = torch.empty_like(x)
    if T == 0:
        return out
    h = torch.empty((T, f), dtype=torch.float32, device=x.device)
    err = _lib().moe_grouped_ffn_launch(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        group_sizes.data_ptr(),
        None if group_experts is None else group_experts.data_ptr(),
        h.data_ptr(), out.data_ptr(), T, d, f, E, group_sizes.shape[0],
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped FFN kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["moe_grouped_ffn"] += 1
    return out
