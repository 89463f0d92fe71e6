"""Flash attention on the card — the wrapper of ``csrc/flash_attention.cu``.

The CUDA kernels replace the TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py``): blockwise online-softmax attention
with GQA, causal and sliding-window masks and ``q_offset = Sk - Sq``, in
the model's ``(B, S, heads, dh)`` layout, scores in f32.  The JAX backward
recomputes through the oracle; here the backward is two kernels as well
(dK/dV per key tile, then dQ per query tile, no atomics, bitwise the same
from run to run).  The source note in the ``.cu`` file states the design
and the bound.

``flash_attention_fwd_cuda`` returns the output and the per-row f32
log-sum-exp ``(B, H, Sq)``; ``flash_attention_bwd_cuda`` takes them back
with the output's gradient.  ``flash_attention_cuda`` is the
``torch.autograd.Function`` over the two.  Each entry point checks what the
kernel takes and raises on anything else, launches on PyTorch's current
stream, raises if a launch is refused, and adds one to its count in
``LAUNCHES``.  It never falls back to the plain version: ``kernels.ops``
sends CPU tensors to ``ref.mha_reference`` and CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from . import _build

# Launches per entry point: a run reads these to show that its path went
# through the kernels.  A backward is one count for its two launches.
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd": 0}

HEAD_DIMS = (16, 32, 64, 128)      # the instantiations in the .cu file
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = _build.load("flash_attention")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd_launch.argtypes = [
        vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cf, ci, vp]
    lib.flash_attention_fwd_launch.restype = ci
    lib.flash_attention_bwd_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
        cf, ci, vp]
    lib.flash_attention_bwd_launch.restype = ci
    return lib


def _check(q, k, v, window: Optional[int], **more) -> None:
    tensors = {"q": q, "k": k, "v": v, **more}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"flash attention kernel: {name} is on {t.device}, expected "
                f"every input on {q.device} (a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"flash attention kernel: {name} must be "
                             f"contiguous")
        want = torch.float32 if name == "lse" else q.dtype
        if t.dtype != want:
            raise ValueError(f"flash attention kernel: {name} is {t.dtype}, "
                             f"expected {want}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         f"(B, Sq, H, dh) and (B, Sk, K, dh)")
    B, Sq, H, dh = q.shape
    Bk, Sk, K, dhk = k.shape
    if Bk != B or dhk != dh:
        raise ValueError(f"flash attention kernel: k {tuple(k.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {dh}")
    if K <= 0 or H % K:
        raise ValueError(f"flash attention kernel: {H} query heads do not "
                         f"group over {K} KV heads")
    if B == 0 or Sq == 0 or Sk == 0:
        raise ValueError(f"flash attention kernel: nothing to attend "
                         f"(B={B}, Sq={Sq}, Sk={Sk})")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd_cuda(q, k, v, causal: bool = True,
                             window: Optional[int] = None):
    """q: (B,Sq,H,dh); k/v: (B,Sk,K,dh).  Returns (out (B,Sq,H,dh) in q's
    dtype, lse (B,H,Sq) f32)."""
    _check(q, k, v, window)
    B, Sq, H, dh = q.shape
    _, Sk, K, _ = k.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = _lib().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, H, K, dh, int(causal), window or 0,
        1.0 / math.sqrt(dh), _DTYPES[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash attention forward launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal: bool = True,
                             window: Optional[int] = None):
    """The gradients (dq, dk, dv) of ``flash_attention_fwd_cuda``'s output
    against ``dout`` (like q), from its saved ``out`` and ``lse``."""
    _check(q, k, v, window, out=out, lse=lse, dout=dout)
    B, Sq, H, dh = q.shape
    _, Sk, K, _ = k.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (B, H, Sq):
        raise ValueError(f"flash attention backward: out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, Sq, Sk, H, K, dh, int(causal), window or 0,
        1.0 / math.sqrt(dh), _DTYPES[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Forward and backward both launch the CUDA kernels; the forward
    saves q, k, v, its output and the log-sum-exp for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        out, lse = flash_attention_fwd_cuda(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention_cuda(q, k, v, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Differentiable attention on the card.  q: (B,Sq,H,dh); k/v:
    (B,Sk,K,dh).  Returns (B,Sq,H,dh)."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, window)
