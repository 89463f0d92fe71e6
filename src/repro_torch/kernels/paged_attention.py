"""Paged attention on the card — the wrapper of ``csrc/paged_attention.cu``.

The CUDA kernel replaces the TPU kernels ``paged_attention_pallas`` and
``paged_prefill_pallas`` (``repro/kernels/paged_attention.py``).  One
kernel serves both: decode passes a ``(B, MP)`` table, prefill one ``(MP,)``
table read with row stride 0 and per-row causal lengths, so a prefill row
is bitwise equal to decode on the same table and length.  The source note
in the ``.cu`` file states the design and the bound.

Each entry point checks what the kernel takes and raises on anything else,
launches on PyTorch's current stream, raises if the launch is refused, and
adds one to its count in ``LAUNCHES``.  It never falls back to the plain
version: ``kernels.ops`` sends CPU tensors there and CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from . import _build

# Launches per entry point — a run reads these to show that its path went
# through the kernel.  ``reset_launches`` zeroes them.
LAUNCHES: Dict[str, int] = {"paged_attention": 0, "paged_prefill": 0}

MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024          # H100: shared memory one block may use


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = _build.load("paged_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
        ctypes.c_longlong, ci, ctypes.c_float, ci, vp]
    lib.paged_attention_launch.restype = ci
    lib.paged_attention_smem_bytes.argtypes = [ci, ci, ci, ci]
    lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(q, k_pool, v_pool, page_table, lengths, rows: int) -> None:
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "page_table": page_table, "lengths": lengths}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"paged attention kernel: {name} is on {t.device}, expected "
                f"every input on {q.device} (a CUDA device)")
        if not t.is_contiguous():
            raise ValueError(f"paged attention kernel: {name} must be "
                             f"contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged attention kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"paged attention kernel: q, k_pool and v_pool "
                         f"must share a dtype, got {q.dtype}, "
                         f"{k_pool.dtype}, {v_pool.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged attention kernel: page_table and lengths "
                         "must be int32")
    _, H, dh = q.shape
    N, P, K, dh_k = k_pool.shape
    if v_pool.shape != k_pool.shape or dh_k != dh:
        raise ValueError(f"paged attention kernel: pools shaped "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"paged attention kernel takes head_dim up to "
                         f"{MAX_HEAD_DIM}, got {dh}")
    if K <= 0 or H % K:
        raise ValueError(f"paged attention kernel: {H} query heads do not "
                         f"group over {K} KV heads")
    if lengths.shape != (rows,):
        raise ValueError(f"paged attention kernel: lengths shaped "
                         f"{tuple(lengths.shape)}, expected ({rows},)")


def _launch(q, k_pool, v_pool, page_table, lengths, row_stride: int,
            window: Optional[int]) -> torch.Tensor:
    rows, H, dh = q.shape
    _, P, K, _ = k_pool.shape
    MP = page_table.shape[-1]
    lib = _lib()
    smem = lib.paged_attention_smem_bytes(H, K, dh, P)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged attention kernel: {smem} bytes of shared "
                         f"memory for H={H} K={K} dh={dh} page_size={P} "
                         f"exceed the {_SMEM_LIMIT} a block may use")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    out = torch.empty_like(q)
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        rows, H, K, dh, P, MP, row_stride, window or 0,
        1.0 / math.sqrt(dh), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {err}")
    return out


def paged_attention_cuda(q, k_pool, v_pool, page_table, lengths,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,dh); k_pool/v_pool: (N,P,K,dh); page_table: (B,MP) int32
    (-1 = unused); lengths: (B,) int32.  Returns (B,H,dh)."""
    B = q.shape[0]
    _check(q, k_pool, v_pool, page_table, lengths, B)
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"paged attention kernel: page_table shaped "
                         f"{tuple(page_table.shape)}, expected ({B}, MP)")
    out = _launch(q, k_pool, v_pool, page_table, lengths,
                  page_table.shape[1], window)
    LAUNCHES["paged_attention"] += 1
    return out


def paged_prefill_cuda(q, k_pool, v_pool, page_table, lengths,
                       window: Optional[int] = None) -> torch.Tensor:
    """q: (S,H,dh); page_table: (MP,) int32 shared by every row; lengths:
    (S,) int32 causal lengths (0 = padded row).  Returns (S,H,dh)."""
    S = q.shape[0]
    _check(q, k_pool, v_pool, page_table, lengths, S)
    if page_table.dim() != 1:
        raise ValueError(f"paged prefill kernel: page_table shaped "
                         f"{tuple(page_table.shape)}, expected (MP,)")
    out = _launch(q, k_pool, v_pool, page_table, lengths, 0, window)
    LAUNCHES["paged_prefill"] += 1
    return out
