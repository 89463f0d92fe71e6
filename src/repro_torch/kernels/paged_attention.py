"""Paged attention on the card — the wrapper of ``csrc/paged_attention.cu``.

The CUDA kernel replaces the TPU kernels ``paged_attention_pallas`` and
``paged_prefill_pallas`` (``repro/kernels/paged_attention.py``).  One
kernel serves both: decode passes a ``(B, MP)`` table, prefill one ``(MP,)``
table read with row stride 0 and per-row causal lengths.

Its contract: a row's output depends only on its query vector, its table
row, its length, the window and the dtype — not on B or S, on MP, on the
row's place in a tile or on any other row — so a prefill row is bitwise
equal to decode on the same query, table and length.  bf16 runs on tensor
cores (``mma.sync`` m16n8k16 fed by ``ldmatrix``) over 64-key blocks at
absolute positions, brought in by a ``cp.async`` ring: a prefill CTA holds
64 query rows (64 // G tokens x G heads) of one KV head that share each
block, a decode CTA the G heads of one (b, kh).  float32 keeps a SIMT path
(one block per row and KV head, a page at a time).  Neither splits a row's
keys.  ``plan`` chooses the route, the tile, the key block and the shared
memory from the heads, head dim, page size and dtype — it is not given the
number of rows or MP; the source note in the ``.cu`` file states the
design and the bound.

Each entry point checks what the kernel takes and raises on anything else,
launches on PyTorch's current stream, raises if the launch is refused, and
adds one to its count in ``LAUNCHES``.  It never falls back to the plain
version: ``kernels.ops`` sends CPU tensors there and CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
SMEM_LIMIT = 227 * 1024           # H100: shared memory one block may use
BLOCK_KEYS = 64                   # bf16 key block: [j * 64, (j + 1) * 64)
STAGES = 3                        # bf16 cp.async ring depth
PREFILL_ROWS = 64                 # bf16 prefill query rows per CTA
MIN_WARPS = 4                     # bf16: warps that share a CTA's loads
MAX_WARPS = 8
SIMT_THREADS = 128


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a call runs (the grid is ceil(rows / tokens_per_cta) x K).
    ``route``: "mma" (bf16, tensor cores) or "simt" (f32).  ``block_keys``:
    the keys one softmax update covers (a page on the SIMT route); no route
    splits a row's keys.  ``tokens_per_cta``: tokens whose rows share a CTA
    (1 in decode, whose rows have tables of their own).  ``warps``: at
    least 4, so that a decode CTA of G <= 16 rows still has 128 threads to
    issue its loads (warps with no live row only load)."""

    route: str
    block_keys: int
    tokens_per_cta: int
    warps: int
    smem_bytes: int


def plan(H: int, K: int, dh: int, P: int, dtype: torch.dtype,
         prefill: bool) -> Plan:
    """The launch plan for H query heads over K KV heads, head dim dh and
    pages of P tokens.  Raises on shapes the kernel does not take, shared
    memory above 227 KB included."""
    if dtype not in _DTYPES:
        raise ValueError(f"paged attention kernel takes float32 or bfloat16, "
                         f"got {dtype}")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"paged attention kernel takes head_dim up to "
                         f"{MAX_HEAD_DIM}, got {dh}")
    if K <= 0 or H % K:
        raise ValueError(f"paged attention kernel: {H} query heads do not "
                         f"group over {K} KV heads")
    if P <= 0:
        raise ValueError(f"paged attention kernel: page_size {P} must be "
                         f"positive")
    G = H // K
    if dtype == torch.float32:
        smem = 4 * (2 * G * dh + P * (dh + 1) + P * dh + G * P + 3 * G)
        route, bk, tpc, warps = "simt", P, 1, SIMT_THREADS // 32
    else:
        if dh % 16:
            raise ValueError(f"paged attention kernel (bf16) takes head_dim "
                             f"a multiple of 16, got {dh}")
        if BLOCK_KEYS % P:
            raise ValueError(f"paged attention kernel (bf16) takes a "
                             f"page_size that divides {BLOCK_KEYS}, got {P}")
        tpc = max(1, PREFILL_ROWS // G) if prefill else 1
        warps = max(MIN_WARPS, -(-tpc * G // 16))
        if warps > MAX_WARPS:
            raise ValueError(f"paged attention kernel (bf16) takes up to "
                             f"{MAX_WARPS * 16} query heads per KV head, got "
                             f"{G}")
        lds = dh + 8
        smem = (2 * (2 * STAGES * BLOCK_KEYS * lds + warps * 16 * lds)
                + 4 * (STAGES + 1) * (BLOCK_KEYS // P))
        route, bk = "mma", BLOCK_KEYS
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged attention kernel: {smem} bytes of shared "
                         f"memory for H={H} K={K} dh={dh} page_size={P} "
                         f"({dtype}) exceed the {SMEM_LIMIT} a block may use")
    return Plan(route=route, block_keys=bk, tokens_per_cta=tpc, warps=warps,
                smem_bytes=smem)


class _Args(ctypes.Structure):
    """``PagedArgs`` of the ``.cu`` file: one call's shapes and plan."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "rows", "H", "K", "dh", "P", "MP", "table_row_stride", "window",
        "dtype", "tokens_per_cta", "warps", "smem_bytes")] + [
        ("scale", ctypes.c_double)]


@functools.lru_cache(maxsize=None)
def _args(rows: int, H: int, K: int, dh: int, P: int, MP: int,
          row_stride: int, window: int, dtype: torch.dtype,
          prefill: bool) -> _Args:
    """The launch's argument block, built once per shape (the launch
    passes its address: fewer arguments for ctypes to convert per call)."""
    p = plan(H, K, dh, P, dtype, prefill)
    return _Args(rows, H, K, dh, P, MP, row_stride, window, _DTYPES[dtype],
                 p.tokens_per_cta, p.warps, p.smem_bytes,
                 1.0 / math.sqrt(dh))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared."""
    lib = _build.load("paged_attention")
    vp = ctypes.c_void_p
    lib.paged_attention_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, ctypes.POINTER(_Args), vp]
    lib.paged_attention_launch.restype = ctypes.c_int
    return lib


def _check(q, k_pool, v_pool, page_table, lengths, rows: int) -> None:
    dev = q.get_device()
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_cuda or t.get_device() != dev:
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
    if lengths.shape != (rows,):
        raise ValueError(f"paged attention kernel: lengths shaped "
                         f"{tuple(lengths.shape)}, expected ({rows},)")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged attention kernel (bf16): q and the pools "
                         "must start on a 16-byte boundary")


def _launch(q, k_pool, v_pool, page_table, lengths, row_stride: int,
            window: Optional[int], prefill: bool) -> torch.Tensor:
    rows, H, dh = q.shape
    _, P, K, _ = k_pool.shape
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    args = _args(rows, H, K, dh, P, page_table.shape[-1], row_stride,
                 window or 0, q.dtype, prefill)
    out = torch.empty_like(q)
    err = _lib().paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), args,
        torch.cuda.current_stream(q.get_device()).cuda_stream)
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
                  page_table.shape[1], window, prefill=False)
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
    out = _launch(q, k_pool, v_pool, page_table, lengths, 0, window,
                  prefill=True)
    LAUNCHES["paged_prefill"] += 1
    return out
