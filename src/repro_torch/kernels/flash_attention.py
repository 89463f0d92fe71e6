"""Flash attention on the card — the wrapper of ``csrc/flash_attention.cu``.

The CUDA kernels replace the TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py``): blockwise online-softmax attention
with GQA, causal and sliding-window masks and ``q_offset = Sk - Sq``, in
the model's ``(B, S, heads, dh)`` layout, scores in f32, dh 16, 32, 64,
112 (zamba2's shared attention) or 128.  The JAX backward recomputes
through the oracle; here the backward is kernels as well (dK/dV per key
tile, then dQ per query tile, no atomics, bitwise the same from run to
run).  bf16 runs on tensor cores (``mma.sync`` fed by ``ldmatrix`` from a
``cp.async`` ring; its backward first computes D = rowsum(dO * O) once per
row into a scratch); float32 keeps SIMT kernels (scalar f32 FMAs), which
its tolerances need.  ``plan`` picks the route, tiles, warps and shared
memory from the shapes and dtype; the source note in the ``.cu`` file
states the design and the bound.

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
import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

# Launches per entry point: a run reads these to show that its path went
# through the kernels.  A backward is one count for all its launches.
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd": 0}

HEAD_DIMS = (16, 32, 64, 112, 128)  # the instantiations in the .cu file
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 227 * 1024           # H100: shared memory one block may use
MAX_TILES = 65535                 # gridDim.y and .z: batch, tiles
KEY_TILE = 64                     # keys per K/V tile, per dK/dV CTA
STAGES = 2                        # bf16 cp.async ring depth
BWD_WARPS = 4                     # bf16 dK/dV and dQ CTAs
SIMT_ROWS, SIMT_WARPS = 64, 8     # f32: 64-row tiles, 256 threads


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a call runs.  ``route``: "mma" (bf16, tensor cores) or "simt"
    (f32).  ``rows_per_cta`` and ``warps``: the forward's query rows and
    warps per CTA (16 rows a warp on "mma").  ``stages``: the depth of the
    bf16 kernels' cp.async rings.  ``bwd_rows``: query rows per
    step of the dK/dV kernel.  ``dq_rows``: query rows per dQ CTA.  The
    grids are (heads, B, tiles): the forward's and dQ's over query tiles,
    dK/dV's over KV heads and key tiles of ``KEY_TILE``."""

    route: str
    rows_per_cta: int
    warps: int
    stages: int
    bwd_rows: int
    dq_rows: int
    fwd_smem: int
    dkdv_smem: int
    dq_smem: int
    fwd_grid: Tuple[int, int, int]
    dkdv_grid: Tuple[int, int, int]
    dq_grid: Tuple[int, int, int]


def _tiles(n: int, tile: int) -> int:
    return -(-n // tile)


def plan(B: int, Sq: int, Sk: int, H: int, K: int, dh: int,
         dtype: torch.dtype) -> Plan:
    """The launch plan of one call, from the shapes and dtype alone.
    Raises ValueError, naming the shape, on what the kernels do not take,
    shared memory above 227 KB included."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash attention kernel takes float32 or bfloat16, "
                         f"got {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {dh}")
    if K <= 0 or H <= 0 or H % K:
        raise ValueError(f"flash attention kernel: {H} query heads do not "
                         f"group over {K} KV heads")
    if B <= 0 or Sq <= 0 or Sk <= 0:
        raise ValueError(f"flash attention kernel: nothing to attend "
                         f"(B={B}, Sq={Sq}, Sk={Sk})")
    if B > MAX_TILES:
        raise ValueError(f"flash attention kernel: B={B} exceeds "
                         f"{MAX_TILES}")
    if dtype == torch.float32:
        route, rows, warps, stages = "simt", SIMT_ROWS, SIMT_WARPS, 1
        bwd_rows = dq_rows = SIMT_ROWS
        fwd = 4 * (3 * 64 * (dh + 1) + 64 * 65)
        dkdv = 4 * (4 * 64 * (dh + 1) + 2 * 64 * 65 + 2 * 64)
        dq = 4 * (4 * 64 * (dh + 1) + 64 * 65 + 2 * 64)
    else:
        route, stages = "mma", STAGES
        warps = 8 if dh <= 64 else 4
        rows = 16 * warps
        bwd_rows = 64 if dh <= 64 else 32
        dq_rows = 16 * BWD_WARPS
        lds = 2 * (dh + 8)                     # bytes of a padded bf16 row
        fwd = lds * (rows + 2 * stages * KEY_TILE)
        dkdv = lds * (2 * KEY_TILE + 2 * stages * bwd_rows) \
            + 4 * 2 * stages * bwd_rows
        dq = lds * (2 * dq_rows + 2 * stages * KEY_TILE)
    for name, n, tile in (("Sq", Sq, rows), ("Sq", Sq, dq_rows),
                          ("Sk", Sk, KEY_TILE)):
        if _tiles(n, tile) > MAX_TILES:
            raise ValueError(f"flash attention kernel: {name}={n} needs more "
                             f"than {MAX_TILES} tiles of {tile}")
    for smem in (fwd, dkdv, dq):
        if smem > SMEM_LIMIT:
            raise ValueError(f"flash attention kernel: {smem} bytes of shared "
                             f"memory for dh={dh} ({dtype}) exceed the "
                             f"{SMEM_LIMIT} a block may use")
    return Plan(route=route, rows_per_cta=rows, warps=warps, stages=stages,
                bwd_rows=bwd_rows, dq_rows=dq_rows, fwd_smem=fwd,
                dkdv_smem=dkdv, dq_smem=dq,
                fwd_grid=(H, B, _tiles(Sq, rows)),
                dkdv_grid=(K, B, _tiles(Sk, KEY_TILE)),
                dq_grid=(H, B, _tiles(Sq, dq_rows)))


class _Args(ctypes.Structure):
    """``FlashArgs`` of the ``.cu`` file: one call's shapes and plan."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "B", "Sq", "Sk", "H", "K", "dh", "causal", "window", "dtype",
        "rows_per_cta", "warps", "fwd_smem", "dkdv_smem", "dq_smem")] + [
        ("scale", ctypes.c_double)]


@functools.lru_cache(maxsize=None)
def _args(B: int, Sq: int, Sk: int, H: int, K: int, dh: int, causal: bool,
          window: int, dtype: torch.dtype) -> _Args:
    """The launch's argument block, built once per shape."""
    p = plan(B, Sq, Sk, H, K, dh, dtype)
    return _Args(B, Sq, Sk, H, K, dh, int(causal), window, _DTYPES[dtype],
                 p.rows_per_cta, p.warps, p.fwd_smem, p.dkdv_smem, p.dq_smem,
                 1.0 / math.sqrt(dh))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = _build.load("flash_attention")
    vp, ap = ctypes.c_void_p, ctypes.POINTER(_Args)
    lib.flash_attention_fwd_launch.argtypes = [vp, vp, vp, vp, vp, ap, vp]
    lib.flash_attention_fwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ap, vp]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    return lib


def _check(q, k, v, causal: bool, window: Optional[int],
           **more) -> _Args:
    """Raises on what the kernels do not take; returns the launch's
    argument block."""
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
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel (bf16): {name} must "
                             f"start on a 16-byte boundary")
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
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    return _args(B, Sq, Sk, H, K, dh, bool(causal), window or 0, q.dtype)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd_cuda(q, k, v, causal: bool = True,
                             window: Optional[int] = None):
    """q: (B,Sq,H,dh); k/v: (B,Sk,K,dh).  Returns (out (B,Sq,H,dh) in q's
    dtype, lse (B,H,Sq) f32)."""
    args = _check(q, k, v, causal, window)
    B, Sq, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = _lib().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), args, _stream(q))
    if err != 0:
        raise RuntimeError(f"flash attention forward launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal: bool = True,
                             window: Optional[int] = None):
    """The gradients (dq, dk, dv) of ``flash_attention_fwd_cuda``'s output
    against ``dout`` (like q), from its saved ``out`` and ``lse``."""
    args = _check(q, k, v, causal, window, out=out, lse=lse, dout=dout)
    B, Sq, H, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (B, H, Sq):
        raise ValueError(f"flash attention backward: out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # bf16: D = rowsum(dO * O) per row, written by the first launch.
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if q.dtype == torch.bfloat16 else None
    err = _lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        None if dsum is None else dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), args, _stream(q))
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
