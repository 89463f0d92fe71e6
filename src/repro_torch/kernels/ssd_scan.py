"""The SSD (Mamba2) intra-chunk block on the card — the wrapper of
``csrc/ssd_scan.cu``.

The CUDA kernel replaces the TPU kernel ``ssd_scan_pallas``
(``repro/kernels/ssd_scan.py``): for each chunk row and head,
``y[i,h,p] = sum_{j<=i} (C_i . B_j) exp(acum[i,h] - acum[j,h]) dt[j,h]
x[j,h,p]`` with ``a = dt * A`` and no initial state, in f32.  bf16 runs on
tensor cores (``mma.sync``; one block per chunk and head group over all Q
rows, x read once through a ``cp.async`` ring, the weights fed as a bf16
hi/lo pair); float32 keeps the SIMT kernel, which its checks need.
``plan`` picks the route, head group, warps, grid and shared memory; the
source note in the ``.cu`` file states the design and the bound.

``ssd_scan_cuda`` checks what the kernel takes and raises on anything else,
launches on PyTorch's current stream, raises if the launch is refused, and
adds one to ``LAUNCHES["ssd_scan"]``.  It never falls back to the plain
version: ``kernels.ops`` sends CPU tensors to ``ref.ssd_reference`` and CUDA
tensors here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from . import _build

# Launches per entry point: a run reads these to show that its path went
# through the kernel.
LAUNCHES: Dict[str, int] = {"ssd_scan": 0}

HEAD_DIMS = (32, 64)               # P: the instantiations in the .cu file
MAX_CHUNK = 256                    # Q
MAX_STATE = 128                    # N
SMEM_LIMIT = 227 * 1024            # H100: shared memory one block may use
MAX_BLOCKS = 2**31 - 1             # gridDim.x
MAX_CHUNKS_SIMT = 65535            # gridDim.z of the SIMT kernel: Bc
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 (tensor cores): 16-row strips of i, one warp each; keys in blocks of
# 64; the mma k step of 16 (N padded to it); a 3-stage x ring; bf16 rows
# padded by 8 elements.  A block runs the heads of its group one after
# another.
STRIP, KEY_BLOCK, K_STEP, STAGES, PAD = 16, 64, 16, 3, 8
# What decides how many blocks an H100 runs at once: its streaming
# multiprocessors, and per SM 2048 threads, 65536 registers (the bf16
# kernel takes at most 128 a thread: launch bounds of 512 threads) and
# 228 KB of shared memory, 1 KB of it reserved per block.
SMS, SM_THREADS, SM_REGS, MMA_REGS = 132, 2048, 65536, 128
SM_SMEM, BLOCK_SMEM_RESERVED = 228 * 1024, 1024
# float32 (SIMT): 64-row tiles of i and 64-key steps, 256 threads, up to 4
# heads a block.
SIMT_ROWS, SIMT_WARPS, SIMT_HEAD_GROUPS = 64, 8, (4, 2, 1)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a call runs.  ``route``: "mma" (bf16, tensor cores) or "simt"
    (f32).  ``head_group``: heads a block (a divisor of H; on "mma" they
    run one after another, and the group is chosen to fill whole waves of
    the card; the output's bits do not depend on it).  ``warps``: a
    block's warps (on "mma" one per 16-row strip, so ``ceil(Q / 16)``).
    ``key_block``: keys j a step.
    ``k_step``: the reduction step of the products (16 on "mma", where N is
    padded to it; 1 on "simt").  ``stages``: the depth of the x ring.
    ``smem``: dynamic shared memory.  ``grid``: (x, y, z); on "mma" one
    dimension, chunk-major, the head groups of a chunk adjacent; on "simt"
    (row tiles, head groups, chunks)."""

    route: str
    head_group: int
    warps: int
    key_block: int
    k_step: int
    stages: int
    smem: int
    grid: Tuple[int, int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(Bc: int, Q: int, H: int, P: int, N: int, dtype: torch.dtype) -> Plan:
    """The launch plan of one call, from the shapes and dtype alone.
    Raises ValueError, naming the shape, on what the kernel does not
    take."""
    if dtype not in _DTYPES:
        raise ValueError(f"SSD kernel takes x, Bm and Cm in float32 or "
                         f"bfloat16, got {dtype}")
    if P not in HEAD_DIMS:
        raise ValueError(f"SSD kernel takes head_dim P in {HEAD_DIMS}, got "
                         f"{P}")
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"SSD kernel takes a chunk of 1 to {MAX_CHUNK} "
                         f"positions, got {Q}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"SSD kernel takes a state of 1 to {MAX_STATE}, got "
                         f"{N}")
    if Bc < 1 or H < 1:
        raise ValueError(f"SSD kernel: nothing to compute (Bc={Bc}, H={H})")
    if dtype == torch.float32:
        hg = next(g for g in SIMT_HEAD_GROUPS if H % g == 0)
        if Bc > MAX_CHUNKS_SIMT:
            raise ValueError(f"SSD kernel (float32): Bc={Bc} chunks exceed "
                             f"{MAX_CHUNKS_SIMT}")
        smem = 4 * (2 * SIMT_ROWS * (N + 1) + SIMT_ROWS * (P + 1)
                    + SIMT_ROWS * (SIMT_ROWS + 1) + 2 * hg * Q)
        return Plan("simt", hg, SIMT_WARPS, SIMT_ROWS, 1, 1, smem,
                    (-(-Q // SIMT_ROWS), H // hg, Bc))
    warps = -(-Q // STRIP)
    hg = _head_group(Bc, Q, H, P, N, warps)
    if Bc * (H // hg) > MAX_BLOCKS:
        raise ValueError(f"SSD kernel: Bc={Bc} chunks of {H} heads need more "
                         f"than {MAX_BLOCKS} blocks")
    return Plan("mma", hg, warps, KEY_BLOCK, K_STEP, STAGES,
                _mma_smem(Q, N, P, hg), (Bc * (H // hg), 1, 1))


def _mma_smem(Q: int, N: int, P: int, G: int) -> int:
    """Shared memory of the bf16 kernel: dt and its cumsum for G heads
    (f32), the chunk's B and C rows (bf16, N padded to 16 and 8 more), and
    the x ring (bf16 (KEY_BLOCK, P + 8) tiles); Q rounded up to a key
    block."""
    qb = _up(Q, KEY_BLOCK)
    return (2 * G * qb * 4 + 2 * qb * (_up(N, K_STEP) + PAD) * 2
            + STAGES * KEY_BLOCK * (P + PAD) * 2)


def _head_group(Bc: int, Q: int, H: int, P: int, N: int, warps: int) -> int:
    """Heads a block runs, one after another: the divisor G of H that
    makes the fewest rounds of work per block slot, ceil(blocks / slots) x
    G, the largest such G on a tie (each block loads its chunk's B and C
    once).  A round that leaves most slots empty costs as much as a full
    one, so blocks should fill whole waves of the card."""
    threads = 32 * warps
    best = None
    for G in range(1, H + 1):
        smem = _mma_smem(Q, N, P, G)
        if H % G or smem > SMEM_LIMIT:
            continue
        per_sm = min(SM_THREADS // threads, SM_REGS // (MMA_REGS * threads),
                     SM_SMEM // (smem + BLOCK_SMEM_RESERVED))
        cost = -(-Bc * (H // G) // (SMS * per_sm)) * G
        if best is None or cost <= best[0]:
            best = (cost, G)
    if best is None:
        raise ValueError(f"SSD kernel: {_mma_smem(Q, N, P, 1)} bytes of "
                         f"shared memory exceed the {SMEM_LIMIT} a block "
                         f"may use")
    return best[1]


class _Args(ctypes.Structure):
    """``SsdArgs`` of the ``.cu`` file: one call's shapes and plan."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "Bc", "Q", "H", "P", "N", "dtype", "route", "head_group", "warps",
        "key_block", "stages", "smem", "blocks")]


@functools.lru_cache(maxsize=None)
def _args(Bc: int, Q: int, H: int, P: int, N: int,
          dtype: torch.dtype) -> _Args:
    """The launch's argument block, built once per shape."""
    p = plan(Bc, Q, H, P, N, dtype)
    return _Args(Bc, Q, H, P, N, _DTYPES[dtype], int(p.route == "mma"),
                 p.head_group, p.warps, p.key_block, p.stages, p.smem,
                 p.blocks)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared."""
    lib = _build.load("ssd_scan")
    vp = ctypes.c_void_p
    lib.ssd_scan_launch.argtypes = [vp, vp, vp, vp, vp, vp,
                                    ctypes.POINTER(_Args), vp]
    lib.ssd_scan_launch.restype = ctypes.c_int
    return lib


def _check(x, dt, A, Bm, Cm) -> _Args:
    """Raises on what the kernel does not take; returns the launch's
    argument block."""
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
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"SSD kernel (bf16): {name} must start on a "
                             f"16-byte boundary")
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
    return _args(Bc, Q, H, P, N, x.dtype)


def ssd_scan_cuda(x, dt, A, Bm, Cm) -> torch.Tensor:
    """One-chunk SSD per row.  x: (Bc,Q,H,P); dt: (Bc,Q,H) f32; A: (H,)
    f32; Bm/Cm: (Bc,Q,N) in x's dtype.  Returns y (Bc,Q,H,P) f32."""
    args = _check(x, dt, A, Bm, Cm)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    err = _lib().ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), args,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"SSD kernel launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan"] += 1
    return y
