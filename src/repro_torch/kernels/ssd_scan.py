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
version.

The gradient (``ssd_scan_bwd_cuda``, ``LAUNCHES["ssd_scan_bwd"]``, one
count for its two launches) is a backward kernel in the same ``.cu`` file:
the JAX package takes it by autograd through its jnp ``ssd_chunked``
(``repro/models/ssm.py:84``); ``ssd_scan_pallas`` has no VJP.  bf16 runs
it on tensor cores (``mma.sync``; warps on 16-row strips of keys, dY and the
weights fed as bf16 hi/lo pairs, x, B and C as they are, the S^T and dS^T
triangles in shared memory, dx staged and stored in 16-byte row pieces);
float32 keeps the SIMT kernels, which its 1e-4 checks need.  No atomics:
per-group dS partials summed in group order by a second launch.
``plan_bwd`` picks the route, head group, runs, warps, grids and shared
memory from the shapes without Bc, so each chunk row's dx, ddt, dB and dC
do not depend on the rest of the call.  ``SSDScan`` is the autograd
function over the two: on a CUDA tensor the kernels, on a CPU tensor
``ref.ssd_reference`` and ``ref.ssd_bwd_reference``; ``kernels.ops``
calls it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from . import _build, cost, ref

# Launches per entry point: a run reads these to show that its path went
# through the kernel.
LAUNCHES: Dict[str, int] = {"ssd_scan": 0, "ssd_scan_bwd": 0}

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
    """The built library with its C signatures declared."""
    lib = _build.load("ssd_scan")
    vp = ctypes.c_void_p
    lib.ssd_scan_launch.argtypes = [vp, vp, vp, vp, vp, vp,
                                    ctypes.POINTER(_Args), vp]
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_bwd_launch.argtypes = [vp] * 14 + [
        ctypes.POINTER(_BwdArgs), vp]
    lib.ssd_scan_bwd_launch.restype = ctypes.c_int
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


# ------------------------------------------------------------------ backward
# float32 ("simt"), launch 1: 256 threads as 16 x 16, 64-row tiles, at most
# BWD_MAX_GROUP heads a block (their dS partial is one strip in shared
# memory); launch 2: grid (Bc + 1, 2 nT), the same threads.
BWD_THREADS, BWD_TILE, BWD_MAX_GROUP = 256, 64, 16
# bfloat16 ("mma"), launch 1: 16-row strips of keys j, each meeting the
# subtiles of rows i at or below it; a warp owns a run of at most `chunk`
# subtiles of one strip, at most BWD_MMA_MAX_WARPS warps a block and
# BWD_MMA_MAX_GROUP heads (the group's 14 at hybrid training's 112 heads
# make 256 blocks, 1.94 waves of one block an SM; 16 would make 224, 1.7
# waves).  The S^T and dS^T triangles stay in shared memory while the
# chunk is at most TRI_SMEM_ROWS positions, else in a device scratch.
# Launch 2: 8 warps, 64 rows a block, 64 keys a step.
BWD_MMA_MAX_WARPS, BWD_MMA_MAX_GROUP, TRI_SMEM_ROWS = 16, 14, 128
BWD_RED_ROWS = 64


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How a backward call runs.  ``route``: "mma" (bf16, tensor cores) or
    "simt" (f32).  ``head_group``: heads a block of launch 1 (a divisor of
    H; the dS partials of a chunk row sum over H / head_group groups in
    order, so it is chosen from (Q, H, P, N) alone, never from Bc).
    ``threads``: launch 1's block.  ``chunk``: on "mma", the subtiles of a
    warp's run (a strip's runs add their dxdt in run order), from Q alone;
    0 on "simt".  ``tri_smem``: on "mma", whether the S^T and dS^T
    triangles live in shared memory.  ``smem``/``reduce_smem``: each
    launch's dynamic shared memory.  ``grid``: launch 1's blocks, (Bc * H /
    head_group,); ``reduce_grid``: launch 2's (Bc + 1, 2 nT), nT = ceil(Q /
    64) on "simt" and ceil(QS / 64) on "mma", QS = Q rounded up to 16.
    ``scratch``: the f32 dS partials' shape, (Bc, H / head_group, QT, QT)
    on "simt" (QT = Q rounded up to 64) and (Bc, H / head_group, TRI) on
    "mma" (TRI = ``tri_floats(QS)``); ``st_scratch``: on "mma" without
    ``tri_smem`` the S^T triangles' (the same shape), else (0,)."""

    route: str
    head_group: int
    threads: int
    chunk: int
    tri_smem: bool
    smem: int
    grid: Tuple[int]
    reduce_smem: int
    reduce_grid: Tuple[int, int]
    scratch: Tuple[int, ...]
    st_scratch: Tuple[int, ...]


def _bwd_smem(Q: int, N: int, P: int, G: int) -> int:
    """Launch 1's shared memory on "simt" (``bwd_smem_floats`` of the
    ``.cu`` file): the key tile's score and dS strips (QT, 65), four (G,
    QT) per-head rows, and the tiles (x, dt x, dY (64, P + 1), W (64, 65),
    column partials (16, 64)) or the B/C staging (2 (64, NP + 1)), the
    larger."""
    qt, T = _up(Q, BWD_TILE), BWD_TILE
    tiles = 3 * T * (P + 1) + T * (T + 1) + 16 * T
    stage = 2 * T * (_up(N, 16) + 1)
    return 4 * (2 * qt * (T + 1) + 4 * G * qt + max(tiles, stage))


def bwd_warps(ns: int, chunk: int) -> int:
    """Launch 1's warps on "mma" (``bwd_warps`` of the ``.cu`` file): strip
    s meets ns - s subtiles, cut in runs of ``chunk``, one warp a run."""
    return sum(-(-(ns - s) // chunk) for s in range(ns))


def bwd_chunk(ns: int) -> int:
    """The least run length from ceil(subtiles / 16) up whose warps fit
    BWD_MMA_MAX_WARPS (``bwd_chunk`` of the ``.cu`` file)."""
    pairs = ns * (ns + 1) // 2
    c = max(1, -(-pairs // BWD_MMA_MAX_WARPS))
    while bwd_warps(ns, c) > BWD_MMA_MAX_WARPS:
        c += 1
    return c


def bwd_runs(ns: int, chunk: int):
    """Warp k's (strip, run, subtiles u0..u1-1), in warp order, as the
    ``.cu`` file assigns them."""
    runs = []
    for s in range(ns):
        for q in range(-(-(ns - s) // chunk)):
            u0 = s + q * chunk
            runs.append((s, q, range(u0, min(ns, u0 + chunk))))
    return runs


def tri_floats(qs: int) -> int:
    """Floats of a (qs, qs) lower triangle in 16-row strips, strip s with
    columns 16s.. and a row stride of qs - 16s + 8 (``tri_floats``)."""
    ns = qs // 16
    return 16 * (ns * (qs + 8) - 8 * ns * (ns - 1))


def _bwd_mma_smem(Q: int, N: int, P: int, G: int) -> int:
    """Launch 1's shared memory on "mma" (``bwd_layout`` of the ``.cu``
    file): the S^T and dS^T triangles (f32, when they live there), the
    head's x tile (bf16 (QS, P + 8)), one region for first the B and C rows
    (bf16 (QS, NP + 8) each) and then the head's dY (f32 (QS, P), its hi
    and lo (QS, P + 8) bf16 each), the dxdt slots of the runs after a
    strip's first ((16 (P + 8) + 16) f32 each), the row sums of G by strip
    (f32 (ns, QS)), and dt, dc and the cumsum for G heads (f32 (G, QS)
    each)."""
    qs = _up(Q, 16)
    ns, ldx = qs // 16, P + PAD
    slots = bwd_warps(ns, bwd_chunk(ns)) - ns
    tri = 4 * tri_floats(qs) if qs <= TRI_SMEM_ROWS else 0
    ybuf = max(qs * P * 4 + 2 * qs * ldx * 2,
               2 * qs * (_up(N, K_STEP) + PAD) * 2)
    return (2 * tri + qs * ldx * 2 + ybuf + slots * (16 * ldx + 16) * 4
            + ns * qs * 4 + 3 * G * qs * 4)


def plan_bwd(Bc: int, Q: int, H: int, P: int, N: int,
             dtype: torch.dtype) -> BwdPlan:
    """The backward's launch plan, from the shapes and dtype alone; it
    takes what the forward's ``plan`` takes and raises the same
    ValueError, naming the shape, on anything else."""
    route = plan(Bc, Q, H, P, N, dtype).route
    if route == "simt":
        max_group, smem = BWD_MAX_GROUP, _bwd_smem
    else:
        max_group, smem = BWD_MMA_MAX_GROUP, _bwd_mma_smem
    groups = [G for G in range(min(H, max_group), 0, -1)
              if H % G == 0 and smem(Q, N, P, G) <= SMEM_LIMIT]
    if not groups:
        raise ValueError(f"SSD backward: {smem(Q, N, P, 1)} bytes of "
                         f"shared memory exceed the {SMEM_LIMIT} a block "
                         f"may use")
    G = groups[0]
    if Bc * (H // G) > MAX_BLOCKS:
        raise ValueError(f"SSD backward: Bc={Bc} chunks of {H} heads need "
                         f"more than {MAX_BLOCKS} blocks")
    if route == "simt":
        qt, nt = _up(Q, BWD_TILE), -(-Q // BWD_TILE)
        return BwdPlan("simt", G, BWD_THREADS, 0, False, smem(Q, N, P, G),
                       (Bc * (H // G),),
                       4 * (BWD_TILE * (BWD_TILE + 1)
                            + BWD_TILE * (_up(N, 16) + 1)),
                       (Bc + 1, 2 * nt), (Bc, H // G, qt, qt), (0,))
    qs = _up(Q, 16)
    ns = qs // 16
    chunk = bwd_chunk(ns)
    tri_smem = qs <= TRI_SMEM_ROWS
    part = (Bc, H // G, tri_floats(qs))
    red = BWD_RED_ROWS
    return BwdPlan("mma", G, 32 * bwd_warps(ns, chunk), chunk, tri_smem,
                   smem(Q, N, P, G), (Bc * (H // G),),
                   2 * red * (red + PAD) * 2 + red * (_up(N, K_STEP) + PAD) * 2,
                   (Bc + 1, 2 * -(-qs // red)), part,
                   (0,) if tri_smem else part)


class _BwdArgs(ctypes.Structure):
    """``SsdBwdArgs`` of the ``.cu`` file."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "Bc", "Q", "H", "P", "N", "dtype", "route", "head_group", "threads",
        "smem", "blocks", "reduce_smem", "reduce_y", "chunk", "tri_smem")]


@functools.lru_cache(maxsize=None)
def _bwd_args(Bc: int, Q: int, H: int, P: int, N: int,
              dtype: torch.dtype) -> Tuple[_BwdArgs, BwdPlan]:
    p = plan_bwd(Bc, Q, H, P, N, dtype)
    return _BwdArgs(Bc, Q, H, P, N, _DTYPES[dtype], int(p.route == "mma"),
                    p.head_group, p.threads, p.smem, p.grid[0],
                    p.reduce_smem, p.reduce_grid[1], p.chunk,
                    int(p.tri_smem)), p


def ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, dy):
    """The gradient of ``ssd_scan_cuda`` at (x, dt, A, Bm, Cm) for the
    output gradient dy (Bc,Q,H,P) f32: (dx, ddt, dA, dB, dC), dx/dB/dC in
    x's dtype, ddt/dA f32, as ``ref.ssd_bwd_reference`` gives them.  Two
    launches, one count."""
    _check(x, dt, A, Bm, Cm)
    if dy.device != x.device or dy.dtype != torch.float32 or \
            dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError(f"SSD backward: dy is {dy.dtype} {tuple(dy.shape)} "
                         f"on {dy.device}, expected a contiguous float32 "
                         f"{tuple(x.shape)} on {x.device}")
    if x.dtype == torch.bfloat16 and dy.data_ptr() % 16:
        raise ValueError("SSD backward (bf16): dy must start on a 16-byte "
                         "boundary")
    Bc, Q, H, P = x.shape
    args, p = _bwd_args(Bc, Q, H, P, Bm.shape[-1], x.dtype)
    dx, dB, dC = (torch.empty_like(t) for t in (x, Bm, Cm))
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    ds_part = torch.empty(p.scratch, dtype=torch.float32, device=x.device)
    st_part = torch.empty(p.st_scratch, dtype=torch.float32, device=x.device)
    da_part = torch.empty((Bc, H), dtype=torch.float32, device=x.device)
    err = _lib().ssd_scan_bwd_launch(
        *(t.data_ptr() for t in (x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC,
                                 ds_part, st_part, da_part)),
        args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"SSD backward launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, dA, dB, dC


class SSDScan(torch.autograd.Function):
    """The SSD intra-chunk block with its gradient: on CUDA tensors
    ``ssd_scan_cuda`` and ``ssd_scan_bwd_cuda``, on CPU tensors
    ``ref.ssd_reference`` and ``ref.ssd_bwd_reference``, on ``meta`` empty
    outputs.  The forward saves its inputs only; the backward recomputes
    the cumsum and the decays.  Each charges its cost to an open cost walk
    (``cost.charging``)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        with cost.charging("ssd_scan",
                           lambda: cost.ssd(x, dt, A, Bm, Cm)[0]):
            if x.device.type == "meta":
                return torch.empty(x.shape, dtype=torch.float32,
                                   device="meta")
            fwd = (ref.ssd_reference if x.device.type == "cpu"
                   else ssd_scan_cuda)
            return fwd(x, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        with cost.charging("ssd_scan_bwd", lambda: cost.ssd(*saved)[1]):
            if saved[0].device.type == "meta":
                return tuple(torch.empty_like(t) for t in saved)
            bwd = (ref.ssd_bwd_reference if saved[0].device.type == "cpu"
                   else ssd_scan_bwd_cuda)
            return bwd(*saved, dy.contiguous())
