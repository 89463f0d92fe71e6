"""Grouped-expert SwiGLU on the card — the wrapper of ``csrc/moe_gemm.cu``.

The CUDA kernel replaces the TPU kernel ``moe_grouped_ffn_pallas``
(``repro/kernels/moe_gemm.py``): rows sorted into ragged per-group
segments, each group's expert SwiGLU ``(silu(x Wg) * (x Wu)) Wd`` in f32,
an optional ``group_experts`` group -> weight-row map.  It is bound by the
bytes of the experts' weights.  bf16 runs on tensor cores (``mma.sync``
fed by ``ldmatrix`` from a 3-stage ``cp.async`` ring, h carried as a
bf16 hi/lo pair); float32 keeps SIMT kernels, which its 2e-5 checks need.
Two launches (up, then down), each a grid of (column tile, logical tile),
the logical tiles those of ``schedule``.  A row's bits depend on the row
and its expert alone: the order of every reduction is fixed by (d, f,
dtype).  ``plan`` picks the route, tiles and shared memory; the source
note in the ``.cu`` file states the design and the bound.

The entry point checks what the kernel takes and raises on anything else,
never reads the group sizes on the host (they stay on the device, so a
layer does not wait for the card), launches on PyTorch's current stream,
raises if a launch is refused, and adds one to ``LAUNCHES``.  It never
falls back to the plain version: ``kernels.ops`` sends CPU tensors there
and CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import _build

# Launches of the entry point — a run reads this to show that its path
# went through the kernel.  ``reset_launches`` zeroes it.
LAUNCHES: Dict[str, int] = {"moe_grouped_ffn": 0}

MAX_GROUPS = 1024                # kMaxGroups in csrc/moe_gemm.cu
MAX_TILES = 65535                # gridDim.y: logical tiles
SMEM_LIMIT = 227 * 1024          # H100: shared memory one block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 (tensor cores): the k step and row padding of every configuration,
# and the (M tile, N tile, warps, stages) of the up and of the down launch
# at decode (short segments) and at prefill (segments of tens of rows).
K_STEP, PAD = 64, 8
MMA_LAUNCHES = {"decode": ((16, 32, 4, 3), (16, 128, 4, 3)),
                "prefill": ((128, 64, 8, 3), (64, 128, 8, 3))}
# float32 (SIMT): 16-row tiles, 64 columns (one thread each) a block,
# the reduction staged 128 elements at a time.
SIMT_ROWS, SIMT_COLS, SIMT_CHUNK = 16, 64, 128


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def schedule(group_sizes: Sequence[int], T: int,
             m_tile: int) -> List[Tuple[int, int, int, int]]:
    """The kernel's logical tiles, as ``find_tile`` in the ``.cu`` file
    walks them: one (group, physical tile, lo, hi) per row tile of
    ``m_tile`` rows that a non-empty segment overlaps, in order; the tile
    covers rows [lo, hi) of that group.  Segments are clamped to T and
    negative sizes count as 0.  The (group, physical tile) pairs are those
    of the JAX package's ``make_group_metadata`` at ``block_t = m_tile``."""
    out, start = [], 0
    for g, n in enumerate(group_sizes):
        n = min(max(int(n), 0), T)
        end = min(start + n, T)
        if end > start:
            for m in range(start // m_tile, (end - 1) // m_tile + 1):
                out.append((g, m, max(start, m * m_tile),
                            min(end, (m + 1) * m_tile)))
        start = end
    return out


def max_tiles(T: int, G: int, m_tile: int) -> int:
    """The static grid's logical tiles: more than ``schedule`` can use
    (at most ceil(T / m_tile) + G - 1), so at least one is spare and zeroes
    the rows past the segments."""
    return -(-T // m_tile) + G


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of a call (up: h over the columns of f; down: y over the
    columns of d): rows of a logical tile, columns a block, warps a
    block, the cp.async ring's stages, dynamic shared memory, and the grid
    (column tiles, logical tiles)."""

    m_tile: int
    n_tile: int
    warps: int
    stages: int
    smem: int
    grid: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a call runs.  ``route``: "mma" (bf16, tensor cores) or "simt"
    (f32).  ``k_step``: reduction elements staged per step, by (d, f,
    dtype) only: with the k16 products in index order inside one warp it
    fixes the order of every sum, so a row's bits do not depend on T or on
    the tiles.  Each launch has its own logical tiles (h is per row)."""

    route: str
    k_step: int
    up: Launch
    down: Launch


def _tiles(n: int, tile: int) -> int:
    return -(-n // tile)


def plan(T: int, d: int, f: int, E: int, G: int, dtype: torch.dtype) -> Plan:
    """The launch plan of one call, from the shapes and dtype alone (the
    group sizes stay on the device).  bf16 takes the prefill tiles (128 and
    64 rows: fewer re-reads of each expert's weights) when the segments
    average 16 rows or more, else the decode tiles (16 rows: more blocks
    busy when each expert has a row or two).  Raises ValueError, naming the
    shape, on what the kernel does not take."""
    if dtype not in _DTYPES:
        raise ValueError(f"grouped FFN kernel takes float32 or bfloat16, "
                         f"got {dtype}")
    if T < 1 or d < 1 or f < 1 or E < 1:
        raise ValueError(f"grouped FFN kernel: nothing to compute (T={T}, "
                         f"d={d}, f={f}, E={E})")
    if not 1 <= G <= MAX_GROUPS:
        raise ValueError(f"grouped FFN kernel takes 1 to {MAX_GROUPS} "
                         f"groups, got G={G}")
    if dtype == torch.float32:
        route, k_step = "simt", SIMT_CHUNK
        up = down = (SIMT_ROWS, SIMT_COLS, SIMT_COLS // 32, 1)
        up_smem = down_smem = 0
    else:
        if d % 8 or f % 8:
            raise ValueError(f"grouped FFN kernel (bf16) takes d and f "
                             f"multiples of 8 (16-byte copies), got d={d}, "
                             f"f={f}")
        route, k_step = "mma", K_STEP
        up, down = MMA_LAUNCHES["prefill" if T >= 16 * G else "decode"]
        row = 2 * (k_step + PAD)                  # bytes of a padded row
        up_smem = up[3] * (up[0] * row + 2 * k_step * 2 * (up[1] + PAD))
        down_smem = down[3] * (2 * down[0] * row
                               + k_step * 2 * (down[1] + PAD))
    launches = []
    for (m, n, warps, stages), smem, width in ((up, up_smem, f),
                                               (down, down_smem, d)):
        tiles = max_tiles(T, G, m)
        if tiles > MAX_TILES:
            raise ValueError(f"grouped FFN kernel: T={T} over G={G} groups "
                             f"needs {tiles} logical tiles of {m} rows, more "
                             f"than {MAX_TILES}")
        if smem > SMEM_LIMIT:
            raise ValueError(f"grouped FFN kernel: {smem} bytes of shared "
                             f"memory exceed the {SMEM_LIMIT} a block may "
                             f"use")
        launches.append(Launch(m, n, warps, stages, smem,
                               (_tiles(width, n), tiles)))
    return Plan(route, k_step, *launches)


class _Args(ctypes.Structure):
    """``MoeArgs`` of the ``.cu`` file: one call's shapes and plan."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "rows", "d", "f", "E", "G", "dtype", "k_step", "up_m", "up_n",
        "up_warps", "up_stages", "up_smem", "down_m", "down_n", "down_warps",
        "down_stages", "down_smem")]


@functools.lru_cache(maxsize=None)
def _args(T: int, d: int, f: int, E: int, G: int,
          dtype: torch.dtype) -> _Args:
    """The launch's argument block, built once per shape."""
    p = plan(T, d, f, E, G, dtype)
    return _Args(T, d, f, E, G, _DTYPES[dtype], p.k_step,
                 *(getattr(launch, name) for launch in (p.up, p.down)
                   for name in ("m_tile", "n_tile", "warps", "stages",
                                "smem")))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = _build.load("moe_gemm")
    vp = ctypes.c_void_p
    lib.moe_grouped_ffn_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, ctypes.POINTER(_Args), vp]
    lib.moe_grouped_ffn_launch.restype = ctypes.c_int
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
    if x.dtype == torch.bfloat16:
        for name in ("x", "w_gate", "w_up", "w_down"):
            if tensors[name].data_ptr() % 16:
                raise ValueError(f"grouped FFN kernel (bf16): {name} must "
                                 f"start on a 16-byte boundary")
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
    args = _args(T, d, f, E, group_sizes.shape[0], x.dtype)
    # f32 h, or its bf16 hi and lo halves: the same bytes.
    h = torch.empty((T, f), dtype=torch.float32, device=x.device)
    err = _lib().moe_grouped_ffn_launch(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        group_sizes.data_ptr(),
        None if group_experts is None else group_experts.data_ptr(),
        h.data_ptr(), out.data_ptr(), args,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped FFN kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["moe_grouped_ffn"] += 1
    return out
