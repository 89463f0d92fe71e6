"""The grouped-expert kernel's launch plan and tile schedule, on the CPU.

``plan`` and ``schedule`` are plain Python: they run here, where the CUDA
kernel cannot.  ``schedule`` mirrors the kernel's device-side tile lookup
(``find_tile`` in ``csrc/moe_gemm.cu``); its (group, physical tile) pairs
are held against the JAX package's ``make_group_metadata`` at the same
tile height, over ragged sweeps with empty groups and as a ``hypothesis``
property.  The plan's grids must cover every tile in use, its shared
memory must fit the card, and its k step must not change with T (the
order of every reduction, so a row's bits, depends on it)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.kernels.moe_gemm import make_group_metadata  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402

GRANITE = dict(d=1536, f=512, E=40)          # d_model, d_ff, experts
DTYPES = [torch.float32, torch.bfloat16]
# Compiled once per (G, T, tile height), as the JAX package's tests call it.
METADATA = jax.jit(make_group_metadata, static_argnums=(1, 2))


def jax_pairs(sizes, T, m_tile):
    """The valid (group, physical tile) pairs of ``make_group_metadata``:
    its first sum(tiles each non-empty segment spans) entries."""
    sizes = np.asarray(sizes, np.int32)
    gids, mids, _ = METADATA(jnp.asarray(sizes), T, m_tile)
    ends = np.cumsum(sizes)
    starts = ends - sizes
    spans = np.where(sizes > 0, -(-ends // m_tile) - starts // m_tile, 0)
    n = int(spans.sum())
    assert len(gids) == -(-T // m_tile) + len(sizes) - 1 >= n
    return list(zip(np.asarray(gids)[:n].tolist(),
                    np.asarray(mids)[:n].tolist()))


def check_schedule(sizes, T, m_tile):
    tiles = mg.schedule(sizes, T, m_tile)
    assert [(g, m) for g, m, _, _ in tiles] == jax_pairs(sizes, T, m_tile)
    # Every row of the segments once, by its own group, inside its tile.
    owner = np.repeat(np.arange(len(sizes)), sizes)
    covered = np.zeros(T, int)
    for g, m, lo, hi in tiles:
        assert m * m_tile <= lo < hi <= (m + 1) * m_tile
        assert (owner[lo:hi] == g).all()
        covered[lo:hi] += 1
    assert (covered[:len(owner)] == 1).all() and not covered[len(owner):].any()
    assert len(tiles) < mg.max_tiles(T, len(sizes), m_tile)


@pytest.mark.parametrize("m_tile", [16, 64, 128])
@pytest.mark.parametrize("seed", range(6))
def test_schedule_matches_make_group_metadata(seed, m_tile):
    """The ``test_moe_dispatch`` sweep: ragged sizes up to five tiles, one
    group forced empty, a few rows past the segments."""
    rng = np.random.default_rng(seed)
    G = int(rng.integers(1, 41))
    sizes = rng.integers(0, 5 * m_tile, G)
    sizes[rng.integers(0, G)] = 0
    T = int(sizes.sum()) + int(rng.integers(0, 20)) or 1
    check_schedule(sizes.tolist(), T, m_tile)


@pytest.mark.parametrize("sizes", [
    [0, 0, 5],                                # leading empty groups
    [16, 16, 16, 16],                         # every segment tile-aligned
    [15, 16, 17, 63, 64, 65],                 # across both tiles' edges
    [1] * 40,                                 # decode: a row an expert
    [0] * 1023 + [7],                         # the most groups, one used
])
@pytest.mark.parametrize("m_tile", [16, 64, 128])
def test_schedule_edge_cases(sizes, m_tile):
    check_schedule(sizes, sum(sizes) + 3, m_tile)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 90), min_size=1, max_size=48),
       st.sampled_from([16, 64, 128]))
def test_schedule_matches_make_group_metadata_property(sizes, m_tile):
    """Any ragged sizes over 48 groups (short lists padded with empty
    groups) in 4400 rows, so one compiled schedule per tile height."""
    check_schedule(sizes + [0] * (48 - len(sizes)), 4400, m_tile)


def test_schedule_clamps_to_t_and_ignores_negative_sizes():
    """What the kernel does with sizes it should not get: segments past T
    are cut at T, a negative size counts as an empty group."""
    assert mg.schedule([10, -4, 30], 20, 16) == [
        (0, 0, 0, 10), (2, 0, 10, 16), (2, 1, 16, 20)]


@pytest.mark.parametrize("T", [1, 32, 2048])
def test_plan_routes_bf16_to_tensor_cores_and_f32_to_simt(T):
    assert mg.plan(T, **GRANITE, G=40, dtype=torch.bfloat16).route == "mma"
    assert mg.plan(T, **GRANITE, G=40, dtype=torch.float32).route == "simt"


def test_plan_takes_longer_tiles_for_long_segments():
    """Decode (a row or two an expert) keeps 16-row tiles and 32-column up
    blocks, which keeps at least two blocks an SM busy with 22 experts;
    prefill's segments of about 51 rows take 128- and 64-row tiles."""
    dec = mg.plan(32, **GRANITE, G=40, dtype=torch.bfloat16)
    assert (dec.up.m_tile, dec.down.m_tile) == (16, 16)
    assert 22 * dec.up.grid[0] >= 2 * 132
    assert 22 * dec.down.grid[0] >= 2 * 132
    pre = mg.plan(2048, **GRANITE, G=40, dtype=torch.bfloat16)
    assert (pre.up.m_tile, pre.down.m_tile) == (128, 64)
    for p in (dec, pre):
        assert p.up.stages >= 3 and p.down.stages >= 3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [1, 32, 33, 2048, 4096])
@pytest.mark.parametrize("d,f", [(1536, 512), (96, 40), (64, 48), (256, 128)])
def test_plan_shared_memory_fits_the_card(T, d, f, dtype):
    p = mg.plan(T, d, f, 8, 8, dtype)
    for launch in (p.up, p.down):
        assert 0 <= launch.smem <= mg.SMEM_LIMIT
        assert launch.warps * 32 <= 1024


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [1, 32, 33, 2048, 4096])
@pytest.mark.parametrize("G", [1, 8, 40, 1024])
def test_plan_grids_cover_every_tile_in_use(T, G, dtype):
    """Ragged sizes summing to at most T, empty groups included: both
    launches' grids hold every logical tile of their own M tile plus a
    spare row (which zeroes the rows past the segments), and their column
    tiles cover f and d."""
    d, f = GRANITE["d"], GRANITE["f"]
    p = mg.plan(T, d, f, GRANITE["E"], G, dtype)
    assert p.up.grid[0] * p.up.n_tile >= f
    assert p.down.grid[0] * p.down.n_tile >= d
    rng = np.random.default_rng(T + G)
    for _ in range(5):
        cuts = np.sort(rng.integers(0, T + 1, G - 1))
        sizes = np.diff(np.concatenate([[0], cuts, [T]]))
        sizes[rng.random(G) < 0.3] = 0                # empty groups
        for launch in (p.up, p.down):
            used = len(mg.schedule(sizes.tolist(), T, launch.m_tile))
            assert used < launch.grid[1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,f", [(1536, 512), (96, 40), (64, 48)])
def test_plan_k_step_does_not_depend_on_t(d, f, dtype):
    """The k step fixes the order of every reduction, so it must be the
    same at decode and prefill: that is what keeps a row's bits the same
    in a 1-row and a 2048-row call."""
    steps = {mg.plan(T, d, f, 40, 40, dtype).k_step
             for T in (1, 4, 32, 33, 640, 2048, 4096)}
    assert len(steps) == 1


@pytest.mark.parametrize("args,match", [
    ((32, 1536, 512, 40, 40, torch.float16), "float32 or bfloat16"),
    ((32, 36, 512, 40, 40, torch.bfloat16), "d=36"),
    ((32, 1536, 20, 40, 40, torch.bfloat16), "f=20"),
    ((32, 1536, 512, 40, 0, torch.bfloat16), "G=0"),
    ((32, 1536, 512, 40, 1025, torch.bfloat16), "G=1025"),
    ((0, 1536, 512, 40, 40, torch.bfloat16), "T=0"),
    ((2 ** 21, 1536, 512, 40, 40, torch.float32), "T=2097152"),
])
def test_plan_refuses_odd_shapes_by_name(args, match):
    with pytest.raises(ValueError, match=match):
        mg.plan(*args)


def test_plan_takes_f32_at_any_width():
    """The SIMT route loads scalars: d and f need not be multiples of 8."""
    p = mg.plan(45, 36, 20, 4, 4, torch.float32)
    assert p.route == "simt" and p.up.grid[0] == 1 and p.down.grid[0] == 1


def test_argument_block_carries_the_plan():
    p = mg.plan(2048, **GRANITE, G=40, dtype=torch.bfloat16)
    a = mg._args(2048, 1536, 512, 40, 40, torch.bfloat16)
    assert (a.rows, a.d, a.f, a.E, a.G, a.dtype, a.k_step) == (
        2048, 1536, 512, 40, 40, 1, p.k_step)
    assert (a.up_m, a.up_n, a.up_warps, a.up_stages, a.up_smem) == (
        p.up.m_tile, p.up.n_tile, p.up.warps, p.up.stages, p.up.smem)
    assert (a.down_m, a.down_n, a.down_warps, a.down_stages,
            a.down_smem) == (p.down.m_tile, p.down.n_tile, p.down.warps,
                             p.down.stages, p.down.smem)
