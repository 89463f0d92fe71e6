"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a CUDA device every test here skips, and
the module imports no JAX (the card's machine has none).  Run on the card
with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_scan as ss

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels run only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def case(dev, dtype, B, H, K, dh, N, P, MP, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((N, P, K, dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((N, P, K, dh), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(N, generator=gen, device=dev).to(torch.int32)
    table = torch.full((B, MP), -1, dtype=torch.int32, device=dev)
    lengths = torch.zeros((B,), dtype=torch.int32, device=dev)
    used = 0
    for b in range(B):
        n_pages = 1 + (b * 7) % MP
        lengths[b] = (n_pages - 1) * P + 1 + (b * 5) % P
        table[b, :n_pages] = perm[used:used + n_pages]
        used += n_pages
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,dh,N,P,MP,window", [
    (2, 8, 8, 64, 8, 8, 3, None),
    (3, 8, 4, 64, 16, 8, 4, None),
    (2, 4, 4, 128, 8, 16, 2, None),
    (2, 8, 4, 64, 16, 8, 4, 7),
    (1, 8, 2, 96, 8, 8, 4, None),
    (4, 32, 8, 64, 256, 16, 64, None),
    (4, 24, 8, 64, 80, 16, 32, None),       # the MoE serving path's shape
    (4, 24, 8, 64, 80, 16, 32, 200),
    (4, 32, 32, 80, 96, 16, 24, None),      # stablelm_3b: 32/32 of dh 80
    (4, 32, 32, 80, 96, 16, 24, 37),
])
def test_paged_attention_kernel_matches_plain(cuda, dtype, B, H, K, dh, N,
                                              P, MP, window):
    q, kp, vp, table, lengths = case(cuda, dtype, B, H, K, dh, N, P, MP)
    before = pa.LAUNCHES["paged_attention"]
    got = ops.paged_attention(q, kp, vp, table, lengths, window=window)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_attention"] == before + 1
    want = ref.paged_attention_reference(q, kp, vp, table, lengths,
                                         window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 5])
def test_paged_prefill_kernel_matches_plain_and_decode(cuda, dtype, window):
    S, pad, P, K, H, dh, MP, N = 40, 8, 8, 2, 8, 64, 8, 16
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((S + pad, H, dh), generator=gen, device=cuda).to(dtype)
    kp = torch.randn((N, P, K, dh), generator=gen, device=cuda).to(dtype)
    vp = torch.randn((N, P, K, dh), generator=gen, device=cuda).to(dtype)
    table = torch.full((MP,), -1, dtype=torch.int32, device=cuda)
    table[:S // P] = torch.randperm(N, generator=gen, device=cuda)[
        :S // P].to(torch.int32)
    lengths = torch.cat([torch.arange(1, S + 1), torch.zeros(pad)]).to(
        device=cuda, dtype=torch.int32)
    before = pa.LAUNCHES["paged_prefill"]
    got = ops.paged_prefill(q, kp, vp, table, lengths, window=window)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_prefill"] == before + 1
    want = ref.paged_prefill_reference(q, kp, vp, table, lengths,
                                       window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.all(got[S:] == 0), "padded rows are zeros"
    dec = ops.paged_attention(q, kp, vp,
                              table[None].expand(S + pad, -1).contiguous(),
                              lengths, window=window)
    assert torch.equal(dec, got), "prefill rows == decode rows, bitwise"


def contract_case(dev, dtype, H, K, dh, S, pad, hole, seed):
    """S prompt rows (causal lengths 1..S, so BK-1, BK and BK+1 among
    them) and ``pad`` zero-length rows over one shuffled table of 16-token
    pages; with ``hole`` a -1 slot in the middle of the table."""
    P, MP, N = 16, 24, 64
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((S + pad, H, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((N, P, K, dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((N, P, K, dh), generator=gen, device=dev).to(dtype)
    table = torch.full((MP,), -1, dtype=torch.int32, device=dev)
    n_pages = -(-S // P)
    table[:n_pages] = torch.randperm(N, generator=gen, device=dev)[
        :n_pages].to(torch.int32)
    if hole:
        table[n_pages // 2] = -1
    lengths = torch.cat([torch.arange(1, S + 1), torch.zeros(pad)]).to(
        device=dev, dtype=torch.int32)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,K", [(24, 8), (32, 8)])       # G = 3 and 4
@pytest.mark.parametrize("dh", [64, 80, 128])
@pytest.mark.parametrize("window", [None, 37])   # ends mid-page, mid-block
@pytest.mark.parametrize("hole", [False, True])
def test_prefill_rows_bitwise_equal_decode_rows(cuda, dtype, H, K, dh,
                                                window, hole):
    """The per-row contract: every prefill row equals the decode of the
    same query, table and length bit for bit, whatever the decode batch
    (B = 1, 4, 32) and wherever the row sits in it.  S = 150 is not a
    multiple of the prefill tile (16 tokens at G = 4, 21 at G = 3).  Also
    the kernel against the plain version, and two launches bitwise."""
    S, pad = 150, 6
    q, kp, vp, table, lengths = contract_case(cuda, dtype, H, K, dh, S, pad,
                                              hole, seed=dh + H + 1)
    pre = pa.paged_prefill_cuda(q, kp, vp, table, lengths, window=window)
    again = pa.paged_prefill_cuda(q, kp, vp, table, lengths, window=window)
    want = ref.paged_prefill_reference(q, kp, vp, table, lengths,
                                       window=window)
    torch.cuda.synchronize()
    assert torch.equal(pre, again), "two launches differ"
    torch.testing.assert_close(pre.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.all(pre[S:] == 0), "padded rows are zeros"
    rows = S + pad
    MP = table.shape[0]
    for B in (1, 4, 32):
        for start in range(0, rows, B):
            idx = list(range(start, min(start + B, rows)))
            # Place the rows from the end of the batch backwards, the other
            # slots zero-length rows, as the engine pads its batch.
            qq = torch.zeros((B, H, dh), dtype=dtype, device=cuda)
            tb = torch.full((B, MP), -1, dtype=torch.int32, device=cuda)
            ll = torch.zeros((B,), dtype=torch.int32, device=cuda)
            slots = list(range(B - 1, B - 1 - len(idx), -1))
            for b, t in zip(slots, idx):
                qq[b], tb[b], ll[b] = q[t], table, lengths[t]
            dec = pa.paged_attention_cuda(qq, kp, vp, tb, ll, window=window)
            for b, t in zip(slots, idx):
                assert torch.equal(dec[b], pre[t]), \
                    f"B={B}: row {t} (length {int(lengths[t])}) differs"


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, kp, vp, table, lengths = case(cuda, torch.float32, 2, 4, 4, 64, 8, 8,
                                     3)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((2, 4, 256), device=cuda)
        pool = torch.zeros((8, 8, 4, 256), device=cuda)
        pa.paged_attention_cuda(big, pool, pool, table, lengths)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pa.paged_attention_cuda(q.half(), kp.half(), vp.half(), table,
                                lengths)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention_cuda(q, kp, vp, table.long(), lengths)
    with pytest.raises(ValueError, match="is on cpu"):
        pa.paged_attention_cuda(q, kp, vp, table.cpu(), lengths)


def test_pool_migrates_between_hbm_and_pinned_host(cuda):
    from repro_torch.serve.kvcache import PagedKVPool

    pool = PagedKVPool(n_layers=3, page_size=16, kv_heads=8, head_dim=64,
                       hbm_pages=8, host_pages=8, dtype=torch.bfloat16,
                       device=cuda)
    assert pool.k_hbm.is_cuda and pool.k_host.is_pinned()
    pages = [pool.allocate(0, i, step=0) for i in range(6)]
    gen = torch.Generator(device=cuda).manual_seed(0)
    pool.k_hbm.copy_(torch.randn(pool.k_hbm.shape, generator=gen,
                                 device=cuda))
    pool.v_hbm.copy_(torch.randn(pool.v_hbm.shape, generator=gen,
                                 device=cuda))
    before = {p.page_id: (pool.k_hbm[:, p.hbm_slot].clone(),
                          pool.v_hbm[:, p.hbm_slot].clone()) for p in pages}
    ids = [p.page_id for p in pages]
    pool.swap_out_many(ids[:4])
    for pid in ids[:4]:                            # host data is current
        slot = pool.pages[pid].host_slot
        assert torch.equal(pool.k_host[:, slot], before[pid][0].cpu())
    pool.exchange(ids[4:], ids[:4])
    pool.swap_in_many(ids[4:])
    assert pool.transfer_events == 2 + 4 + 2
    for pid in ids:
        slot = pool.pages[pid].hbm_slot
        assert torch.equal(pool.k_hbm[:, slot], before[pid][0])
        assert torch.equal(pool.v_hbm[:, slot], before[pid][1])
    export = pool.export_pages(ids)
    assert not export.k.is_cuda
    assert torch.equal(export.k[:, 0], before[ids[0]][0].cpu())


def ffn_case(dev, dtype, T, E, d, f, sizes, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((T, d), generator=gen, device=dev).to(dtype)
    wg = (torch.randn((E, d, f), generator=gen, device=dev)
          / d ** 0.5).to(dtype)
    wu = (torch.randn((E, d, f), generator=gen, device=dev)
          / d ** 0.5).to(dtype)
    wd = (torch.randn((E, f, d), generator=gen, device=dev)
          / f ** 0.5).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    return x, wg, wu, wd, gs


def routed(tokens, E, k, seed):
    """Group sizes of ``tokens`` tokens each routed to k distinct experts
    at random (numpy, the same on every machine)."""
    rng = np.random.default_rng(seed)
    picks = np.argsort(rng.random((tokens, E)), axis=1)[:, :k]
    return np.bincount(picks.reshape(-1), minlength=E).tolist()


def cut(sizes, lo, hi):
    """The group sizes of rows [lo, hi) of a call with ``sizes``."""
    out, start = [], 0
    for n in sizes:
        out.append(max(0, min(start + n, hi) - max(start, lo)))
        start += n
    return out


# Segments of 15, 16, 17, 63, 64 and 65 rows: across the edges of both M
# tiles (6 groups take 64-row tiles at T=240, 40 groups 16-row tiles).
EDGES = [15, 16, 17, 63, 64, 65]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,d,f,sizes,experts", [
    (32, 6, 128, 64, [5, 0, 17, 0, 3, 7], None),
    (45, 4, 96, 40, [7, 20, 0, 11], None),              # 3 rows past sum
    (50, 3, 64, 48, [9, 0, 14, 6, 21], [2, 0, 1, 1, 0]),  # G > E, a map
    (200, 8, 256, 128, [40, 0, 33, 1, 60, 0, 50, 16], None),
    (32, 40, 1536, 512, routed(4, 40, 8, 0), None),     # granite decode
    (2048, 40, 1536, 512, routed(256, 40, 8, 1), None),  # granite prefill
    (32, 8, 4096, 14336, routed(16, 8, 2, 2), None),    # mixtral decode
    (2048, 8, 4096, 14336, routed(1024, 8, 2, 3), None),  # mixtral prefill
    (243, 6, 128, 96, EDGES, None),                     # 64-row tiles
    (243, 40, 128, 96, EDGES + [0] * 34, None),         # 16-row tiles
    # 40 groups (a last chunk of 8 for the kernel's 32-lane scan) and rows
    # past the segments, with the decode and with the prefill tiles.
    (300, 40, 128, 64, routed(36, 40, 8, 9), None),
    (700, 40, 128, 64, routed(86, 40, 8, 10), None),
])
def test_moe_grouped_ffn_kernel_matches_plain(cuda, dtype, T, E, d, f,
                                              sizes, experts):
    x, wg, wu, wd, gs = ffn_case(cuda, dtype, T, E, d, f, sizes)
    ge = None if experts is None else torch.tensor(
        experts, dtype=torch.int32, device=cuda)
    before = mg.LAUNCHES["moe_grouped_ffn"]
    got = ops.moe_grouped_ffn(x, wg, wu, wd, gs, ge)
    torch.cuda.synchronize()
    assert mg.LAUNCHES["moe_grouped_ffn"] == before + 1
    want = ref.moe_grouped_ffn_reference(x, wg, wu, wd, gs, ge)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.all(got[sum(sizes):] == 0), "rows past the segments"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_ffn_rows_do_not_depend_on_the_call(cuda, dtype):
    """Bitwise: the first rows of a 300-row call equal the same rows
    computed alone, with their groups cut to those rows."""
    sizes = [0, 19, 5, 0, 130, 90, 56]
    x, wg, wu, wd, gs = ffn_case(cuda, dtype, 300, 7, 192, 96, sizes, 1)
    full = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs)
    head = torch.tensor([0, 19, 5, 0, 8, 0, 0], dtype=torch.int32,
                        device=cuda)
    part = mg.moe_grouped_ffn_cuda(x[:32].contiguous(), wg, wu, wd, head)
    assert torch.equal(part, full[:32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_ffn_rows_of_2048_equal_1_4_and_32_row_calls(cuda,
                                                                  dtype):
    """Bitwise, at granite's widths: rows of a 2048-row call (64-row tiles
    on the bf16 route) equal the same rows in 1-, 4- and 32-row calls
    (16-row tiles), their groups cut to those rows."""
    sizes = routed(256, 40, 8, 2)
    x, wg, wu, wd, gs = ffn_case(cuda, dtype, 2048, 40, 1536, 512, sizes, 4)
    full = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs)
    for lo, n in ((0, 1), (63, 1), (64, 1), (1000, 1), (2047, 1), (0, 4),
                  (62, 4), (1021, 4), (2044, 4), (0, 32), (48, 32),
                  (1000, 32), (2016, 32)):
        part = mg.moe_grouped_ffn_cuda(
            x[lo:lo + n].contiguous(), wg, wu, wd,
            torch.tensor(cut(sizes, lo, lo + n), dtype=torch.int32,
                         device=cuda))
        assert torch.equal(part, full[lo:lo + n]), (lo, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [32, 2048])
def test_moe_grouped_ffn_two_launches_are_bitwise_equal(cuda, dtype, T):
    sizes = routed(T // 8, 40, 8, 3)
    x, wg, wu, wd, gs = ffn_case(cuda, dtype, T, 40, 1536, 512, sizes, 5)
    first = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs)
    assert torch.equal(mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_ffn_1024_small_groups(cuda, dtype):
    """G = 1024 groups of 0-3 rows over 8 weight rows through a map, the
    most groups the kernel takes, and 5 rows past the segments."""
    rng = np.random.default_rng(6)
    sizes = rng.integers(0, 4, 1024).tolist()
    T = sum(sizes) + 5
    experts = rng.integers(0, 8, 1024).tolist()
    x, wg, wu, wd, gs = ffn_case(cuda, dtype, T, 8, 64, 48, sizes, 7)
    ge = torch.tensor(experts, dtype=torch.int32, device=cuda)
    got = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs, ge)
    want = ref.moe_grouped_ffn_reference(x, wg, wu, wd, gs, ge)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.all(got[T - 5:] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,sizes", [(32, [5, 0, 9, 18]),
                                     (300, [70, 0, 90, 140])])
def test_moe_grouped_ffn_out_of_range_expert_gives_nan_rows(cuda, dtype, T,
                                                            sizes):
    """A non-empty group whose expert lies outside [0, E) gets NaN rows;
    the other groups' rows are unchanged, bitwise."""
    x, wg, wu, wd, gs = ffn_case(cuda, dtype, T, 3, 128, 64, sizes, 8)
    good = torch.tensor([0, 1, 2, 1], dtype=torch.int32, device=cuda)
    bad = torch.tensor([0, 1, 3, -1], dtype=torch.int32, device=cuda)
    want = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs, good)
    got = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs, bad)
    lo = sizes[0] + sizes[1]
    assert torch.equal(got[:lo], want[:lo])
    assert torch.isnan(got[lo:sum(sizes)].float()).all()


def test_moe_grouped_ffn_kernel_refuses_what_it_does_not_take(cuda):
    x, wg, wu, wd, gs = ffn_case(cuda, torch.float32, 8, 2, 32, 16, [3, 5])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mg.moe_grouped_ffn_cuda(x.half(), wg.half(), wu.half(), wd.half(),
                                gs)
    with pytest.raises(ValueError, match="int32"):
        mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs.long())
    with pytest.raises(ValueError, match="is on cpu"):
        mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs.cpu())
    with pytest.raises(ValueError, match="group_experts map"):
        mg.moe_grouped_ffn_cuda(x, wg, wu, wd,
                                torch.tensor([3, 5, 0], dtype=torch.int32,
                                             device=cuda))
    with pytest.raises(ValueError, match="do not match"):
        mg.moe_grouped_ffn_cuda(x, wg, wu, wd.transpose(1, 2).contiguous(),
                                gs)
    with pytest.raises(ValueError, match="contiguous"):
        mg.moe_grouped_ffn_cuda(x.t(), wg, wu, wd, gs)
    x, wg, wu, wd, gs = ffn_case(cuda, torch.bfloat16, 8, 2, 36, 16, [3, 5])
    with pytest.raises(ValueError, match="multiples of 8"):
        mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs)


# ------------------------------------------------ grouped-expert backward
# Each output against the plain backward, as a fraction of its largest
# entry: bf16 outputs round once and the scratch operands carry about 16
# bits (hi/lo pairs); f32 sums in other orders.  bf16 runs on wgmma from
# TMA-fed rings, in 128-row tiles, 64-deep k steps and 32-row weights
# steps: the sizes below cross all three.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def bwd_case(dev, dtype, T, E, d, f, sizes, seed=0):
    x, wg, wu, wd, gs = ffn_case(dev, dtype, T, E, d, f, sizes, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    dy = torch.randn((T, d), generator=gen, device=dev).to(dtype)
    return x, wg, wu, wd, gs, dy


def assert_bwd_close(got, want, dtype, what):
    for name, g, w in zip(("dx", "dWg", "dWu", "dWd"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name)
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        assert err <= BWD_TOL[dtype] * scale, (what, name, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,d,f,sizes,experts", [
    (96, 8, 96, 64, [5, 0, 17, 0, 3, 7, 0, 12], None),       # smoke widths
    (52, 8, 96, 64, [9, 0, 14, 6, 21, 0, 2], [2, 0, 1, 1, 0, 7, 2]),
    (200, 8, 256, 128, [40, 0, 33, 1, 60, 0, 50, 16], None),
    (243, 6, 128, 96, EDGES, None),                     # tile edges
    (4096, 40, 1536, 512, routed(512, 40, 8, 11), None),  # granite
])
def test_moe_grouped_ffn_bwd_kernel_matches_plain(cuda, dtype, T, E, d, f,
                                                  sizes, experts):
    """dx, dWg, dWu, dWd against ``ref.moe_grouped_ffn_bwd_reference``;
    empty groups, a map with repeats, rows past the segments (zero dx),
    segments across the tiles' edges, granite's widths."""
    x, wg, wu, wd, gs, dy = bwd_case(cuda, dtype, T, E, d, f, sizes)
    ge = None if experts is None else torch.tensor(
        experts, dtype=torch.int32, device=cuda)
    before = mg.LAUNCHES["moe_grouped_ffn_bwd"]
    got = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, ge, dy)
    torch.cuda.synchronize()
    assert mg.LAUNCHES["moe_grouped_ffn_bwd"] == before + 1
    want = ref.moe_grouped_ffn_bwd_reference(x, wg, wu, wd, gs, ge, dy)
    assert_bwd_close(got, want, dtype, (T, E, d, f))
    assert torch.all(got[0][sum(sizes):] == 0), "rows past the segments"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_ffn_bwd_is_bitwise_reproducible(cuda, dtype):
    """Two launches give the same bits; an expert's weight gradients do not
    change, bitwise, when another expert's rows do."""
    sizes = routed(512, 40, 8, 12)
    x, wg, wu, wd, gs, dy = bwd_case(cuda, dtype, 4096, 40, 1536, 512,
                                     sizes, 3)
    first = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, None, dy)
    again = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, None, dy)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    x2 = x.clone()
    x2[:sizes[0]] = -x2[:sizes[0]]                     # expert 0's rows
    other = mg.moe_grouped_ffn_bwd_cuda(x2, wg, wu, wd, gs, None, dy)
    for a, b in zip(first[1:], other[1:]):
        assert torch.equal(a[1:], b[1:])
        assert not torch.equal(a[0], b[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_ffn_bwd_out_of_range_expert(cuda, dtype):
    """A group at slot -1: NaN dx rows, every other dx row and every other
    expert's weight gradients bitwise unchanged, its expert's zero."""
    sizes = [70, 0, 90, 140]
    x, wg, wu, wd, gs, dy = bwd_case(cuda, dtype, 300, 4, 128, 64, sizes, 8)
    good = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=cuda)
    bad = torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=cuda)
    want = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, good, dy)
    got = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, bad, dy)
    assert torch.equal(got[0][:160], want[0][:160])
    assert torch.isnan(got[0][160:].float()).all()
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a[:3], b[:3]) and torch.all(a[3] == 0)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float32, "simt")])
def test_moe_grouped_ffn_bwd_takes_its_route(cuda, dtype, route):
    """bf16 on tensor cores, f32 on SIMT; autograd through ``ops`` reaches
    the backward kernel once a call."""
    assert mg.plan_bwd(4096, 1536, 512, 40, 40, dtype).route == route
    x, wg, wu, wd, gs, dy = bwd_case(cuda, dtype, 96, 8, 96, 64,
                                     [5, 0, 17, 0, 3, 7, 0, 64], 4)
    leaves = [t.clone().requires_grad_(True) for t in (x, wg, wu, wd)]
    before = dict(mg.LAUNCHES)
    y = ops.moe_grouped_ffn(*leaves, gs)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert mg.LAUNCHES["moe_grouped_ffn"] == before["moe_grouped_ffn"] + 1
    assert mg.LAUNCHES["moe_grouped_ffn_bwd"] == \
        before["moe_grouped_ffn_bwd"] + 1
    want = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, None, dy)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sizes", [
    [1, 63, 65, 127, 129, 200, 0, 819],         # no multiple of 32 or 64
    [64, 128, 0, 256, 1, 7, 190, 37],
])
def test_moe_grouped_ffn_bwd_ragged_segments_and_an_empty_expert(cuda,
                                                                 sizes):
    """bf16 at granite's widths over 8 experts: segments off the 32-row
    weights step, the 64-deep k step and the 128-row tile; the expert
    without rows gets weight gradients of exactly zero."""
    T = sum(sizes) + 5
    x, wg, wu, wd, gs, dy = bwd_case(cuda, torch.bfloat16, T, 8, 1536, 512,
                                     sizes, 21)
    got = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, None, dy)
    want = ref.moe_grouped_ffn_bwd_reference(x, wg, wu, wd, gs, None, dy)
    torch.cuda.synchronize()
    assert_bwd_close(got, want, torch.bfloat16, sizes)
    empty = sizes.index(0)
    for grad in got[1:]:
        assert torch.all(grad[empty] == 0)
    assert torch.all(got[0][sum(sizes):] == 0)


def training_case(dev, seed):
    """Training's call at granite's widths: 4096 tokens routed top-8 over
    40 experts, 32768 rows."""
    sizes = routed(4096, 40, 8, seed)
    return sizes, bwd_case(dev, torch.bfloat16, sum(sizes), 40, 1536, 512,
                           sizes, seed)


def test_moe_grouped_ffn_bwd_rows_do_not_depend_on_the_call(cuda):
    """A segment's dx rows in the 32768-row call equal, bitwise, the same
    rows in a call over that segment alone (they sit elsewhere in their
    128-row tiles), and so do its expert's weight gradients (the same
    steps from the segment's start)."""
    sizes, (x, wg, wu, wd, gs, dy) = training_case(cuda, 13)
    full = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, None, dy)
    starts = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    for g in (0, 1, 17, 39):
        lo, hi = starts[g], starts[g + 1]
        alone = [0] * 40
        alone[g] = hi - lo
        part = mg.moe_grouped_ffn_bwd_cuda(
            x[lo:hi].contiguous(), wg, wu, wd,
            torch.tensor(alone, dtype=torch.int32, device=cuda), None,
            dy[lo:hi].contiguous())
        assert torch.equal(part[0], full[0][lo:hi]), g
        for a, b in zip(part[1:], full[1:]):
            assert torch.equal(a[g], b[g]), g


def test_moe_grouped_ffn_bwd_experts_do_not_see_each_other(cuda):
    """At training's shape: changing one expert's rows leaves every other
    expert's weight gradients and every other row's dx bitwise as they
    were."""
    sizes, (x, wg, wu, wd, gs, dy) = training_case(cuda, 14)
    first = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, None, dy)
    lo = sum(sizes[:5])
    hi = lo + sizes[5]
    x2, dy2 = x.clone(), dy.clone()
    x2[lo:hi] = -x2[lo:hi]
    dy2[lo:hi] = 2 * dy2[lo:hi]
    other = mg.moe_grouped_ffn_bwd_cuda(x2, wg, wu, wd, gs, None, dy2)
    keep = [e for e in range(40) if e != 5]
    for a, b in zip(first[1:], other[1:]):
        assert torch.equal(a[keep], b[keep])
        assert not torch.equal(a[5], b[5])
    assert torch.equal(first[0][:lo], other[0][:lo])
    assert torch.equal(first[0][hi:], other[0][hi:])


def test_moe_grouped_ffn_bwd_runs_on_a_fresh_thread(cuda):
    """The bf16 backward encodes its TMA tensor maps in the calling
    thread's context: from a thread that has not touched the card yet (as
    autograd's worker may be when its first work is this backward) it
    gives the same bits as from the main thread."""
    from concurrent.futures import ThreadPoolExecutor

    x, wg, wu, wd, gs, dy = bwd_case(cuda, torch.bfloat16, 96, 8, 96, 64,
                                     [5, 0, 17, 0, 3, 7, 0, 64], 4)
    want = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, None, dy)
    torch.cuda.synchronize()

    def run():
        got = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, None, dy)
        torch.cuda.synchronize()
        return got

    with ThreadPoolExecutor(max_workers=1) as pool:
        got = pool.submit(run).result(timeout=120)   # raises what run raised
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_moe_grouped_ffn_bwd_refuses_what_it_does_not_take(cuda):
    x, wg, wu, wd, gs, dy = bwd_case(cuda, torch.float32, 8, 2, 32, 16,
                                     [3, 5])
    with pytest.raises(ValueError, match="dy"):
        mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, None, dy.bfloat16())
    with pytest.raises(ValueError, match="dy"):
        mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, None, dy[:4])
    with pytest.raises(ValueError, match="int32"):
        mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs.long(), None, dy)



def moe_layer_case(dev, dtype, B, S, seed=0):
    """A MoE layer at granite's smoke widths (d 96, f 64, 8 experts,
    top-2) and its input, weights from ``seed``."""
    import types

    from repro_torch.models.moe import MoEConfig

    cfg = MoEConfig(d_model=96, d_ff=64, n_experts=8, top_k=2)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=gen, device=dev) / shape[-2] ** .5

    p = types.SimpleNamespace(router=w(96, 8), w_gate=w(8, 96, 64).to(dtype),
                              w_up=w(8, 96, 64).to(dtype),
                              w_down=w(8, 64, 96).to(dtype))
    x = torch.randn((B, S, 96), generator=gen, device=dev).to(dtype)
    return cfg, p, x


def moe_layer_grads(fn, p, x):
    import types

    leaves = {n: t.detach().requires_grad_(True) for n, t in vars(p).items()}
    xt = x.detach().requires_grad_(True)
    y = fn(types.SimpleNamespace(**leaves), xt)
    proj = torch.linspace(-1, 1, y.numel(), device=y.device).reshape(y.shape)
    grads = torch.autograd.grad((y.float() * proj).sum(),
                                [xt, *leaves.values()])
    return y.detach(), dict(zip(["x", *leaves], grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_per_row_layout_equals_flat_on_the_card(cuda, dtype):
    """The per-row layout launches the grouped-expert kernels once each
    over B*E groups; its output and input gradient equal the flat
    layout's bit for bit (the kernels' rows do not depend on the call),
    the expert gradients within the backward's tolerance."""
    from repro_torch.models.moe import _moe_dropless

    cfg, p, x = moe_layer_case(cuda, dtype, 3, 40)
    flat_y, flat_g = moe_layer_grads(
        lambda q, h: _moe_dropless(q, h, cfg), p, x)
    mg.reset_launches()
    y, g = moe_layer_grads(
        lambda q, h: _moe_dropless(q, h, cfg, per_row=True), p, x)
    torch.cuda.synchronize()
    assert mg.LAUNCHES == {"moe_grouped_ffn": 1, "moe_grouped_ffn_bwd": 1}
    assert torch.equal(y, flat_y)
    assert torch.equal(g["x"], flat_g["x"])
    assert torch.equal(g["router"], flat_g["router"])
    for name in ("w_gate", "w_up", "w_down"):
        scale = float(flat_g[name].float().abs().max())
        err = float((g[name].float() - flat_g[name].float()).abs().max())
        assert err <= GRAD_TOL[dtype] * scale, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_capacity_on_the_card_repeats_and_matches_the_cpu(cuda, dtype):
    """The capacity dispatch on the card (picks dropped): two runs equal
    bit for bit in the output and every gradient, no grouped-expert
    launch, and the output within the dtype's tolerance of the same layer
    in float64 (which routes as the run does: the router reads x in
    f32)."""
    from repro_torch.models.moe import dropped_picks, moe

    cfg, p, x = moe_layer_case(cuda, dtype, 2, 64, seed=1)
    assert dropped_picks(x, p.router, cfg) > 0
    mg.reset_launches()
    runs = [moe_layer_grads(lambda q, h: moe(q, h, cfg, dispatch="capacity"),
                            p, x) for _ in range(2)]
    torch.cuda.synchronize()
    assert not any(mg.LAUNCHES.values())
    (y1, g1), (y2, g2) = runs
    assert torch.equal(y1, y2)
    assert all(torch.equal(g1[n], g2[n]) for n in g1)
    import types

    p64 = types.SimpleNamespace(router=p.router, **{
        n: getattr(p, n).double() for n in ("w_gate", "w_up", "w_down")})
    with torch.no_grad():
        want = moe(p64, x.double(), cfg, dispatch="capacity")
    tol = TOL[dtype]
    assert torch.allclose(y1.double(), want, atol=tol, rtol=tol)


# ---------------------------------------------------------- flash attention
def flash_case(dev, dtype, B, Sq, Sk, H, K, dh, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Sq, H, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Sk, K, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Sk, K, dh), generator=gen, device=dev).to(dtype)
    do = torch.randn((B, Sq, H, dh), generator=gen, device=dev).to(dtype)
    return q, k, v, do


# Gradients sum up to G * Sq (dK, dV) or Sk (dQ) terms in another order
# than autograd through the plain version: f32 is held to 1e-4.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

FLASH_CASES = [
    # B, Sq, Sk, H, K, dh, causal, window
    (2, 128, 128, 8, 2, 64, True, None),
    (1, 100, 100, 4, 4, 64, True, None),      # not a tile multiple
    (2, 64, 200, 8, 2, 64, True, None),       # Sq < Sk: q_offset > 0
    (1, 100, 40, 4, 2, 64, True, None),       # Sq > Sk: rows that see nothing
    (2, 96, 96, 4, 2, 64, False, None),       # non-causal
    (1, 130, 130, 4, 1, 128, True, None),     # dh 128
    (1, 200, 200, 8, 2, 64, True, 37),        # sliding window
    (1, 70, 90, 4, 2, 64, False, None),       # non-causal, Sq != Sk
    (1, 50, 50, 2, 1, 16, True, None),        # dh 16 (the smoke configs)
    (1, 66, 66, 4, 2, 32, True, 9),           # dh 32 with a window
    (1, 130, 130, 4, 4, 112, True, None),     # dh 112 (zamba2's attention)
    (2, 96, 160, 8, 4, 112, False, None),     # dh 112, non-causal, Sq < Sk
    (1, 200, 200, 8, 2, 64, True, None),      # G = 4, 200 and 257 rows: no
    (1, 257, 257, 8, 2, 64, True, None),      # multiple of any CTA's rows
    (1, 512, 512, 8, 2, 64, True, 100),       # window ends mid-tile
    (1, 300, 100, 8, 2, 64, True, None),      # rows that see no key, dh 64
    (1, 300, 100, 8, 2, 112, True, None),     # and dh 112
    (1, 300, 100, 4, 1, 112, True, 30),       # and under a window
    (2, 130, 130, 4, 4, 80, True, None),      # dh 80 (stablelm_3b)
    (1, 96, 160, 8, 4, 80, False, None),      # dh 80, non-causal, Sq < Sk
    (1, 300, 100, 4, 2, 80, True, 30),        # dh 80, rows that see nothing
    (1, 257, 257, 4, 4, 96, True, None),      # dh 96 (phi3_vision_4_2b)
    (1, 200, 200, 8, 2, 96, True, 37),        # dh 96 under a window
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,K,dh,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, Sq, Sk, H, K,
                                              dh, causal, window):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = flash_case(cuda, dtype, B, Sq, Sk, H, K, dh)
    before = dict(fa.LAUNCHES)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    got = ops.flash_attention(qg, kg, vg, causal=causal, window=window)
    dq, dk, dv = torch.autograd.grad(got, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd"] == \
        before["flash_attention_fwd"] + 1
    assert fa.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = ref.mha_reference(qr, kr, vr, causal=causal, window=window)
    wq, wk, wv = torch.autograd.grad(want, (qr, kr, vr), do)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    for name, a, b in (("dq", dq, wq), ("dk", dk, wk), ("dv", dv, wv)):
        torch.testing.assert_close(a.float(), b.float(),
                                   atol=GRAD_TOL[dtype],
                                   rtol=GRAD_TOL[dtype], msg=name)


def test_flash_attention_backward_is_bitwise_reproducible(cuda):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = flash_case(cuda, torch.bfloat16, 2, 256, 256, 8, 2, 64)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v)
    first = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    second = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dh", [80, 96, 112, 128])
def test_flash_attention_backward_is_bitwise_reproducible_at_wide_heads(
        cuda, dh):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = flash_case(cuda, torch.bfloat16, 2, 300, 300, 8, 2, dh)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v)
    first = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    second = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = flash_case(cuda, torch.float32, 1, 16, 16, 4, 2, 64)
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros((1, 16, 4, 48), device=cuda)
        fa.flash_attention_fwd_cuda(z, z[:, :, :2].contiguous(),
                                    z[:, :, :2].contiguous())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_fwd_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd_cuda(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="is on cpu"):
        fa.flash_attention_fwd_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention_fwd_cuda(q, k[:, :, :1].expand(
            1, 16, 3, 64).contiguous(), v[:, :, :1].expand(
            1, 16, 3, 64).contiguous())


# ----------------------------------------------------------------- SSD scan
def ssd_inputs(dev, dtype, Bc, Q, H, P, N, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((Bc, Q, H, P), generator=gen, device=dev).to(dtype)
    dt = 0.001 + 0.099 * torch.rand((Bc, Q, H), generator=gen, device=dev)
    A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=dev))
    bm = torch.randn((Bc, Q, N), generator=gen, device=dev).to(dtype)
    cm = torch.randn((Bc, Q, N), generator=gen, device=dev).to(dtype)
    return x, dt, A, bm, cm


# The JAX package's SSD sweep (tests/test_kernels.py), chunks shorter than
# a 64-row tile and ragged ones, the zamba2 prefill shape, a state that is
# not a multiple of 16 (nor of 8: rows not 16-byte aligned) and P = 32 at
# the longest chunk.
HYBRID_SSD = (32, 128, 112, 64, 64)
SSD_CASES = [(2, 64, 8, 32, 16), (1, 128, 4, 64, 64), (2, 128, 16, 64, 64),
             (1, 64, 2, 64, 32), (3, 8, 6, 32, 16), (2, 100, 5, 64, 32),
             (1, 256, 4, 64, 64), HYBRID_SSD, (2, 128, 4, 64, 40),
             (2, 256, 8, 32, 64), (2, 72, 3, 32, 13)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bc,Q,H,P,N", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, dtype, Bc, Q, H, P, N):
    """Within 1e-4 of max|y| in both dtypes (the JAX package holds its
    kernel to its model chunk at 1e-4): f32 computes in f32 in another
    order; bf16 inputs are exact, the scores sum in f32 and the weights
    reach the tensor cores as a bf16 hi/lo pair (about 16 bits).  Two
    launches agree bit for bit."""
    args = ssd_inputs(cuda, dtype, Bc, Q, H, P, N)
    before = ss.LAUNCHES["ssd_scan"]
    got = ops.ssd_scan(*args)
    again = ss.ssd_scan_cuda(*args)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == before + 2
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.equal(got, again)
    want = ref.ssd_reference(*args)
    scale = float(want.abs().max()) + 1e-6
    torch.testing.assert_close(got / scale, want / scale, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_chunk_rows_do_not_depend_on_the_call(cuda, dtype):
    """Chunk k's rows of the hybrid prefill's call equal, bit for bit, a
    call of that chunk alone: every output's sum order depends on (Q, N,
    P, dtype) only."""
    x, dt, A, bm, cm = ssd_inputs(cuda, dtype, *HYBRID_SSD)
    full = ss.ssd_scan_cuda(x, dt, A, bm, cm)
    for k in (0, 13, HYBRID_SSD[0] - 1):
        one = ss.ssd_scan_cuda(*(t[k:k + 1].contiguous()
                                 for t in (x, dt)), A,
                               *(t[k:k + 1].contiguous() for t in (bm, cm)))
        assert torch.equal(one[0], full[k]), k


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float32, "simt")])
def test_ssd_kernel_takes_its_route(cuda, dtype, route):
    """bf16 runs on tensor cores and f32 on SIMT: the launcher takes the
    plan's route and refuses the other one for that dtype."""
    args = ssd_inputs(cuda, dtype, 2, 128, 4, 64, 64)
    assert ss.plan(2, 128, 4, 64, 64, dtype).route == route
    y = ss.ssd_scan_cuda(*args)
    block = ss._args(2, 128, 4, 64, 64, dtype)
    bad = ss._Args(*(getattr(block, name) for name, _ in block._fields_))
    bad.route = 1 - bad.route
    err = ss._lib().ssd_scan_launch(
        *(t.data_ptr() for t in args), y.data_ptr(), bad,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, bm, cm = ssd_inputs(cuda, torch.float32, 2, 64, 4, 32, 16)
    with pytest.raises(ValueError, match="head_dim"):
        ss.ssd_scan_cuda(torch.zeros((2, 64, 4, 48), device=cuda), dt, A,
                         bm, cm)
    with pytest.raises(ValueError, match="chunk"):
        z = ssd_inputs(cuda, torch.float32, 1, 300, 4, 32, 16)
        ss.ssd_scan_cuda(*z)
    with pytest.raises(ValueError, match="float32 or"):
        ss.ssd_scan_cuda(x.half(), dt, A, bm.half(), cm.half())
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        ss.ssd_scan_cuda(x.bfloat16(), dt, A, bm, cm)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd_scan_cuda(x.transpose(2, 3).contiguous().transpose(2, 3),
                         dt, A, bm, cm)
    with pytest.raises(ValueError, match="is on cpu"):
        ss.ssd_scan_cuda(x, dt.cpu(), A, bm, cm)
    with pytest.raises(ValueError, match="do not match"):
        ss.ssd_scan_cuda(x, dt, A[:2].contiguous(), bm, cm)


# ------------------------------------------------------------ SSD backward
# Each output's tolerance, as a fraction of its largest entry, by the
# output's dtype: every sum is f32 in both versions, in other orders (bf16
# inputs are exact; on tensor cores the f32 operands dY, W and dS go in as
# bf16 hi/lo pairs, about 16 bits); bf16 dx, dB and dC then round once
# (one bf16 unit is 2^-7 of the value).
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_BWD_CASES = [(2, 64, 8, 32, 16), (3, 72, 6, 32, 13), (2, 100, 5, 64, 32),
                 (1, 256, 4, 64, 128), HYBRID_SSD]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bc,Q,H,P,N", SSD_BWD_CASES)
def test_ssd_backward_kernel_matches_plain(cuda, dtype, Bc, Q, H, P, N):
    """dx, ddt, dA, dB, dC against ``ref.ssd_bwd_reference``, in the
    plain version's dtypes; two calls bitwise equal, one count each."""
    args = ssd_inputs(cuda, dtype, Bc, Q, H, P, N, seed=Q)
    dy = torch.randn(args[0].shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(N))
    before = ss.LAUNCHES["ssd_scan_bwd"]
    got = ss.ssd_scan_bwd_cuda(*args, dy)
    again = ss.ssd_scan_bwd_cuda(*args, dy)
    want = ref.ssd_bwd_reference(*args, dy)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan_bwd"] == before + 2
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.isfinite(g).all()
        assert torch.equal(g, a)
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= \
            SSD_BWD_TOL[g.dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_rows_do_not_depend_on_the_call(cuda, dtype):
    """Chunk row k's dx, ddt, dB and dC in hybrid training's 32-row call
    equal, bit for bit, a call of that row alone (dA sums over the rows)."""
    x, dt, A, bm, cm = ssd_inputs(cuda, dtype, *HYBRID_SSD)
    dy = torch.randn(x.shape, device=cuda)
    full = ss.ssd_scan_bwd_cuda(x, dt, A, bm, cm, dy)
    for k in (0, 13, HYBRID_SSD[0] - 1):
        one = ss.ssd_scan_bwd_cuda(
            *(t[k:k + 1].contiguous() for t in (x, dt)), A,
            *(t[k:k + 1].contiguous() for t in (bm, cm, dy)))
        for i in (0, 1, 3, 4):
            assert torch.equal(one[i][0], full[i][k]), (k, i)


def test_ssd_scan_under_no_grad_launches_the_forward_alone(cuda):
    """Serving's path: under ``no_grad`` ``ops.ssd_scan`` launches the
    forward once and nothing else, with ``ssd_scan_cuda``'s bits; with a
    gradient, the backward once."""
    args = ssd_inputs(cuda, torch.bfloat16, *HYBRID_SSD)
    want = ss.ssd_scan_cuda(*args)
    before = dict(ss.LAUNCHES)
    with torch.no_grad():
        y = ops.ssd_scan(*args)
    torch.cuda.synchronize()
    assert ss.LAUNCHES == {**before, "ssd_scan": before["ssd_scan"] + 1}
    assert y.grad_fn is None and torch.equal(y, want)
    leaves = [t.clone().requires_grad_(True) for t in args]
    y = ops.ssd_scan(*leaves)
    torch.autograd.grad(y.sum(), leaves)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 2
    assert ss.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float32, "simt")])
def test_ssd_backward_takes_its_route(cuda, dtype, route):
    """The backward's bf16 runs on tensor cores and f32 on SIMT: the
    launcher takes the plan's route and refuses the other one for that
    dtype."""
    x, dt, A, bm, cm = ssd_inputs(cuda, dtype, 2, 128, 4, 64, 64)
    dy = torch.randn(x.shape, device=cuda)
    assert ss.plan_bwd(2, 128, 4, 64, 64, dtype).route == route
    dx, ddt, dA, dB, dC = ss.ssd_scan_bwd_cuda(x, dt, A, bm, cm, dy)
    block, p = ss._bwd_args(2, 128, 4, 64, 64, dtype)
    bad = ss._BwdArgs(*(getattr(block, name) for name, _ in block._fields_))
    bad.route = 1 - bad.route
    ds_part, st_part, da_part = (torch.empty(shape, device=cuda) for shape
                                 in (p.scratch, p.st_scratch, (2, 4)))
    err = ss._lib().ssd_scan_bwd_launch(
        *(t.data_ptr() for t in (x, dt, A, bm, cm, dy, dx, ddt, dA, dB, dC,
                                 ds_part, st_part, da_part)),
        bad, torch.cuda.current_stream().cuda_stream)
    assert err != 0


def test_ssd_backward_refuses_what_it_does_not_take(cuda):
    x, dt, A, bm, cm = ssd_inputs(cuda, torch.float32, 2, 64, 4, 32, 16)
    dy = torch.zeros_like(x)
    with pytest.raises(ValueError, match="dy is"):
        ss.ssd_scan_bwd_cuda(x, dt, A, bm, cm, dy.bfloat16())
    with pytest.raises(ValueError, match="dy is"):
        ss.ssd_scan_bwd_cuda(x, dt, A, bm, cm, dy.cpu())
    with pytest.raises(ValueError, match="head_dim"):
        ss.ssd_scan_bwd_cuda(torch.zeros((2, 64, 4, 48), device=cuda), dt,
                             A, bm, cm, torch.zeros((2, 64, 4, 48),
                                                    device=cuda))


def test_hybrid_gradient_on_the_card_matches_the_cpu_plain_path(cuda,
                                                                 monkeypatch):
    """A 2-layer f32 zamba2 at smoke widths (a shared block after each
    layer): ``value_and_grad`` on the card (the SSD and flash kernels,
    remat) against the same weights and batch on the CPU (the plain
    versions) in float64 (the model's f32 islands widened): loss within
    1e-5, each gradient leaf within 3e-3 in norm.  f32 round-off alone
    puts the CPU's own f32 gradient up to 9e-4 from its float64 one at
    this config (``dt_bias``), so the card's f32 cannot be held to 1e-4
    of either."""
    import dataclasses

    import repro_torch.models.layers as tlayers
    import repro_torch.models.ssm as tssm
    from repro_torch.configs import get_smoke
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.train import value_and_grad

    cfg = dataclasses.replace(get_smoke("zamba2_7b"), n_layers=2,
                              attn_every=1, dtype=torch.float32, remat=True)
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    batch = SyntheticLM(cfg.vocab, 256, 2, seed=0).batch_np(0)
    b_cpu = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = dict(ss.LAUNCHES)
    loss, grads = value_and_grad(card, dict(card.named_parameters()),
                                 {k: v.to(cuda) for k, v in b_cpu.items()})
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 4
    assert ss.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 2
    for mod in (tssm, tlayers, ref):
        monkeypatch.setattr(mod, "F32", torch.float64)
    cpu64 = Model(dataclasses.replace(cfg, dtype=torch.float64),
                  device="cpu")
    cpu64.load_state_dict({k: v.double()
                           for k, v in cpu.state_dict().items()})
    want, want_grads = value_and_grad(cpu64, dict(cpu64.named_parameters()),
                                      b_cpu)
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    for name, w in want_grads.items():
        g = grads[name].cpu().double()
        assert float((g - w).norm()) <= 3e-3 * float(w.norm()), name


# ------------------------------------------------------ training placement
def test_arena_placer_moves_tensors_between_hbm_and_pinned_host(cuda):
    from repro_torch.core import ArenaManager, SiteKind, SiteRegistry
    from repro_torch.core.placement import TorchArenaPlacer

    reg = SiteRegistry()
    mgr = ArenaManager(reg, promotion_threshold=1024)
    placer = TorchArenaPlacer(mgr, device="cuda")
    arena = mgr.allocate(reg.register(["m"], SiteKind.OPT_STATE), 2 * 4096)
    x = torch.arange(1024, dtype=torch.float32, device=cuda)
    placer.bind(arena.arena_id, "a", x)
    placer.bind(arena.arena_id, "b", x + 1)
    assert [e.kind for e in placer.entries(arena.arena_id)] == ["device"] * 2
    placer._apply(arena.arena_id, 0.5)
    slow = placer.get(arena.arena_id, "b")
    assert placer.kind(arena.arena_id, "b") == "pinned_host"
    assert not slow.is_cuda and slow.is_pinned()
    assert placer.get(arena.arena_id, "a").is_cuda
    fetched = placer.fetch_fast(arena.arena_id)
    assert fetched["b"].is_cuda and torch.equal(fetched["b"], x + 1)
    placer.writeback(arena.arena_id, {"a": x * 2, "b": fetched["b"] * 3})
    assert placer.get(arena.arena_id, "b") is slow       # its own buffer
    assert torch.equal(slow, ((x + 1) * 3).cpu())
    assert placer.slow_bytes() == placer.fast_bytes() == 4096
    assert placer.transfers_bytes == 3 * 4096


def test_guided_training_on_the_card_offloads_and_is_lossless(cuda):
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.core import GuidanceConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_smoke("llama3_2_1b"), remat=True)
    src = SyntheticLM(cfg.vocab, 64, 2, seed=0)
    data = [{k: torch.from_numpy(v).to(cuda) for k, v in
             src.batch_np(i).items()} for i in range(4)]
    runs = {}
    for name in ("plain", "guided"):
        gdt = None
        if name == "guided":
            gdt = GuidanceConfig(enabled=True, fast_capacity_bytes=2**19,
                                 interval_steps=2, promotion_threshold=1024)
        tr = Trainer(Model(cfg, device="cuda"), AdamW(lr=1e-3),
                     TrainerConfig(steps=4, log_every=1, gdt=gdt, seed=0))
        before = dict(fa.LAUNCHES)
        tr.run(iter(data))
        assert fa.LAUNCHES["flash_attention_fwd"] - \
            before["flash_attention_fwd"] == 4 * 2 * cfg.n_layers
        assert fa.LAUNCHES["flash_attention_bwd"] - \
            before["flash_attention_bwd"] == 4 * cfg.n_layers
        runs[name] = ([m["loss"] for m in tr.metrics_log], tr)
    assert runs["plain"][0] == runs["guided"][0]
    tr = runs["guided"][1]
    assert tr.placer.slow_bytes() > 0 and tr.placer.fast_bytes() > 0
    on_host = [n for n, p in tr.params.items() if not p.is_cuda]
    assert on_host and all(tr.params[n].is_pinned() for n in on_host)
    assert any(not t.is_cuda for t in tr.opt_state.v.values())


# ------------------------------------------- expert cache and prefix cache
def test_expert_prefetch_lands_after_queued_readers(cuda):
    """The write-after-read hazard of a cache written in place: a prefetch
    evicts the slots a grouped FFN still queued behind a long kernel reads.
    Its copy on the side stream must land after that launch, and the
    launch after it reads the prefetched slots after the copy: both
    outputs equal the synchronous path's, bitwise."""
    from repro_torch.core import h100
    from repro_torch.serve import ExpertStore

    L, E, d, f, T = 2, 4, 128, 64, 64
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = {name: (torch.randn((L, E) + shape, generator=gen, device=cuda)
                / shape[0] ** 0.5).to(torch.bfloat16)
         for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                             ("w_down", (f, d)))}
    x = torch.randn((T, d), generator=gen, device=cuda).to(torch.bfloat16)
    first = torch.tensor([32, 32, 0, 0], dtype=torch.int32, device=cuda)
    second = torch.tensor([0, 0, 32, 32], dtype=torch.int32, device=cuda)

    def ffn(store, sizes, slot_map):
        return mg.moe_grouped_ffn_cuda(
            x, store.w_gate_cache, store.w_up_cache, store.w_down_cache,
            sizes, store.upload(slot_map))

    outs = {}
    for db in (False, True):
        store = ExpertStore(w, L, E, 4, hw=h100(), double_buffer=db,
                            device=cuda)
        m0 = store.dispatch(0, first.cpu().numpy(), step=1)
        torch.cuda.synchronize()
        if db:
            torch.cuda._sleep(1 << 30)         # holds the queue ~0.5 s
        y0 = ffn(store, first, m0)
        store.dispatch(1, first.cpu().numpy(), step=1)
        if db:
            assert store.prefetch(1, step=1, predicted=[2, 3]) == 2
            evicted = {store.blocks[(0, e)].slot for e in (0, 1)}
            assert evicted == {None}, "the prefetch took layer 0's slots"
            assert sorted(store._reserved) == sorted(m0[:2].tolist())
        m1 = store.dispatch(1, second.cpu().numpy(), step=2)
        y1 = ffn(store, second, m1)
        torch.cuda.synchronize()
        outs[db] = (y0, y1)
        if db:
            assert store.prefetch_hits == 2 and store.demand_fetches == 4
    assert torch.equal(outs[True][0], outs[False][0])
    assert torch.equal(outs[True][1], outs[False][1])
    want = mg.moe_grouped_ffn_cuda(x, w["w_gate"][0], w["w_up"][0],
                                   w["w_down"][0], first)
    assert torch.equal(outs[True][0], want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [32, 2048])
def test_moe_grouped_ffn_through_a_320_row_cache(cuda, dtype, T):
    """granite's widths: the 40 experts at scattered rows of a 320-row
    array give rows bitwise equal to the 40-row resident call; groups at
    slot -1 give NaN rows and leave every other row untouched; the kernel
    equals the plain version, NaN rows included."""
    E, k, d, f, rows = 40, 8, 1536, 512, 320
    sizes = routed(T // k, E, k, seed=T)
    x, wg, wu, wd, gs = ffn_case(cuda, dtype, T, E, d, f, sizes, seed=T)
    gen = torch.Generator(device=cuda).manual_seed(T + 1)
    where = torch.randperm(rows, generator=gen, device=cuda)[:E]
    bank = []
    for wt in (wg, wu, wd):
        b = torch.randn((rows,) + wt.shape[1:], generator=gen,
                        device=cuda).to(dtype)
        b[where] = wt
        bank.append(b)
    slots = where.to(torch.int32)
    resident = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs)
    assert torch.equal(mg.moe_grouped_ffn_cuda(x, *bank, gs, slots),
                       resident)
    absent = [g for g in range(E) if sizes[g]][::4]
    holes = slots.clone()
    holes[absent] = -1
    got = mg.moe_grouped_ffn_cuda(x, *bank, gs, holes)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    dead = torch.zeros(T, dtype=torch.bool, device=cuda)
    for g in absent:
        dead[int(bounds[g]):int(bounds[g + 1])] = True
    assert torch.isnan(got[dead].float()).all()
    assert torch.equal(got[~dead], resident[~dead])
    want = ref.moe_grouped_ffn_reference(x, *bank, gs, holes)
    assert torch.allclose(got.float(), want.float(), atol=TOL[dtype],
                          rtol=TOL[dtype], equal_nan=True)


def test_tiered_and_prefix_cached_serving_on_the_card(cuda):
    """Smoke widths on the card: tiered experts (double buffering on and
    off) == resident, and prefix-cached == uncached, bitwise streams."""
    from repro_torch.serve import LLM, SamplingParams, ServeConfig

    base = dict(max_batch=2, page_size=4, hbm_pages=32, host_pages=64,
                max_pages_per_seq=16, interval_steps=4)
    shared = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    prompts = [shared + [20 + i] for i in range(3)]
    params = [SamplingParams(max_tokens=6),
              SamplingParams(max_tokens=6, temperature=0.8, seed=7),
              SamplingParams(max_tokens=6)]

    def run(arch, **kw):
        llm = LLM.from_arch(arch, cfg=ServeConfig(**base, **kw), seed=0,
                            device=cuda)
        outs = llm.generate(prompts, params)
        return [o.token_ids for o in outs], llm.stats()

    want, _ = run("granite_moe_3b_a800m")
    for db in (False, True):
        got, st = run("granite_moe_3b_a800m", expert_offchip=True,
                      expert_cache_size=8, expert_double_buffer=db)
        assert got == want and st["expert_evictions"] > 0
        assert (st["expert_prefetch_hits"] > 0) == db
    want, _ = run("llama3_2_1b")
    got, st = run("llama3_2_1b", enable_prefix_cache=True)
    assert got == want and st["saved_prefill_tokens"] == 24


def test_cluster_replicas_crash_and_drain_on_the_card(cuda):
    """Smoke widths on the card: three replicas == one, a crash (cold
    migration) and a drain (warm migration through CPU staging) ==
    the unkilled one-replica run, bitwise streams."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import Model
    from repro_torch.serve import LLM, SamplingParams, ServeConfig

    model = Model(get_smoke("llama3_2_1b"), device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    cfg = ServeConfig(max_batch=2, page_size=4, hbm_pages=16,
                      host_pages=32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, 6).tolist() for _ in range(6)]

    def run(replicas, chaos=None, **kw):
        llm = LLM(model, cfg, replicas=replicas, **kw)
        handles = [llm.submit(p, SamplingParams(
            max_tokens=8, temperature=0.8, top_k=40, seed=100 + i),
            request_id=i) for i, p in enumerate(prompts)]
        if chaos is not None:
            for _ in range(3):
                llm.step()
            chaos(llm.cluster)
        while any(not h.finished for h in handles):
            llm.step()
        return [h.token_ids for h in handles], llm.cluster

    want, _ = run(1)
    assert run(3)[0] == want
    got, cluster = run(3, lambda c: c.fail(0), heartbeat_timeout=2.0)
    assert got == want and cluster.failovers == 1
    assert cluster.migrations_cold > 0

    def drain(c):
        c.drain(0)
        c.remove_replica(0)

    got, cluster = run(3, drain)
    assert got == want and cluster.migrations_warm > 0
    assert cluster.stats()["imported_pages"] > 0


# ------------------------------------- the xLSTM, encoder-decoder and VLM
@pytest.mark.parametrize("arch", ["xlstm_350m", "seamless_m4t_medium",
                                  "phi3_vision_4_2b"])
def test_new_family_on_the_card_matches_the_cpu_plain_path(cuda, arch,
                                                           monkeypatch):
    """A family's f32 smoke model (remat on) on the card, its attention
    through the flash kernels, against the same weights and batch on the
    CPU (the plain versions).  The attention projections are scaled to
    N(0, 1/fan_in) over all the dimensions they contract: at the
    reference's init the scores' deviation is in the tens, the softmax
    saturates, and f32 round-off alone then moves the encoder-decoder's
    gradients by percents, on the CPU as on the card.  The loss within
    1e-5; the prefill logits within 1e-4 of the largest; each gradient
    leaf, the card's and the CPU's, against the CPU's in float64 (the
    model's f32 islands widened), as a fraction of the leaf's largest
    entry: the card's within twice the CPU's on the same leaf plus 1e-4
    (the xLSTM, plain torch on both, has leaves that f32 round-off alone
    moves by several 1e-5).  The flash launches are one a self or cross
    attention (the encoder-decoder's cross ones non-causal), twice under
    remat."""
    import dataclasses

    import repro_torch.models.layers as tlayers
    import repro_torch.models.xlstm as txlstm
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.train import value_and_grad

    cfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32,
                              remat=True)
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            block, leaf = name.split(".")[-2:]
            if block in ("attn", "xattn") and leaf in ("wq", "wk", "wv"):
                p.mul_((p.shape[1] / p.shape[0]) ** 0.5)
            elif block in ("attn", "xattn") and leaf == "wo":
                p.mul_(p.shape[0] ** -0.5)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(1, cfg.vocab, (2, 128), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((2, cfg.frontend_tokens, cfg.d_model),
                                       generator=gen)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, 96, cfg.d_model), generator=gen)
    n_attn = {"xlstm": 0, "vlm": cfg.n_layers,
              "encdec": cfg.enc_layers + 2 * cfg.n_layers}[cfg.family]
    fa.reset_launches()
    loss, grads = value_and_grad(card, dict(card.named_parameters()),
                                 {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention_fwd": 2 * n_attn,
                           "flash_attention_bwd": n_attn}
    cross = cfg.n_layers if cfg.family == "encdec" else 0
    assert fa.NONCAUSAL_LAUNCHES == {"flash_attention_fwd": 2 * cross,
                                     "flash_attention_bwd": cross}
    want, want_grads = value_and_grad(cpu, dict(cpu.named_parameters()),
                                      batch)
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    front = {k: v for k, v in batch.items() if k in ("patches", "frames")}
    S = 128 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    with torch.no_grad():
        got, _ = card.prefill(tokens.to(cuda), card.init_cache(2, S),
                              **{k: v.to(cuda) for k, v in front.items()})
        logits, _ = cpu.prefill(tokens, cpu.init_cache(2, S), **front)
    scale = float(logits.abs().max())
    assert float((got.cpu() - logits).abs().max()) <= 1e-4 * scale
    for mod in (tlayers, txlstm, ref):
        monkeypatch.setattr(mod, "F32", torch.float64)
    cpu64 = Model(dataclasses.replace(cfg, dtype=torch.float64),
                  device="cpu")
    cpu64.load_state_dict({k: v.double()
                           for k, v in cpu.state_dict().items()})
    _, grads64 = value_and_grad(
        cpu64, dict(cpu64.named_parameters()),
        {k: v.double() if v.is_floating_point() else v
         for k, v in batch.items()})
    for name, w in grads64.items():
        scale = max(float(w.abs().max()), 1e-30)
        on_card = float((grads[name].cpu().double() - w).abs().max())
        on_cpu = float((want_grads[name].double() - w).abs().max())
        assert on_card <= (2 * on_cpu + 1e-4 * scale), (
            name, on_card / scale, on_cpu / scale)


# ------------------------------------------- the cost walk, loader, bytes
def small_llama(device, seed=0):
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_smoke("llama3_2_1b"), n_layers=2)
    model = Model(cfg, device=device)
    if device != "meta":
        model.init(torch.Generator(device=device).manual_seed(seed))
    return model


def step_parts(model):
    from repro_torch.convert import jax_order
    from repro_torch.optim import AdamW
    from repro_torch.train.step import make_train_step

    named = dict(model.named_parameters())
    params = {n: named[n] for n in jax_order(named)}
    opt = AdamW(lr=1e-3)
    return params, opt.init(params), make_train_step(model, opt)


def test_step_cost_on_the_card_equals_meta(cuda):
    """The walk of one training step on the card (flash launches inside
    it still counted) counts the flops the walk on ``meta`` counts."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.analysis import cost_of

    counts = {}
    for dev in ("cuda", "meta"):
        model = small_llama(dev)
        params, state, step = step_parts(model)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
            model.cfg.vocab, 256, 2, seed=0).batch_np(0).items()}
        fa.reset_launches()
        counts[dev] = cost_of(step, params, state, batch)
        if dev == "cuda":
            assert fa.LAUNCHES["flash_attention_fwd"] == 2 * 2
            assert fa.LAUNCHES["flash_attention_bwd"] == 2
    assert counts["cuda"]["flops"] == counts["meta"]["flops"]
    assert counts["cuda"]["matmul_flops"] == counts["meta"]["matmul_flops"]


def test_sharded_loader_on_the_card_feeds_the_same_bits(cuda):
    from repro_torch.data import ShardedLoader, SyntheticLM

    src = SyntheticLM(512, 64, 4, seed=3)
    loader = ShardedLoader(src, prefetch=2, device="cuda")
    it = iter(loader)
    got = [next(it) for _ in range(3)]
    loader.close()
    for step, b in enumerate(got):
        for k, v in src.batch_np(step).items():
            assert b[k].is_cuda
            assert torch.equal(b[k].cpu(), torch.from_numpy(v))


def test_dry_run_bytes_equal_the_trainers_state_on_the_card(cuda):
    """Parameters and AdamW moments on a 1 x 1 mesh: the dry run's
    per-device bytes are the bytes the tensors hold on the card."""
    from repro_torch.dist import DEFAULT_RULES, abstract_mesh
    from repro_torch.models.common import sharded_bytes

    model = small_llama("cuda")
    params, state, _ = step_parts(model)
    defs = model.param_defs()
    mesh = abstract_mesh((1, 1), ("data", "model"))
    held = sum(p.numel() * p.element_size() for p in params.values())
    moments = sum(t.numel() * t.element_size()
                  for t in (*state.m.values(), *state.v.values()))
    assert all(t.is_cuda for t in state.m.values())
    assert sharded_bytes(defs, mesh) == held
    assert 2 * sharded_bytes(defs, mesh, dict(DEFAULT_RULES, layers="data"),
                             dtype=torch.float32) == moments


def walkthrough(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_walkthroughs_on_the_card(cuda):
    """The quickstart, the guided-KV serving walkthrough and the
    guided-offload training walkthrough (``--tiny --steps 10``) with
    ``--device cuda``: training launches the flash kernels once a layer a
    step (remat off), serving the paged kernels; the serving policies'
    greedy streams are equal and each moves pages; the losses are
    finite."""
    import math

    from repro_torch.kernels import flash_attention as fa

    def launches():
        return {**pa.LAUNCHES, **fa.LAUNCHES}

    def reset():
        pa.reset_launches()
        fa.reset_launches()

    qs = walkthrough("quickstart_torch")
    reset()
    got = qs.main(["--device", "cuda"])
    n = qs.config().n_layers * got["steps"]
    counts = launches()
    assert counts["flash_attention_fwd"] == n
    assert counts["flash_attention_bwd"] == n
    assert counts["paged_attention"] and counts["paged_prefill"]
    assert all(map(math.isfinite, got["losses"]))
    assert len(got["token_ids"]) == 8

    reset()
    runs = walkthrough("serve_guided_kv_torch").main(["--device", "cuda"])
    assert launches()["paged_attention"] and launches()["paged_prefill"]
    for policy, run in runs.items():
        assert run["streams"] == runs["gdt"]["streams"], policy
        assert run["stats"]["swap_ins"] > 0, policy
        assert run["stats"]["swap_outs"] > 0, policy

    tr = walkthrough("train_guided_offload_torch")
    reset()
    got = tr.main(["--device", "cuda", "--tiny", "--steps", "10"])
    n = tr.make_config(True).n_layers * 10
    assert launches()["flash_attention_fwd"] == n
    assert launches()["flash_attention_bwd"] == n
    assert len(got["losses"]) == 10
    assert all(map(math.isfinite, got["losses"]))
