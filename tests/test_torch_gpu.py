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
@pytest.mark.parametrize("dh", [64, 128])
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


@pytest.mark.parametrize("dh", [112, 128])
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
