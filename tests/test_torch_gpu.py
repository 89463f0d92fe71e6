"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a CUDA device every test here skips, and
the module imports no JAX (the card's machine has none).  Run on the card
with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``."""

import pytest
import torch

from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,d,f,sizes,experts", [
    (32, 6, 128, 64, [5, 0, 17, 0, 3, 7], None),
    (45, 4, 96, 40, [7, 20, 0, 11], None),              # 3 rows past sum
    (50, 3, 64, 48, [9, 0, 14, 6, 21], [2, 0, 1, 1, 0]),  # G > E, a map
    (200, 8, 256, 128, [40, 0, 33, 1, 60, 0, 50, 16], None),
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
