#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device: the card's name, count and power limit.
2. Build: every CUDA source of the port, one nvcc each, started together;
   the build time and ptxas's register and spill report.
3. Kernels: each hand-written kernel against its plain PyTorch version at
   the serving paths' shapes, then timed with CUDA events beside its plain
   version, its bound and a library yardstick where one exists.  Paged
   attention: bf16 and f32, decode and prefill, with and without a window,
   at a wide sweep and at the dense and the MoE path's own shapes (32 and
   24 query heads over 8), prefill rows bitwise equal to decode rows; the
   per-row contract at both serving shapes, bf16 and f32: every prefill
   row equal bit for bit to its decode in batches of 4 and alone (B=1) at
   the 16-token page and 64-key block edges, with no window, a window of
   200 and one of 37 (ending mid-page and mid-block), and with a -1 slot in
   the middle of the table; timed beside
   ``scaled_dot_product_attention`` over K/V gathered contiguously (CUDA
   events, and the device's own time by the profiler).  The
   grouped-expert FFN: decode (32 rows) and prefill (2048 rows) at
   granite's widths, empty groups, a ``group_experts`` map with more groups
   than experts and a slot remap, rows past the segments zero, two launches
   bitwise equal, the first 32 rows of a 2048-row call bitwise equal to the
   same rows alone, and rows of the 2048-row call (the prefill tiles)
   bitwise equal to the same rows in 1-, 4- and 32-row calls (the decode
   tiles); the route each dtype takes (bf16 on tensor cores, f32 on SIMT);
   timed by CUDA events and by the profiler's device time; no single
   PyTorch call computes a grouped SwiGLU, so it has no yardstick.
   Flash attention, forward and backward: bf16 and f32 at the training
   shape (B=2, S=2048, 32/8 heads, dh 64, causal), with a window of 256,
   Sq < Sk, non-causal, dh 128, S=1000 and Sq > Sk; dq, dk, dv against
   autograd through the plain version; two backward runs bitwise equal at
   the training shape and at dh 112; the route each dtype takes (bf16 on
   tensor cores, f32 on SIMT); timed beside
   ``scaled_dot_product_attention`` (forward, backward, and both), by CUDA
   events and by the profiler's device time; and the forward at the
   hybrid prefill's dh 112 (B=4, S=1024, 32/32 heads), checked with the
   others and timed beside SDPA.  The SSD
   intra-chunk kernel: bf16 and f32 against ``ref.ssd_reference`` at the
   JAX package's sweep, short and ragged chunks, the hybrid prefill's (32
   chunks of 128, 112 heads of 64, state 64), states of 40 and 13 (not
   multiples of 16) and P = 32 at Q = 256, within 1e-4 of max|y|, two
   launches bitwise equal; chunks of the hybrid prefill's call equal to
   each chunk alone, bitwise; the route each dtype takes (bf16 on tensor
   cores, f32 on SIMT, the other route refused); timed beside its plain
   version (no single PyTorch call computes it), by CUDA events and by
   the profiler.
4. Dense serving: ``LLM.from_arch("llama3_2_1b", smoke=False).generate`` at
   the published widths in bf16 with random weights: 8 requests of 512
   prompt tokens, KV pages migrating between HBM and pinned host memory
   under the guidance runtime.  The launch counters are zeroed just before
   and read just after.  Then a synchronised breakdown and a profiler pass
   of the same workload (the paged kernels' share of the device's time),
   one-shot prefill == chunked prefill on a 100-token prompt and on a
   300-token one (across the kernel's key-block edges), and an f32 copy
   cut to 2 layers against a plain contiguous forward pass.
5. MoE serving, after the dense model is freed:
   ``LLM.from_arch("granite_moe_3b_a800m", smoke=False).generate`` at the
   published widths (32 layers, 40 experts, top-8) in bf16: 8 requests of
   256 prompt tokens with pages migrating both ways, every expert FFN
   through the grouped-expert kernel (counters zeroed just before, read
   just after); then a synchronised breakdown and a profiler pass of the
   same workload (the grouped-expert and paged kernels' device time,
   launches and share of the busy time, and the device's idle share);
   one-shot == chunked on a 64-token and a 300-token prompt at all 32
   layers;
   an f32 copy cut to 2 layers against a plain forward pass with plain
   routing and combine.
6. Dense training, after serving is freed: ``Trainer`` on
   ``llama3_2_1b`` at the published widths in bf16 with remat and AdamW
   (cosine lr 3e-4), ``SyntheticLM(seed=0)`` batches of 2 x 2048: 8 steps
   unguided, then 8 guided with parameter and moment groups placed between
   HBM and pinned host memory by ``GuidanceRuntime`` (60% of the state
   fits).  Every attention, forward and backward, through the flash
   kernels (counters zeroed just before each run, read just after: 32
   forward and 16 backward launches a step under remat).  The guided
   losses equal the unguided ones to rtol 1e-5.  Then an f32 copy cut to 2
   layers: the kernel path's loss and gradients against a plain path with
   attention through ``mha_reference``, to 1e-4.  Two more unguided steps
   run under the profiler for the device's time by kernel and the flash
   kernels' share of it.
7. Hybrid serving, after training is freed: ``zamba2_7b`` at its
   published widths (81 layers, d_model 3584, 32/32 heads of 112, 112 SSM
   heads of 64, state 64; nothing cut) in bf16 with random weights:
   ``Model.prefill`` of 4 prompts of 1024 tokens, then 32 greedy
   ``Model.decode`` steps, the counters zeroed just before and read just
   after (81 SSD and 13 flash forward launches: one per Mamba2 layer and
   one per shared-attention application).  Then a profiled prefill and
   four profiled decode steps, and an
   f32 copy cut to 7 layers: the kernel path's prefill logits and cache
   against a plain path (``ref.ssd_reference`` per chunk,
   ``ref.mha_reference``), and prefill-then-decode against stepwise decode
   on a 256-token prompt (greedy tokens equal, logits within 2e-3).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --serving-ab PARENT_TREE

serves the workloads of phases 4 and 5, and phase 7's hybrid prefill,
with the port of another checkout (PARENT_TREE, e.g. the parent commit
unpacked with ``git archive``) and with this one, in turns on the same
card: the way to compare serving speeds, which vary with the host from
call to call.

Without a CUDA device, or without the repository beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA datasheet)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# Kernel against plain version, as atol = rtol (the tests' tolerances):
# the two sum in different orders, and bf16 rounds the output.
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
SEED = 0
# Gradients of attention sum up to G * Sq terms in another order than
# autograd through the plain version: f32 is held to 1e-4.
GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SOURCES = {"ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "paged_prefill": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "moe_grouped_ffn": "src/repro_torch/kernels/csrc/moe_gemm.cu",
           "flash_attention_fwd":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_bwd":
               "src/repro_torch/kernels/csrc/flash_attention.cu"}
SOURCES["flash_attention_fwd_dh112"] = SOURCES["flash_attention_fwd"]
REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:113",
            "paged_prefill": "src/repro/kernels/paged_attention.py:95",
            "moe_grouped_ffn": "src/repro/kernels/moe_gemm.py:221",
            "flash_attention_fwd": "src/repro/kernels/flash_attention.py:153",
            "flash_attention_bwd": "src/repro/kernels/flash_attention.py:166",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:65"}
REPLACES["flash_attention_fwd_dh112"] = REPLACES["flash_attention_fwd"]
# flash_attention_fwd_dh112 is the flash forward at zamba2's head dim, its
# launches those of the hybrid prefill.
KERNELS = ("paged_attention", "paged_prefill", "moe_grouped_ffn",
           "flash_attention_fwd", "flash_attention_bwd", "ssd_scan",
           "flash_attention_fwd_dh112")
F32_CHECK_LAYERS = 2
DENSE, MOE, HYBRID = "llama3_2_1b", "granite_moe_3b_a800m", "zamba2_7b"
# The SSD kernel against its plain version: as a fraction of max|y| (the
# JAX package's kernel test scaling), 1e-4 in both dtypes: f32 computes in
# f32 in another order; bf16 inputs are exact and the weights reach the
# tensor cores as a bf16 hi/lo pair (about 16 bits).
SSD_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


class Card:
    """The card's name and power limit, written beside every number."""

    def __init__(self):
        import torch

        self.name = torch.cuda.get_device_name(0)
        self.count = torch.cuda.device_count()
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        self.smi = out.stdout.strip().splitlines()[0]

    def tag(self) -> str:
        return f"[{self.smi}]"


# ------------------------------------------------------------------ timing
def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dev_us(e) -> float:
    """A profiler event's own device microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of what ``fn`` launches, by
    ``torch.profiler`` over ``iters`` calls after 3 warm-ups: the kernels'
    own time, without the host's time to launch them (which ``time_ms``
    includes when the host is the slower of the two)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(dev_us(e) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / iters / 1e3


# ----------------------------------------------------------------- kernels
def paged_case(gen, rows, H, K, dh, P, MP, N, lengths, shared_table, dtype):
    """Random q and pools; a table of shuffled slots per row (or one table
    for every row, as prefill has), -1 past each row's pages."""
    import torch

    dev = "cuda"
    q = torch.randn((rows, H, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((N, P, K, dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((N, P, K, dh), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(N, generator=gen, device=dev).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if shared_table:
        n_pages = -(-max(lengths) // P)
        table = torch.full((MP,), -1, dtype=torch.int32, device=dev)
        table[:n_pages] = perm[:n_pages]
    else:
        table = torch.full((rows, MP), -1, dtype=torch.int32, device=dev)
        used = 0
        for b, length in enumerate(lengths):
            n_pages = -(-length // P)
            table[b, :n_pages] = perm[used:used + n_pages]
            used += n_pages
    return q, kp, vp, table, lens


def bound_ms(q, kp, table, lengths, P) -> tuple:
    """The least time for this work: each input read once (q, the K/V
    pages the rows' lengths reach, each page once), the output written
    once, over HBM bandwidth; and the QK and PV products the rows need
    over the peak rate of their type.  Returns (ms, bound_by)."""
    rows, H, dh = q.shape
    K = kp.shape[2]
    item = q.element_size()
    lens = lengths.tolist()
    tables = table.tolist()
    if table.dim() == 1:
        tables = [tables] * rows
    pages = set()
    ops = 0
    for length, trow in zip(lens, tables):
        pages.update(trow[:-(-length // P)])
        ops += 4 * H * length * dh
    nbytes = 2 * q.numel() * item + len(pages) * 2 * P * K * dh * item
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    dtype = "bfloat16" if item == 2 else "float32"
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_inputs(q, kp, vp, table, lengths, prefill):
    """K/V gathered contiguously per row for the library yardstick."""
    import torch

    P = kp.shape[1]
    if prefill:
        n = int(lengths.max())
        slots = table[: -(-n // P)].long()
        k = kp[slots].reshape(1, -1, kp.shape[2], kp.shape[3])[:, :n]
        v = vp[slots].reshape(1, -1, vp.shape[2], vp.shape[3])[:, :n]
        qq = q[:n][None]
        return (qq.transpose(1, 2), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), None, True)
    B, MP = table.shape
    k = kp[table.clamp(min=0).long()].reshape(B, MP * P, kp.shape[2], -1)
    v = vp[table.clamp(min=0).long()].reshape(B, MP * P, vp.shape[2], -1)
    pos = torch.arange(MP * P, device=q.device)[None, :]
    mask = (pos < lengths[:, None].long())[:, None, None, :]
    return (q[:, :, None, :], k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), mask, False)


# Rows of the per-row contract checked one by one at decode B=1: the key
# block's edges (64), the page's (16), the window's (200, 37) and the ends.
CONTRACT_ROWS = (1, 2, 15, 16, 17, 37, 38, 63, 64, 65, 127, 128, 129, 200,
                 201, 255, 256)


def check_paged_contract(gen, dtype, H, K, MP, N, S, window, hole) -> None:
    """The per-row contract at a serving shape: every row of an S-row
    prefill equals, bit for bit, the decode of the same query, table and
    length, in batches of 4 (the serving ``max_batch``; row t at slot t % 4)
    and alone (B=1) on the block, page and window edges.  ``hole`` puts a -1
    slot in the middle of the table; a window of 37 ends mid-page and
    mid-block.  (The kernel splits no row's keys, so there is no split edge
    to cross.)"""
    import torch

    from repro_torch.kernels import paged_attention as pa

    dh, P = 64, 16
    q, kp, vp, table, lens = paged_case(gen, S, H, K, dh, P, MP, N,
                                        list(range(1, S + 1)), True, dtype)
    if hole:
        table[-(-S // P) // 2] = -1
    pre = pa.paged_prefill_cuda(q, kp, vp, table, lens, window=window)
    tables = table[None].expand(4, -1).contiguous()
    label = (f"{H}/{K} heads S={S} {dtype} window={window} "
             f"hole={hole}")
    for start in range(0, S, 4):
        dec = pa.paged_attention_cuda(q[start:start + 4], kp, vp,
                                      tables[:min(4, S - start)],
                                      lens[start:start + 4], window=window)
        if not torch.equal(dec, pre[start:start + 4]):
            raise AssertionError(f"contract {label}: decode B=4 rows "
                                 f"{start}..{start + 3} differ from prefill")
    for t in (r - 1 for r in CONTRACT_ROWS if r <= S):
        dec = pa.paged_attention_cuda(q[t:t + 1], kp, vp, tables[:1],
                                      lens[t:t + 1], window=window)
        if not torch.equal(dec[0], pre[t]):
            raise AssertionError(f"contract {label}: decode B=1 of row {t} "
                                 f"(length {t + 1}) differs from prefill")
    torch.cuda.synchronize()
    log(f"contract {label}: {S} prefill rows == decode rows bitwise (B=4 "
        f"all rows, B=1 at lengths {[r for r in CONTRACT_ROWS if r <= S]})")


def check_paged_kernels(card) -> dict:
    """Phase 3, paged attention.  Returns its kernel rows of the result
    line (launches filled in by the dense serving phase)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng_lengths = torch.Generator().manual_seed(SEED)
    dh, P = 64, 16

    def ragged(rows, lo, hi):
        return torch.randint(lo, hi + 1, (rows,),
                             generator=rng_lengths).tolist()

    # (label, prefill?, rows, H, K, MP, N, lengths): the sweep at MP=128,
    # then each serving path's own shapes: the dense path's (32/8 heads,
    # max_pages_per_seq=64, hbm_pages=160) and the MoE path's (24/8 heads,
    # max_pages_per_seq=32, hbm_pages=80, one-shot prefill of 256 rows).
    cases = [
        ("decode B=4 MP=128", False, 4, 32, 8, 128, 4096, ragged(4, 1, 2048)),
        ("decode B=32 MP=128", False, 32, 32, 8, 128, 4096,
         ragged(32, 1, 2048)),
        ("prefill S=512 MP=128", True, 512, 32, 8, 128, 4096,
         list(range(1, 481)) + [0] * 32),
        ("decode B=4 dense serving", False, 4, 32, 8, 64, 160,
         ragged(4, 513, 544)),
        ("prefill S=512 dense serving", True, 512, 32, 8, 64, 160,
         list(range(1, 512)) + [0]),
        ("decode B=4 moe serving", False, 4, 24, 8, 32, 80,
         ragged(4, 257, 272)),
        ("prefill S=256 moe serving", True, 256, 24, 8, 32, 80,
         list(range(1, 257))),
    ]
    worst = {"paged_attention": 0.0, "paged_prefill": 0.0}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for window in (None, 200):
            for label, prefill, rows, H, K, MP, N, lengths in cases:
                q, kp, vp, table, lens = paged_case(
                    gen, rows, H, K, dh, P, MP, N, lengths, prefill, dtype)
                if prefill:
                    got = pa.paged_prefill_cuda(q, kp, vp, table, lens,
                                                window=window)
                    want = ref.paged_prefill_reference(q, kp, vp, table,
                                                       lens, window=window)
                    # Row t of prefill == decode of the same query, table
                    # and length, bit for bit.
                    dec = pa.paged_attention_cuda(
                        q, kp, vp, table[None].expand(rows, -1).contiguous(),
                        lens, window=window)
                    if not torch.equal(dec, got):
                        raise AssertionError(
                            f"{label} {dtype_name} window={window}: prefill "
                            f"rows differ from decode rows")
                    name = "paged_prefill"
                else:
                    got = pa.paged_attention_cuda(q, kp, vp, table, lens,
                                                  window=window)
                    want = ref.paged_attention_reference(q, kp, vp, table,
                                                         lens, window=window)
                    name = "paged_attention"
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{label}: non-finite output")
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                tol = TOL[dtype_name]
                if not bool((diff <= tol + tol * want.float().abs()).all()):
                    raise AssertionError(
                        f"{label} {dtype_name} window={window}: max abs err "
                        f"{err} outside atol=rtol={tol}")
                if label.endswith("serving") and dtype == torch.bfloat16 \
                        and window is None:
                    worst[name] = max(worst[name], err)
                log(f"kernel check {name} {label} {dtype_name} "
                    f"window={window}: max abs err {err:.3e} "
                    f"(atol=rtol={tol})")

    # The per-row contract at the two serving shapes (dense: 32/8 heads,
    # MP 64, N 160, S 512; MoE: 24/8, MP 32, N 80, S 256).
    for dtype in (torch.bfloat16, torch.float32):
        for H, MP, N, S in ((32, 64, 160, 512), (24, 32, 80, 256)):
            for window in (None, 200, 37):
                for hole in (False, True):
                    check_paged_contract(gen, dtype, H, 8, MP, N, S, window,
                                         hole)

    rows_out = {}
    for label, prefill, rows, H, K, MP, N, lengths in cases:
        q, kp, vp, table, lens = paged_case(
            gen, rows, H, K, dh, P, MP, N, lengths, prefill, torch.bfloat16)
        if prefill:
            kern = lambda: pa.paged_prefill_cuda(q, kp, vp, table, lens)
            plain = lambda: ref.paged_prefill_reference(q, kp, vp, table,
                                                        lens)
            name = "paged_prefill"
        else:
            kern = lambda: pa.paged_attention_cuda(q, kp, vp, table,
                                                   lens)
            plain = lambda: ref.paged_attention_reference(q, kp, vp,
                                                          table, lens)
            name = "paged_attention"
        sq, sk, sv, mask, causal = sdpa_inputs(q, kp, vp, table, lens,
                                               prefill)
        lib = lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask, is_causal=causal,
            enable_gqa=True)
        ms = time_ms(kern)
        plain_ms = time_ms(plain, iters=10)
        lib_ms = time_ms(lib)
        b_ms, b_by = bound_ms(q, kp, table, lens, P)
        log(f"time {name} {label} bf16: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} "
            f"ms ({b_by}) {card.tag()}")
        log(f"device time {name} {label} bf16 (profiler, launch excluded): "
            f"kernel {device_ms(kern):.4f} ms, sdpa {device_ms(lib):.4f} ms "
            f"{card.tag()}")
        # The result line keeps the dense path's shapes, as in slice 1;
        # the MoE path's times are in the log above.
        if label.endswith("dense serving"):
            rows_out[name] = {
                "name": name, "route": "cuda",
                "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": worst[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}
    return rows_out


def routed_sizes(gen, tokens, E, k):
    """Group sizes of ``tokens`` tokens each routed to k distinct experts
    drawn at random: the decode and prefill shapes of the MoE path."""
    import torch

    picks = torch.rand((tokens, E), generator=gen).argsort(-1)[:, :k]
    return torch.bincount(picks.reshape(-1), minlength=E).tolist()


def moe_case(gen, T, E, d, f, dtype, bank=None):
    """Random rows and expert weights of the model's statistics on the
    card; ``bank`` rows of weights when more rows than experts."""
    import torch

    rows = bank or E
    x = torch.randn((T, d), generator=gen, device="cuda").to(dtype)
    wg = (torch.randn((rows, d, f), generator=gen, device="cuda")
          / math.sqrt(d)).to(dtype)
    wu = (torch.randn((rows, d, f), generator=gen, device="cuda")
          / math.sqrt(d)).to(dtype)
    wd = (torch.randn((rows, f, d), generator=gen, device="cuda")
          / math.sqrt(f)).to(dtype)
    return x, wg, wu, wd


def moe_bound_ms(x, wg, sizes, experts) -> tuple:
    """The least time for this work: x read once, the three weight
    matrices of every expert with at least one row read once, the output
    written once, over HBM bandwidth; and the 6 T d f operations of the
    rows in the segments over the bf16 peak.  Returns (ms, bound_by)."""
    T, d = x.shape
    f = wg.shape[2]
    item = x.element_size()
    used = {experts[g] for g, n in enumerate(sizes) if n > 0}
    nbytes = 2 * x.numel() * item + len(used) * 3 * d * f * item
    rows = min(sum(sizes), T)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * rows * d * f / PEAK_OPS_PER_S["bfloat16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cut_sizes(sizes, lo, hi) -> list:
    """The group sizes of rows [lo, hi) of a call with ``sizes``."""
    out, start = [], 0
    for n in sizes:
        out.append(max(0, min(start + n, hi) - max(start, lo)))
        start += n
    return out


def check_moe_rows(mg, x, wg, wu, wd, sizes, full, dtype_name) -> None:
    """Row invariance at the two routes' tile edges: rows of the 2048-row
    call (the prefill tiles) equal, bitwise, the same rows in 1-, 4- and
    32-row calls (the decode tiles), their groups cut to those rows."""
    import torch

    spans = [(lo, n) for n in (1, 4, 32)
             for lo in (0, 61, 64, 127, 1000, 2048 - n)]
    for lo, n in spans:
        part = mg.moe_grouped_ffn_cuda(
            x[lo:lo + n].contiguous(), wg, wu, wd,
            torch.tensor(cut_sizes(sizes, lo, lo + n), dtype=torch.int32,
                         device="cuda"))
        if not torch.equal(part, full[lo:lo + n]):
            raise AssertionError(
                f"moe {dtype_name}: rows {lo}..{lo + n - 1} of the 2048-row "
                f"call differ from the same rows in a {n}-row call")
    log(f"kernel check moe_grouped_ffn {dtype_name}: rows of the 2048-row "
        f"call == the same rows in 1-, 4- and 32-row calls at rows "
        f"{sorted({lo for lo, _ in spans})}, bitwise")


def check_moe_kernel(card) -> dict:
    """Phase 3, the grouped-expert FFN at granite's widths (d 1536, f 512,
    40 experts, top-8).  Returns its kernel row (launches filled in by the
    MoE serving phase)."""
    import torch

    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    host = torch.Generator().manual_seed(SEED + 2)
    E, k, d, f = 40, 8, 1536, 512
    decode = routed_sizes(host, 4, E, k)                 # T = 32
    prefill = routed_sizes(host, 256, E, k)              # T = 2048
    empty = list(prefill)                                # 6 groups emptied
    for g in (0, 7, 13, 21, 30, 39):
        empty[(g + 1) % E] += empty[g]
        empty[g] = 0
    # 48 groups over the 40 experts' rows (the ep layout's kind of map),
    # and a slot remap: 40 groups whose experts sit permuted in a 48-row
    # bank, as in an expert cache.
    mapped = routed_sizes(host, 256, 48, k)
    map48 = torch.randint(0, E, (48,), generator=host).tolist()
    slots = torch.randperm(48, generator=host)[:E].tolist()
    short = list(prefill)                                # 48 rows past sum
    short[5] = max(short[5] - 48, 0)
    # (label, T, sizes, experts (None: group g = expert g), weight rows)
    cases = [("decode T=32", 32, decode, None, E),
             ("prefill T=2048", 2048, prefill, None, E),
             ("prefill T=2048 6 empty groups", 2048, empty, None, E),
             ("G=48 > E=40 map", 2048, mapped, map48, E),
             ("slot remap into 48 rows", 2048, prefill, slots, 48),
             ("rows past the segments", 2048, short, None, E)]
    worst = 0.0
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for label, T, sizes, experts, bank in cases:
            x, wg, wu, wd = moe_case(gen, T, E, d, f, dtype, bank)
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            ge = None if experts is None else torch.tensor(
                experts, dtype=torch.int32, device="cuda")
            got = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs, ge)
            again = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs, ge)
            want = ref.moe_grouped_ffn_reference(x, wg, wu, wd, gs, ge)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"moe {label}: non-finite output")
            if not torch.equal(got, again):
                raise AssertionError(f"moe {label} {dtype_name}: two "
                                     f"launches differ")
            if not torch.all(got[sum(sizes):] == 0):
                raise AssertionError(f"moe {label}: rows past the segments "
                                     f"are not zero")
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            tol = TOL[dtype_name]
            if not bool((diff <= tol + tol * want.float().abs()).all()):
                raise AssertionError(
                    f"moe {label} {dtype_name}: max abs err {err} outside "
                    f"atol=rtol={tol}")
            if label.startswith("decode") and dtype == torch.bfloat16:
                worst = err
            log(f"kernel check moe_grouped_ffn {label} {dtype_name}: max "
                f"abs err {err:.3e} (atol=rtol={tol}); two launches bitwise "
                f"equal")
            if T == 2048 and experts is None and sizes is prefill:
                # Row invariance: the first 32 rows, alone, with their
                # groups cut to those rows, give the same bits.
                head, left = [], 32
                for n in sizes:
                    head.append(min(n, left))
                    left -= head[-1]
                part = mg.moe_grouped_ffn_cuda(
                    x[:32].contiguous(), wg, wu, wd,
                    torch.tensor(head, dtype=torch.int32, device="cuda"))
                if not torch.equal(part, got[:32]):
                    raise AssertionError(
                        f"moe {dtype_name}: the first 32 rows of a 2048-row "
                        f"call differ from the same rows alone")
                log(f"kernel check moe_grouped_ffn {dtype_name}: first 32 "
                    f"rows of the 2048-row call == the same rows alone, "
                    f"bitwise")
                check_moe_rows(mg, x, wg, wu, wd, sizes, got, dtype_name)
        routes = {T: mg.plan(T, d, f, E, E, dtype).route for T in (32, 2048)}
        log(f"route moe_grouped_ffn {dtype_name}: decode T=32 -> "
            f"{routes[32]}, prefill T=2048 -> {routes[2048]}")

    row = None
    for label, T, sizes in (("prefill T=2048", 2048, prefill),
                            ("decode T=32", 32, decode)):
        x, wg, wu, wd = moe_case(gen, T, E, d, f, torch.bfloat16)
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        ms = time_ms(lambda: mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs))
        dev = device_ms(lambda: mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs))
        plain_ms = time_ms(lambda: ref.moe_grouped_ffn_reference(
            x, wg, wu, wd, gs), iters=10)
        b_ms, b_by = moe_bound_ms(x, wg, sizes, list(range(E)))
        log(f"time moe_grouped_ffn {label} bf16 ({sum(n > 0 for n in sizes)}"
            f" experts with rows): kernel {ms:.4f} ms (events), device "
            f"{dev:.4f} ms (profiler), plain {plain_ms:.4f} ms, library "
            f"none, bound {b_ms:.5f} ms ({b_by}) {card.tag()}")
        row = {"name": "moe_grouped_ffn", "route": "cuda",
               "source": SOURCES["moe_grouped_ffn"],
               "replaces": REPLACES["moe_grouped_ffn"], "launches": 0,
               "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return row



def flash_bound_ms(B, Sq, Sk, H, K, dh, causal, item, backward) -> tuple:
    """The least time for this work: the inputs read once and the outputs
    written once over HBM bandwidth (forward: q, k, v in, out and the f32
    log-sum-exp out; backward: q, k, v, out, dout and lse in, dq, dk, dv
    out); and the products over the bf16 peak: 4 B H Sq Sk dh operations,
    half of them under a causal mask, and about 2.5 times that for the
    backward.  Returns (ms, bound_by)."""
    q_bytes = B * Sq * H * dh * item
    kv_bytes = B * Sk * K * dh * item
    lse_bytes = B * H * Sq * 4
    ops = (2 if causal else 4) * B * H * Sq * Sk * dh
    if backward:
        nbytes = 3 * q_bytes + 2 * kv_bytes + lse_bytes + q_bytes + 2 * kv_bytes
        ops = 2.5 * ops
    else:
        nbytes = q_bytes + 2 * kv_bytes + q_bytes + lse_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash_kernel(card) -> dict:
    """Phase 3, flash attention forward and backward against the plain
    version and its autograd gradients, then timed at the training shape.
    Returns its two kernel rows (launches filled in by the training
    phase)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def case(B, Sq, Sk, H, K, dh, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((B, Sq, H, dh), (B, Sk, K, dh), (B, Sk, K, dh),
                              (B, Sq, H, dh))]

    def within(got, want, tol):
        want = want.detach()
        diff = (got.float() - want.float()).abs()
        ok = bool((diff <= tol + tol * want.float().abs()).all())
        return ok, float(diff.max())

    # (label, B, Sq, Sk, H, K, dh, causal, window)
    train = (2, 2048, 2048, 32, 8, 64)
    worst_112 = 0.0
    cases = [("training shape", *train, True, None),
             ("training shape, window 256", *train, True, 256),
             ("Sq=512 < Sk=2048", 2, 512, 2048, 32, 8, 64, True, None),
             ("non-causal S=1024", 1, 1024, 1024, 32, 8, 64, False, None),
             ("dh=128 S=1024", 1, 1024, 1024, 16, 4, 128, True, None),
             ("S=1000", 2, 1000, 1000, 32, 8, 64, True, None),
             ("Sq=1000 > Sk=300", 1, 1000, 300, 32, 8, 64, True, None),
             ("dh=112 hybrid prefill", *HYBRID_ATTN, True, None)]
    worst = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for dh in sorted({c[6] for c in cases}):
            p = fa.plan(*train[:5], dh, dtype)
            log(f"flash route {dtype_name} dh={dh}: {p.route} (forward "
                f"{p.rows_per_cta} rows over {p.warps} warps, dK/dV steps "
                f"of {p.bwd_rows} rows, {p.stages} stage(s), shared "
                f"{p.fwd_smem}/{p.dkdv_smem}/{p.dq_smem} bytes)")
        for label, B, Sq, Sk, H, K, dh, causal, window in cases:
            q, k, v, do = case(B, Sq, Sk, H, K, dh, dtype)
            out, lse = fa.flash_attention_fwd_cuda(q, k, v, causal, window)
            dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                     causal, window)
            qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
            want = ref.mha_reference(qr, kr, vr, causal=causal,
                                     window=window)
            grads = torch.autograd.grad(want, (qr, kr, vr), do)
            torch.cuda.synchronize()
            for t in (out, dq, dk, dv):
                if not torch.isfinite(t).all():
                    raise AssertionError(f"flash {label} {dtype_name}: "
                                         f"non-finite output")
            ok, err = within(out, want, TOL[dtype_name])
            if not ok:
                raise AssertionError(
                    f"flash forward {label} {dtype_name}: max abs err {err} "
                    f"outside atol=rtol={TOL[dtype_name]}")
            errs = []
            for name, got, ref_grad in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                           grads):
                ok, e = within(got, ref_grad, GRAD_TOL[dtype_name])
                if not ok:
                    raise AssertionError(
                        f"flash backward {label} {dtype_name}: {name} max "
                        f"abs err {e} outside atol=rtol="
                        f"{GRAD_TOL[dtype_name]}")
                errs.append(e)
            if label.startswith("dh=112") and dtype == torch.bfloat16:
                worst_112 = err
            if label == "training shape" and dtype == torch.bfloat16:
                worst["flash_attention_fwd"] = err
                worst["flash_attention_bwd"] = max(errs)
            if dtype == torch.bfloat16 and (
                    label == "training shape" or label.startswith("dh=112")):
                again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                    causal, window)
                if not all(torch.equal(a, b)
                           for a, b in zip(again, (dq, dk, dv))):
                    raise AssertionError(f"flash backward {label}: two runs "
                                         f"differ")
                log(f"kernel check flash_attention_bwd {label} bfloat16: "
                    f"two backward runs bitwise equal")
            log(f"kernel check flash_attention {label} {dtype_name}: "
                f"forward max abs err {err:.3e} (atol=rtol="
                f"{TOL[dtype_name]}), dq/dk/dv "
                f"{'/'.join(f'{e:.3e}' for e in errs)} (atol=rtol="
                f"{GRAD_TOL[dtype_name]})")
            del q, k, v, do, out, lse, dq, dk, dv, qr, kr, vr, want, grads

    B, S, _, H, K, dh = train
    q, k, v, do = case(B, S, S, H, K, dh, torch.bfloat16)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    plain_out = ref.mha_reference(qr, kr, vr)
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dos = do.transpose(1, 2).contiguous()
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)

    def sdpa_both():
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)
        torch.autograd.grad(o, (qs, ks, vs), dos)

    def plain_fwd():
        with torch.no_grad():
            ref.mha_reference(q, k, v)

    times = {
        "flash_attention_fwd": (
            time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v)),
            time_ms(plain_fwd, iters=10), time_ms(sdpa_fwd)),
        "flash_attention_bwd": (
            time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse,
                                                        do)),
            time_ms(lambda: torch.autograd.grad(
                plain_out, (qr, kr, vr), do, retain_graph=True), iters=10),
            time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qs, ks, vs), dos, retain_graph=True))),
    }
    both_ms = time_ms(sdpa_both)
    # The device's own time by the profiler: SDPA's backward event time
    # moves with the host from call to call.
    dev = {
        "flash_attention_fwd": (
            device_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v)),
            device_ms(sdpa_fwd)),
        "flash_attention_bwd": (
            device_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse,
                                                          do)),
            device_ms(lambda: torch.autograd.grad(
                sdpa_out, (qs, ks, vs), dos, retain_graph=True))),
    }
    rows = {}
    for name, (ms, plain_ms, lib_ms) in times.items():
        b_ms, b_by = flash_bound_ms(B, S, S, H, K, dh, True, 2,
                                    name.endswith("bwd"))
        log(f"time {name} B={B} S={S} {H}/{K} heads dh={dh} causal bf16: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}) {card.tag()}")
        log(f"device time {name} B={B} S={S} {H}/{K} heads dh={dh} causal "
            f"bf16 (profiler, launch excluded): kernel {dev[name][0]:.4f} "
            f"ms, sdpa {dev[name][1]:.4f} ms {card.tag()}")
        rows[name] = {"name": name, "route": "cuda",
                      "source": SOURCES[name], "replaces": REPLACES[name],
                      "launches": 0, "max_abs_err": worst[name], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib_ms}
    log(f"time flash_attention forward + backward: kernels "
        f"{times['flash_attention_fwd'][0] + times['flash_attention_bwd'][0]:.4f}"
        f" ms, sdpa forward + backward {both_ms:.4f} ms {card.tag()}")
    del q, k, v, do, out, lse, qr, kr, vr, plain_out, qs, ks, vs, sdpa_out

    # The hybrid prefill's shared attention: the forward at dh 112.
    B, S, _, H, K, dh = HYBRID_ATTN
    q, k, v, _ = case(B, S, S, H, K, dh, torch.bfloat16)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def plain_112():
        with torch.no_grad():
            ref.mha_reference(q, k, v)

    def sdpa_112():
        with torch.no_grad():
            F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    ms = time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v))
    plain_ms = time_ms(plain_112, iters=10)
    lib_ms = time_ms(sdpa_112)
    b_ms, b_by = flash_bound_ms(B, S, S, H, K, dh, True, 2, False)
    log(f"time flash_attention_fwd B={B} S={S} {H}/{K} heads dh={dh} causal "
        f"bf16 (hybrid prefill): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}) "
        f"{card.tag()}")
    log(f"device time flash_attention_fwd B={B} S={S} {H}/{K} heads dh={dh} "
        f"causal bf16 (profiler, launch excluded): kernel "
        f"{device_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v)):.4f} ms, "
        f"sdpa {device_ms(sdpa_112):.4f} ms {card.tag()}")
    name = "flash_attention_fwd_dh112"
    rows[name] = {"name": name, "route": "cuda", "source": SOURCES[name],
                  "replaces": REPLACES[name], "launches": 0,
                  "max_abs_err": worst_112, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    del q, k, v, qs, ks, vs
    free_card()
    return rows


# (B, S, S, H, K, dh) of the hybrid prefill's shared attention: 4 prompts
# of 1024 tokens, zamba2's 32/32 heads of 112.
HYBRID_ATTN = (4, 1024, 1024, 32, 32, 112)
# The hybrid prefill's SSD call: 4 x 1024 tokens in chunks of 128, 112
# heads of 64, state 64.
HYBRID_SSD = (32, 128, 112, 64, 64)


def ssd_case(gen, Bc, Q, H, P, N, dtype):
    """x, dt, A, B, C of the model's statistics: dt in [0.001, 0.1], A in
    [-2, -0.5] (the JAX kernel test's ranges)."""
    import torch

    x = torch.randn((Bc, Q, H, P), generator=gen, device="cuda").to(dtype)
    dt = 0.001 + 0.099 * torch.rand((Bc, Q, H), generator=gen,
                                    device="cuda")
    A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device="cuda"))
    bm = torch.randn((Bc, Q, N), generator=gen, device="cuda").to(dtype)
    cm = torch.randn((Bc, Q, N), generator=gen, device="cuda").to(dtype)
    return x, dt, A, bm, cm


def ssd_bound_ms(x, dt, A, bm) -> tuple:
    """The least time for this work: x, dt, A, B and C read once and the
    f32 y written once over HBM bandwidth; and the causal pairs' work over
    the peak rate of x's type: per chunk row Q(Q+1)/2 pairs of an N-long
    score (2N) and, per head, a weight (2) and a P-long product (2P).
    Returns (ms, bound_by)."""
    Bc, Q, H, P = x.shape
    N = bm.shape[-1]
    item = x.element_size()
    nbytes = (x.numel() * item + dt.numel() * 4 + A.numel() * 4
              + 2 * bm.numel() * item + x.numel() * 4)
    ops = Bc * Q * (Q + 1) // 2 * (2 * N + H * (2 * P + 2))
    dtype = "bfloat16" if item == 2 else "float32"
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_ssd_chunks(ss, args, dtype_name) -> None:
    """Chunk k's rows of a call equal, bit for bit, a call of that chunk
    alone (first, middle and last chunk)."""
    import torch

    x, dt, A, bm, cm = args
    full = ss.ssd_scan_cuda(*args)
    chunks = (0, x.shape[0] // 2, x.shape[0] - 1)
    for k in chunks:
        one = ss.ssd_scan_cuda(x[k:k + 1].contiguous(),
                               dt[k:k + 1].contiguous(), A,
                               bm[k:k + 1].contiguous(),
                               cm[k:k + 1].contiguous())
        if not torch.equal(one[0], full[k]):
            raise AssertionError(f"ssd {tuple(x.shape)} {dtype_name}: chunk "
                                 f"{k} alone differs from its rows in the "
                                 f"{x.shape[0]}-chunk call")
    log(f"kernel check ssd_scan {dtype_name}: chunks {chunks} of the "
        f"{x.shape[0]}-chunk call == each chunk alone (Bc=1), bitwise")


def check_ssd_route(ss, dtype, dtype_name) -> None:
    """bf16 on tensor cores, f32 on SIMT: the plan's route, and the
    launcher refuses the other route for that dtype."""
    import torch

    want = "mma" if dtype == torch.bfloat16 else "simt"
    shape = (2, 128, 4, 64, 64)
    p = ss.plan(*shape, dtype)
    if p.route != want:
        raise AssertionError(f"ssd {dtype_name}: route {p.route}, expected "
                             f"{want}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    args = ssd_case(gen, *shape, dtype)
    y = ss.ssd_scan_cuda(*args)
    block = ss._args(*shape, dtype)
    other = ss._Args(*(getattr(block, name) for name, _ in block._fields_))
    other.route = 1 - other.route
    err = ss._lib().ssd_scan_launch(
        *(t.data_ptr() for t in args), y.data_ptr(), other,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err == 0:
        raise AssertionError(f"ssd {dtype_name}: the launcher took the "
                             f"{'simt' if want == 'mma' else 'mma'} route")
    log(f"route ssd_scan {dtype_name}: {p.route} (head group "
        f"{p.head_group}, {p.warps} warps, key block {p.key_block}, k step "
        f"{p.k_step}, {p.stages} stages, {p.smem} bytes of shared memory); "
        f"the other route refused (CUDA error {err})")


def check_ssd_kernel(card) -> dict:
    """Phase 3, the SSD intra-chunk kernel against ``ref.ssd_reference``
    at the JAX package's sweep, short and ragged chunks, the hybrid
    prefill shape, a state not a multiple of 16 (nor of 8) and P = 32 at
    Q = 256, bf16 and f32; two launches bitwise equal; each chunk of the
    hybrid prefill's call equal to the chunk alone; the route each dtype
    takes; then timed at the hybrid prefill shape.  Returns its kernel row
    (launches filled in by the hybrid serving phase)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cases = [(2, 64, 8, 32, 16), (1, 128, 4, 64, 64), (2, 128, 16, 64, 64),
             (1, 64, 2, 64, 32), (3, 8, 6, 32, 16), (2, 100, 5, 64, 32),
             (1, 256, 4, 64, 64), HYBRID_SSD, (2, 128, 4, 64, 40),
             (2, 256, 8, 32, 64), (2, 72, 3, 32, 13)]
    worst = 0.0
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        check_ssd_route(ss, dtype, dtype_name)
        for shape in cases:
            args = ssd_case(gen, *shape, dtype)
            got = ss.ssd_scan_cuda(*args)
            again = ss.ssd_scan_cuda(*args)
            want = ref.ssd_reference(*args)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"ssd {shape}: non-finite output")
            if not torch.equal(got, again):
                raise AssertionError(f"ssd {shape} {dtype_name}: two "
                                     f"launches differ")
            scale = float(want.abs().max()) + 1e-6
            diff = (got - want).abs() / scale
            err = float(diff.max())
            if not bool((diff <= SSD_TOL + SSD_TOL * want.abs()
                         / scale).all()):
                raise AssertionError(
                    f"ssd {shape} {dtype_name}: max err {err} of max|y| "
                    f"{scale} outside atol=rtol={SSD_TOL}")
            if shape == HYBRID_SSD and dtype == torch.bfloat16:
                worst = err * scale
            log(f"kernel check ssd_scan (Bc, Q, H, P, N)={shape} "
                f"{dtype_name}: max abs err {err * scale:.3e}, {err:.3e} of "
                f"max|y| {scale:.3e} (atol=rtol={SSD_TOL}); two launches "
                f"bitwise equal")
            if shape == HYBRID_SSD:
                check_ssd_chunks(ss, args, dtype_name)
            del args, got, again, want, diff

    args = ssd_case(gen, *HYBRID_SSD, torch.bfloat16)
    ms = time_ms(lambda: ss.ssd_scan_cuda(*args))
    dev = device_ms(lambda: ss.ssd_scan_cuda(*args))
    plain_ms = time_ms(lambda: ref.ssd_reference(*args), iters=10)
    b_ms, b_by = ssd_bound_ms(*args[:4])
    p = ss.plan(*HYBRID_SSD, torch.bfloat16)
    log(f"time ssd_scan (Bc, Q, H, P, N)={HYBRID_SSD} bf16 (hybrid "
        f"prefill; {p.route}, {p.blocks} blocks of {p.head_group} heads): "
        f"kernel {ms:.4f} ms (events), device {dev:.4f} ms (profiler), "
        f"plain {plain_ms:.4f} ms, library none, bound {b_ms:.5f} ms "
        f"({b_by}) {card.tag()}")
    del args
    free_card()
    return {"name": "ssd_scan", "route": "cuda",
            "source": SOURCES["ssd_scan"], "replaces": REPLACES["ssd_scan"],
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


# ----------------------------------------------------------------- serving
def plain_moe(moe, h, cfg):
    """A plain MoE FFN for (S, d) rows: f32 router logits, softmax,
    ``torch.topk``, renormalised gates, and per expert a SwiGLU over the
    tokens that picked it, added gate-weighted into an f32 sum."""
    import torch

    f32 = torch.float32
    hf = h.to(f32)
    probs = (hf @ moe.router).softmax(-1)[:, :cfg.n_experts]
    gates, experts = probs.topk(cfg.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros(hf.shape, dtype=f32, device=h.device)
    for e in experts.unique().tolist():
        tok, slot = (experts == e).nonzero(as_tuple=True)
        xe = hf[tok]
        y = (torch.nn.functional.silu(xe @ moe.w_gate[e].to(f32))
             * (xe @ moe.w_up[e].to(f32))) @ moe.w_down[e].to(f32)
        out[tok] += gates[tok, slot, None] * y.to(h.dtype).to(f32)
    return out.to(h.dtype)


def forward_reference(model, tokens):
    """Logits of the last position of ``tokens`` by a plain contiguous
    forward pass: no pages, attention as an explicit masked softmax, the
    FFN a plain SwiGLU or ``plain_moe``."""
    import torch

    from repro_torch.models.layers import rope, rope_freqs

    cfg = model.cfg
    H, K, dh = cfg.n_heads, cfg.kv_heads, model.head_dim
    G = H // K
    f32 = torch.float32

    def norm(scale, x):
        xf = x.to(f32)
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
        return (y * scale.to(f32)).to(x.dtype)

    t = torch.tensor(tokens, device=model.device)
    S = t.shape[0]
    pos = torch.arange(S, device=model.device)
    x = model.embed.tok[t]
    causal = pos[None, :] <= pos[:, None]
    freqs = rope_freqs(dh, cfg.rope_theta, model.device)
    for lp in model.layers:
        a = lp.attn
        h = norm(lp.ln1.scale, x)
        q = rope(torch.einsum("sd,dhk->shk", h, a.wq), pos, freqs)
        k = rope(torch.einsum("sd,dhk->shk", h, a.wk), pos, freqs)
        v = torch.einsum("sd,dhk->shk", h, a.wv)
        qg = q.reshape(S, K, G, dh).to(f32)
        s = torch.einsum("qkgd,skd->kgqs", qg, k.to(f32)) / math.sqrt(dh)
        s = s.masked_fill(~causal, -1e30)
        o = torch.einsum("kgqs,skd->qkgd", s.softmax(-1), v.to(f32))
        o = o.reshape(S, H, dh).to(x.dtype)
        x = x + torch.einsum("shk,hkd->sd", o, a.wo)
        h2 = norm(lp.ln2.scale, x)
        if model.moe_cfg is not None:
            x = x + plain_moe(lp.moe, h2, model.moe_cfg)
            continue
        g = h2 @ lp.mlp.w_gate
        u = h2 @ lp.mlp.w_up
        x = x + (torch.nn.functional.silu(g.to(f32)).to(x.dtype) * u) \
            @ lp.mlp.w_down
    x = norm(model.final_ln.scale, x)
    return (x[-1] @ model.head.w).to(f32)


def where_time_goes(card, arch, cfg, prompts, params, main_wall,
                    shares) -> None:
    """The serving workload twice more on fresh engines.  First with the
    engine's layers of work timed on the host clock, the device
    synchronised around each (which slows the run a little); eviction is
    the ranking of pages to demote, host work only.  Then under
    ``torch.profiler`` for the device's time by kernel; the device's busy
    time over the main run's wall time gives its idle share there (the
    profiler slows the host, not the kernels).  ``shares``: (what, needle)
    pairs, each kernel family whose device time, launches and share of the
    busy time are logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import LLM

    def fresh():
        return LLM.from_arch(arch, smoke=False, cfg=cfg, seed=SEED,
                             device="cuda")

    llm = fresh()
    eng = llm.engine
    spent = {}
    inside = []

    def timed(obj, attr, label):
        fn = getattr(obj, attr)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            inside.append(label)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                inside.pop()
                dt = time.perf_counter() - t
                spent[label] = spent.get(label, 0.0) + dt
                if label == "migration" and "guidance" in inside:
                    spent["guidance"] = spent.get("guidance", 0.0) - dt

        setattr(obj, attr, wrapper)

    timed(eng, "_prefill", "prefill forward")
    timed(eng, "_decode", "decode forward")
    for attr in ("exchange", "swap_in_many", "swap_out_many"):
        timed(eng.pool, attr, "migration")
    timed(eng.runtime, "on_step", "guidance")
    timed(eng.eviction, "pick_many", "eviction")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llm.generate(prompts, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rest = wall - sum(spent.values())
    parts = ", ".join(f"{k} {v:.3f} s ({100 * v / wall:.1f}%)"
                      for k, v in sorted(spent.items(), key=lambda kv: -kv[1]))
    log(f"breakdown {arch} (synchronised run, {wall:.3f} s): {parts}, rest "
        f"of the engine {rest:.3f} s ({100 * rest / wall:.1f}%) "
        f"{card.tag()}")
    del llm, eng

    llm = fresh()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        llm.generate(prompts, params)
        torch.cuda.synchronize()
    # Device-side events only (kernels and copies): an operator's own
    # entry repeats the time of the kernels it launched.
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]

    busy = sum(dev_us(e) for e in events) / 1e6
    log(f"device {arch}: kernels and copies busy {busy:.3f} s, "
        f"{100 * busy / main_wall:.1f}% of the main run's {main_wall:.3f} s: "
        f"idle share {100 * (1 - busy / main_wall):.1f}% {card.tag()}")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        log(f"  device {dev_us(e) / 1e3:10.2f} ms  calls {e.count:7d}  "
            f"{e.key[:90]}")
    for what, needle in shares:
        log_kernel_share(card, arch, events, busy, what, needle)
    del llm
    free_card()


def log_kernel_share(card, label, events, busy, what, needle) -> None:
    """The device time of the profiled kernels whose name holds
    ``needle``, their launches and their share of the busy time."""
    mine = [e for e in events if needle in e.key]
    secs = sum(dev_us(e) for e in mine) / 1e6
    log(f"device {label}: {what} kernels {secs:.4f} s over "
        f"{sum(e.count for e in mine)} launches, {100 * secs / busy:.1f}% "
        f"of the busy time {card.tag()}")


def free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def kernel_modules():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ss

    return pa, mg, fa, ss


def reset_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


def read_launches() -> dict:
    out = {}
    for mod in kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def main_run(card, arch, cfg, n_req, n_prompt, n_new, rng):
    """The main path: ``LLM.from_arch(arch, smoke=False).generate`` on 8
    requests (request 3 sampled), launch counters zeroed just before and
    read just after.  Returns (llm, prompts, params, wall, launches)."""
    import torch

    from repro_torch.serve import LLM, SamplingParams

    t0 = time.perf_counter()
    llm = LLM.from_arch(arch, smoke=False, cfg=cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    mc = llm.engine.model.cfg
    moe = (f", {mc.n_experts} experts top-{mc.top_k}"
           if mc.family == "moe" else "")
    log(f"model {arch}: {mc.n_layers} layers, d_model {mc.d_model}, "
        f"{mc.n_heads}/{mc.kv_heads} heads, d_ff {mc.d_ff}{moe}, vocab "
        f"{mc.vocab}, {mc.dtype}; page {llm.engine.pool.page_bytes} bytes; "
        f"built in {time.perf_counter() - t0:.1f} s")
    prompts = [rng.integers(0, mc.vocab, n_prompt).tolist()
               for _ in range(n_req)]
    params = [SamplingParams(max_tokens=n_new) for _ in range(n_req)]
    params[3] = SamplingParams(max_tokens=n_new, temperature=0.8, top_k=40,
                               top_p=0.9, seed=7)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = llm.generate(prompts, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = llm.stats()
    for o in outs:
        if len(o.token_ids) != n_new or o.finish_reason != "length":
            raise AssertionError(
                f"{arch} request {o.request_id}: {len(o.token_ids)} tokens, "
                f"finish {o.finish_reason}")
    if not (st["swap_outs"] > 0 and st["swap_ins"] > 0):
        raise AssertionError(f"{arch}: no migration both ways: {st}")
    runtime = llm.engine.runtime
    if not runtime.history:
        raise AssertionError(f"{arch}: the guidance runtime recorded no "
                             f"interval")
    L = mc.n_layers
    need = {"paged_attention": L * st["decode_dispatches"],
            "paged_prefill": L * st["prefill_dispatches"]}
    if mc.family == "moe":
        need["moe_grouped_ffn"] = L * (st["decode_dispatches"]
                                       + st["prefill_dispatches"])
    for name, n in need.items():
        if launches[name] < n or launches[name] == 0:
            raise AssertionError(f"{arch} {name}: {launches[name]} launches "
                                 f"< {n} (layers x dispatches)")
    tokens = n_req * n_new
    log(f"serving {arch}: {n_req} requests x {n_prompt} prompt + {n_new} new "
        f"tokens in {wall:.3f} s: {tokens / wall:.2f} generated tokens/s, "
        f"{(n_req * n_prompt + tokens) / wall:.1f} tokens/s in all, "
        f"{1e3 * wall / st['steps']:.2f} ms per engine step "
        f"({st['steps']} steps) {card.tag()}")
    log(f"serving {arch}: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB {card.tag()}")
    log(f"serving {arch}: swap_ins {st['swap_ins']}, swap_outs "
        f"{st['swap_outs']}, transfer_events {st['transfer_events']}, "
        f"bytes_moved {st['bytes_moved']}, preemptions {st['preemptions']}, "
        f"prefill_dispatches {st['prefill_dispatches']}, decode_dispatches "
        f"{st['decode_dispatches']}, intervals {len(runtime.history)}, "
        f"launches {launches}")
    return llm, prompts, params, wall, launches


def one_shot_equals_chunked(model, prompt) -> None:
    """One-shot == chunked prefill at full width, bitwise in the stream and
    in every decode step's logits: the projections' row tiles and the
    kernels' per-row orders make them equal.  32 HBM pages hold the
    300-token prompt and its 8 new tokens (20 pages)."""
    import numpy as np

    from repro_torch.serve import Engine, ServeConfig

    streams = {}
    for mode in ("one_shot", "chunked"):
        eng = Engine(model, ServeConfig(max_batch=4, page_size=16,
                                        hbm_pages=32, host_pages=16,
                                        prefill=mode, keep_logits=True))
        eng.add_request(0, prompt, max_new=8)
        rows = []
        while eng.requests:
            eng.step()
            rows.extend(eng.last_logits.values())
        streams[mode] = (eng.finished[0].generated, rows)
    (a, la), (b, lb) = streams["one_shot"], streams["chunked"]
    if a != b or not all(np.array_equal(x, y) for x, y in zip(la[-7:],
                                                               lb[-7:])):
        raise AssertionError(f"{model.cfg.arch}: one-shot {a} != chunked {b}")
    log(f"one-shot == chunked prefill ({model.cfg.arch}, "
        f"{model.cfg.n_layers} layers, {len(prompt)}-token prompt): {a}")


def long_prompt(vocab: int) -> list:
    """300 tokens: rows that cross the paged kernel's 64-key block edges
    (and its 16-token pages) several times, from a generator of its own so
    that the other checks keep their prompts."""
    import numpy as np

    return np.random.default_rng(SEED + 7).integers(0, vocab, 300).tolist()


def f32_check(arch, rng) -> None:
    """The f32 model's logits against ``forward_reference``, at the
    published widths cut to F32_CHECK_LAYERS layers: with random weights
    of the reference's statistics the attention softmaxes are nearly
    one-hot, and f32 round-off that flips one of them grows layer by
    layer, so a deep random stack cannot be held to 1e-3."""
    import torch

    from repro_torch.configs import get
    from repro_torch.models import Model
    from repro_torch.serve import Engine, ServeConfig

    model = Model(dataclasses.replace(get(arch), n_layers=F32_CHECK_LAYERS,
                                      dtype=torch.float32), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(SEED + 1))
    eng = Engine(model, ServeConfig(max_batch=4, page_size=16, hbm_pages=16,
                                    host_pages=16, keep_logits=True))
    prompt = rng.integers(0, model.cfg.vocab, 40).tolist()
    eng.add_request(0, prompt, max_new=4)
    worst = 0.0
    while eng.requests:
        context = eng.requests[0].context
        eng.step()
        if 0 not in eng.last_logits:      # finished: its row left with it
            break
        got = torch.from_numpy(eng.last_logits[0])
        with torch.no_grad():
            want = forward_reference(model, context).cpu()
        if not torch.isfinite(got).all() or got.shape != want.shape:
            raise AssertionError(f"logits shaped {tuple(got.shape)} or "
                                 f"not finite")
        worst = max(worst, float((got - want).abs().max()
                                 / want.abs().max()))
    if worst > 1e-3:
        raise AssertionError(f"{arch} f32 engine logits vs plain forward: "
                             f"relative max err {worst} > 1e-3")
    log(f"f32 engine logits vs plain contiguous forward ({arch}, "
        f"{F32_CHECK_LAYERS} layers): relative max err {worst:.3e} "
        f"(tol 1e-3)")
    del eng, model
    free_card()


# The serving workloads of phases 4 and 5: (ServeConfig fields, requests,
# prompt tokens, new tokens, seed of the prompts).  The MoE page is 1 MiB
# (32 layers of K and V); a request needs 17 pages, so 4 requests fit the
# 79 usable HBM slots and 8 do not.
SERVING = {
    DENSE: (dict(max_batch=4, page_size=16, max_pages_per_seq=64,
                 hbm_pages=160, host_pages=512, policy="gdt",
                 interval_steps=4), 8, 512, 32, SEED),
    MOE: (dict(max_batch=4, page_size=16, max_pages_per_seq=32,
               hbm_pages=80, host_pages=256, policy="gdt",
               interval_steps=4), 8, 256, 16, SEED + 3),
}


def serving_run(card, arch):
    """``main_run`` on the serving workload of ``arch``.  Returns
    (llm, cfg, prompts, params, wall, launches, rng)."""
    import numpy as np

    from repro_torch.serve import ServeConfig

    fields, n_req, n_prompt, n_new, seed = SERVING[arch]
    cfg = ServeConfig(**fields)
    rng = np.random.default_rng(seed)
    llm, prompts, params, wall, launches = main_run(card, arch, cfg, n_req,
                                                    n_prompt, n_new, rng)
    return llm, cfg, prompts, params, wall, launches, rng


def serve_dense(card, kernel_rows) -> None:
    """Phase 4: the dense main path, its breakdown and its checks."""
    llm, cfg, prompts, params, wall, launches, rng = serving_run(card, DENSE)
    for name in ("paged_attention", "paged_prefill"):
        kernel_rows[name]["launches"] = launches[name]
    where_time_goes(card, DENSE, cfg, prompts, params, wall,
                    [("paged attention", "paged_attention")])
    model = llm.engine.model
    one_shot_equals_chunked(model,
                            rng.integers(0, model.cfg.vocab, 100).tolist())
    one_shot_equals_chunked(model, long_prompt(model.cfg.vocab))
    del llm, model
    free_card()
    f32_check(DENSE, rng)


def serve_moe(card, kernel_rows) -> None:
    """Phase 5: the MoE main path at the published widths, where its time
    goes (the grouped-expert kernels' share of the device time), and its
    checks."""
    llm, cfg, prompts, params, wall, launches, rng = serving_run(card, MOE)
    kernel_rows["moe_grouped_ffn"]["launches"] = launches["moe_grouped_ffn"]
    where_time_goes(card, MOE, cfg, prompts, params, wall,
                    [("paged attention", "paged_attention"),
                     ("grouped-expert", "moe_")])
    model = llm.engine.model
    one_shot_equals_chunked(model,
                            rng.integers(0, model.cfg.vocab, 64).tolist())
    one_shot_equals_chunked(model, long_prompt(model.cfg.vocab))
    del llm, model
    free_card()
    f32_check(MOE, rng)


# ---------------------------------------------------------------- training
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 2, 2048


def train_run(card, label, cfg, batches, gdt):
    """One ``Trainer.run`` of TRAIN_STEPS steps from the seeded init, the
    launch counters zeroed just before and read just after.  Each step ends
    in the host reading its loss, so the times between steps are
    synchronised step times.  Returns (losses, launches, trainer)."""
    import torch

    from repro_torch.models import Model
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import Trainer, TrainerConfig

    model = Model(cfg, device="cuda")
    opt = AdamW(lr=cosine_schedule(3e-4, warmup=1, total=TRAIN_STEPS))
    trainer = Trainer(model, opt, TrainerConfig(steps=TRAIN_STEPS,
                                                log_every=1, gdt=gdt,
                                                seed=SEED))
    stamps = []

    def timed():
        for b in batches:
            stamps.append(time.perf_counter())
            yield b

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = trainer.run(timed())
    stamps.append(time.perf_counter())
    launches = read_launches()
    losses = [m["loss"] for m in trainer.metrics_log]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x)
                                             for x in losses):
        raise AssertionError(f"training {label}: losses {losses}")
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    wall = stamps[-1] - stamps[0]
    tokens = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
    log(f"training {label}: losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}")
    steady = 1e3 * (TRAIN_STEPS - 1) * TRAIN_BATCH * TRAIN_SEQ / sum(
        step_ms[1:])
    log(f"training {label}: step ms {', '.join(f'{t:.1f}' for t in step_ms)}"
        f"; {wall:.3f} s for {TRAIN_STEPS} steps, {tokens / wall:.1f} "
        f"training tokens/s ({steady:.1f} after the first step) "
        f"{card.tag()}")
    log(f"training {label}: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB {card.tag()}")
    per_step = {"flash_attention_fwd": 2 * cfg.n_layers * TRAIN_STEPS,
                "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS}
    for name, n in per_step.items():
        if launches[name] != n:
            raise AssertionError(f"training {label} {name}: "
                                 f"{launches[name]} launches, expected {n} "
                                 f"(remat: 2 forwards and 1 backward per "
                                 f"layer and step)")
    log(f"training {label}: launches flash_attention_fwd "
        f"{launches['flash_attention_fwd']}, flash_attention_bwd "
        f"{launches['flash_attention_bwd']}")
    if gdt is not None:
        log(f"training {label}: migrations {result['migrations']}, "
            f"bytes_migrated {result['bytes_migrated']}, transfer_bytes "
            f"{result['transfer_bytes']}, slow_bytes "
            f"{trainer.placer.slow_bytes()}, fast_bytes "
            f"{trainer.placer.fast_bytes()}, intervals "
            f"{sum(e.kind == 'interval' for e in trainer.gdt.events)}")
    return losses, launches, trainer


def plain_loss(model, params, batch):
    """The loss by a plain path: embedding by indexing, explicit rmsnorm,
    einsum projections, attention through ``mha_reference`` (autograd for
    its gradient), one cross entropy over the whole logits."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.models.layers import rope, rope_freqs

    cfg = model.cfg
    f32 = torch.float32

    def norm(scale, x):
        xf = x.to(f32)
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
        return (y * scale.to(f32)).to(x.dtype)

    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    freqs = rope_freqs(model.head_dim, cfg.rope_theta, tokens.device)
    x = params["embed.tok"][tokens]
    for i in range(cfg.n_layers):
        p = {n[len(f"layers.{i}."):]: t for n, t in params.items()
             if n.startswith(f"layers.{i}.")}
        h = norm(p["ln1.scale"], x)
        q = rope(torch.einsum("bsd,dhk->bshk", h, p["attn.wq"]), pos, freqs)
        k = rope(torch.einsum("bsd,dhk->bshk", h, p["attn.wk"]), pos, freqs)
        v = torch.einsum("bsd,dhk->bshk", h, p["attn.wv"])
        o = ref.mha_reference(q, k, v, causal=True, window=cfg.window)
        x = x + torch.einsum("bshk,hkd->bsd", o, p["attn.wo"])
        h2 = norm(p["ln2.scale"], x)
        g = torch.einsum("bsd,df->bsf", h2, p["mlp.w_gate"])
        u = torch.einsum("bsd,df->bsf", h2, p["mlp.w_up"])
        x = x + torch.einsum("bsf,fd->bsd",
                             F.silu(g.to(f32)).to(x.dtype) * u,
                             p["mlp.w_down"])
    x = norm(params["final_ln.scale"], x)
    logits = torch.einsum("bsd,dv->bsv", x, params["head.w"]).to(f32)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def train_f32_check(batch) -> None:
    """The f32 model cut to F32_CHECK_LAYERS layers: the kernel path's
    loss and gradients (``train.step.value_and_grad``: ``Model.loss``,
    flash kernels, remat) against ``plain_loss``'s, each gradient leaf
    within 1e-4 of the plain one in norm."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.train import value_and_grad

    model = Model(dataclasses.replace(get(DENSE), n_layers=F32_CHECK_LAYERS,
                                      dtype=torch.float32), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(SEED + 5))
    params = dict(model.named_parameters())
    before = dict(fa.LAUNCHES)
    loss, grads = value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    if fa.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"]:
        raise AssertionError("f32 training check: the kernel path launched "
                             "no flash backward")
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    want = plain_loss(model, leaves, batch)
    want_grads = dict(zip(leaves, torch.autograd.grad(
        want, list(leaves.values()))))
    want = float(want.detach())
    rel_loss = abs(float(loss) - want) / abs(want)
    worst, worst_name = 0.0, ""
    for name, g in grads.items():
        w = want_grads[name]
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        if not math.isfinite(rel):
            raise AssertionError(f"f32 training check: {name} not finite")
        if rel > worst:
            worst, worst_name = rel, name
    if rel_loss > 1e-4 or worst > 1e-4:
        raise AssertionError(
            f"f32 training check: loss rel err {rel_loss:.3e}, worst "
            f"gradient {worst_name} rel err {worst:.3e} (tol 1e-4)")
    log(f"f32 kernel-path loss and gradients vs plain path ({DENSE}, "
        f"{F32_CHECK_LAYERS} layers, B={TRAIN_BATCH} S={TRAIN_SEQ}): loss "
        f"{float(loss):.6f} vs {want:.6f} (rel {rel_loss:.3e}), worst "
        f"gradient {worst_name} rel err {worst:.3e} in norm (tol 1e-4)")
    del model, params, grads, leaves, want_grads
    free_card()


def profile_training(card, trainer, batches) -> None:
    """Two more unguided steps under ``torch.profiler``: the device's busy
    time by kernel, and its idle share over the two steps' wall time (the
    profiler slows the host, not the kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer.cfg.steps = len(batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(iter(batches))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    busy = sum(dev_us(e) for e in events) / 1e6
    log(f"device training: kernels and copies busy {busy:.3f} s of "
        f"{wall:.3f} s for {len(batches)} profiled steps: idle share "
        f"{100 * max(0.0, 1 - busy / wall):.1f}% {card.tag()}")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        log(f"  device {dev_us(e) / 1e3:10.2f} ms  calls {e.count:7d}  "
            f"{e.key[:90]}")
    log_kernel_share(card, "training", events, busy, "flash attention",
                     "flash_")


def train_dense(card, kernel_rows) -> None:
    """Phase 6: dense training at the published widths, unguided then
    guided, and the 2-layer f32 check."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.core import GuidanceConfig
    from repro_torch.data import SyntheticLM

    cfg = get(DENSE)                       # bf16, remat on
    src = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to("cuda")
                for k, v in src.batch_np(i).items()}
               for i in range(TRAIN_STEPS)]
    log(f"model {DENSE} training: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.dtype}, remat {cfg.remat}; batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps a run")
    losses, launches, trainer = train_run(card, "unguided", cfg, batches,
                                          None)
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        kernel_rows[name]["launches"] = launches[name]
    profile_training(card, trainer, batches[:2])
    n_params = sum(p.numel() for p in trainer.params.values())
    state = sum(p.numel() * p.element_size()
                for p in trainer.params.values()) + 2 * 4 * n_params
    log(f"training state: {n_params} parameters, {state} bytes of "
        f"parameters and f32 moments")
    del trainer
    free_card()
    gdt = GuidanceConfig(enabled=True, fast_capacity_bytes=int(state * 0.6),
                         interval_steps=2, promotion_threshold=64 * 1024)
    guided, _, trainer = train_run(card, "guided", cfg, batches, gdt)
    if not np.allclose(guided, losses, rtol=1e-5, atol=0):
        raise AssertionError(f"guided losses {guided} != unguided {losses} "
                             f"(rtol 1e-5)")
    if trainer.placer.slow_bytes() <= 0:
        raise AssertionError("guided training kept nothing on pinned host")
    log(f"guided == unguided losses (rtol 1e-5), max rel diff "
        f"{max(abs(a - b) / abs(b) for a, b in zip(guided, losses)):.3e}; "
        f"{trainer.placer.slow_bytes()} bytes on pinned host")
    del trainer
    free_card()
    train_f32_check(batches[0])


# --------------------------------------------------------- hybrid serving
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW = 4, 1024, 32
HYBRID_CHECK_LAYERS = 7          # one shared application and a remainder
HYBRID_CHECK_PROMPT = 256        # two SSD chunks
HYBRID_TOL = 2e-3                # tests/test_recurrent_prefill.py's


def hybrid_expected(cfg) -> dict:
    """Kernel launches of one prefill: one SSD call per Mamba2 layer, one
    flash forward per shared-block application."""
    return {"ssd_scan": cfg.n_layers,
            "flash_attention_fwd": cfg.n_layers // cfg.attn_every}


@contextlib.contextmanager
def plain_kernels():
    """Within this context the model's kernel entry points take their plain
    versions on any device: ``ref.ssd_reference`` per chunk and
    ``ref.mha_reference``.  The comparison path of the f32 hybrid check."""
    from repro_torch.kernels import ops, ref

    saved = ops.ssd_scan, ops.flash_attention
    ops.ssd_scan = ref.ssd_reference
    ops.flash_attention = ref.mha_reference
    try:
        yield
    finally:
        ops.ssd_scan, ops.flash_attention = saved


def profile_hybrid(card, model, tokens, n_decode: int = 4) -> None:
    """One more prefill, then ``n_decode`` decode steps, each part under
    ``torch.profiler``: the device's busy time by kernel, and its idle
    share over the part's wall time (the profiler slows the host, not the
    kernels, so the decode's idle share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    S = tokens.shape[1]
    cache = model.init_cache(tokens.shape[0], S + n_decode)
    state = {}

    def prefill():
        state["logits"], _ = model.prefill(tokens, cache)

    def decode():
        logits = state["logits"]
        for pos in range(S, S + n_decode):
            logits, _ = model.decode(logits.argmax(-1), cache, pos)

    for label, part, top in (("prefill", prefill, 12),
                             (f"{n_decode} decode steps", decode, 6)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            part()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
        busy = sum(dev_us(e) for e in events) / 1e6
        log(f"device hybrid {label}: kernels and copies busy {busy:.3f} s "
            f"of {wall:.3f} s, {sum(e.count for e in events)} launches: "
            f"idle share {100 * max(0.0, 1 - busy / wall):.1f}% "
            f"{card.tag()}")
        for e in sorted(events, key=dev_us, reverse=True)[:top]:
            log(f"  device {dev_us(e) / 1e3:10.2f} ms  calls {e.count:7d}  "
                f"{e.key[:90]}")
        if label == "prefill":
            log_kernel_share(card, f"hybrid {label}", events, busy,
                             "flash attention", "flash_")
            log_kernel_share(card, f"hybrid {label}", events, busy, "SSD",
                             "ssd_chunk")
    del cache, state


def hybrid_f32_checks(rng) -> None:
    """zamba2 in f32 at the published widths cut to HYBRID_CHECK_LAYERS
    layers (one shared application and a remainder, the smoke config's
    layout): the kernel path's prefill logits and cache against the plain
    path's, and prefill-then-decode against stepwise decode on a
    HYBRID_CHECK_PROMPT-token prompt, greedy tokens equal and logits within
    HYBRID_TOL.  The kernel and plain versions differ by about 1e-6 of
    their outputs; seven random layers amplify that, as the JAX package's
    own prefill and stepwise forms show (its test holds them to 2e-3)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.models import Model

    cfg = dataclasses.replace(get(HYBRID), n_layers=HYBRID_CHECK_LAYERS,
                              dtype=torch.float32)
    model = Model(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(SEED + 7))
    S, n_new = HYBRID_CHECK_PROMPT, 4
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S))).to("cuda")
    reset_launches()
    logits, cache = model.prefill(tokens, model.init_cache(1, S + n_new))
    torch.cuda.synchronize()
    launches = read_launches()
    for name, n in hybrid_expected(cfg).items():
        if launches[name] != n:
            raise AssertionError(f"f32 hybrid kernel path: {launches[name]} "
                                 f"{name} launches, expected {n}")
    reset_launches()
    with plain_kernels():
        want, want_cache = model.prefill(tokens,
                                         model.init_cache(1, S + n_new))
    torch.cuda.synchronize()
    if any(read_launches().values()):
        raise AssertionError(f"the plain path launched kernels: "
                             f"{read_launches()}")
    if not torch.isfinite(logits).all() or logits.shape != (1, cfg.vocab):
        raise AssertionError(f"f32 hybrid logits shaped "
                             f"{tuple(logits.shape)} or not finite")
    err = float((logits - want).abs().max() / want.abs().max())
    leaves = {"conv": (cache["conv"], want_cache["conv"]),
              "ssm": (cache["ssm"], want_cache["ssm"]),
              "k": (cache["kv"]["k"], want_cache["kv"]["k"]),
              "v": (cache["kv"]["v"], want_cache["kv"]["v"])}
    cache_err = {name: max(float((a[i] - b[i]).norm() / b[i].norm())
                           for i in range(a.shape[0]))
                 for name, (a, b) in leaves.items()}
    if err > HYBRID_TOL or max(cache_err.values()) > HYBRID_TOL:
        raise AssertionError(
            f"f32 hybrid kernel path vs plain path: logits {err:.3e} of "
            f"max|logit|, cache leaves in norm {cache_err} (tol "
            f"{HYBRID_TOL})")
    log(f"f32 hybrid prefill, kernel path vs plain path ({HYBRID}, "
        f"{HYBRID_CHECK_LAYERS} layers, S={S}): logits max err {err:.3e} of "
        f"max|logit|; worst layer of each cache leaf in norm "
        f"{', '.join(f'{k} {v:.3e}' for k, v in cache_err.items())} (tol "
        f"{HYBRID_TOL})")
    del want, want_cache

    a, la = [], [logits]
    for pos in range(S, S + n_new):
        nxt = logits.argmax(-1)
        a.append(int(nxt))
        logits, cache = model.decode(nxt, cache, pos)
        la.append(logits)
    cache = model.init_cache(1, S + n_new)
    for pos in range(S):
        logits, cache = model.decode(tokens[:, pos], cache, pos)
    b, lb = [], [logits]
    for pos in range(S, S + n_new):
        nxt = logits.argmax(-1)
        b.append(int(nxt))
        logits, cache = model.decode(nxt, cache, pos)
        lb.append(logits)
    worst = max(float(((x - y).abs() / (HYBRID_TOL + HYBRID_TOL * y.abs()))
                      .max()) for x, y in zip(la, lb))
    if a != b or worst > 1.0:
        raise AssertionError(
            f"f32 hybrid prefill-then-decode {a} vs stepwise {b}; logits "
            f"{worst:.3f} of atol=rtol={HYBRID_TOL}")
    diff = max(float((x - y).abs().max()) for x, y in zip(la, lb))
    log(f"f32 hybrid prefill-then-decode == stepwise decode "
        f"({HYBRID_CHECK_LAYERS} layers, {S}-token prompt): greedy {a}; "
        f"logits max abs "
        f"diff {diff:.3e} (atol=rtol={HYBRID_TOL})")
    del model, cache
    free_card()


def serve_hybrid(card, kernel_rows) -> None:
    """Phase 7: zamba2 at its published widths (81 layers, nothing cut) in
    bf16 with random weights: HYBRID_BATCH prompts of HYBRID_PROMPT tokens
    through one ``prefill``, then HYBRID_NEW greedy ``decode`` steps, the
    launch counters zeroed just before and read just after; a profiled
    prefill and decode; then the f32 checks."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.models import Model

    cfg = get(HYBRID)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(SEED + 6))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model {HYBRID}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.kv_heads} heads of {model.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, shared attention every "
        f"{cfg.attn_every}, {model.ssm_cfg.n_heads} SSM heads of "
        f"{model.ssm_cfg.head_dim}, state {model.ssm_cfg.state_dim}, chunk "
        f"{model.ssm_cfg.chunk}, {cfg.dtype}; {n_params} parameters; built "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 6)
    B, S, n_new = HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to("cuda")
    # Warm-up: the first prefill pays the allocator and the libraries.
    model.prefill(tokens, model.init_cache(B, S + n_new))
    free_card()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(B, S + n_new)
    cache_bytes = sum(t.numel() * t.element_size() for t in
                      (cache["kv"]["k"], cache["kv"]["v"], cache["conv"],
                       cache["ssm"]))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, cache)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = []
    for pos in range(S, S + n_new):
        nxt = logits.argmax(-1)
        out.append(nxt)
        logits, cache = model.decode(nxt, cache, pos)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()
    generated = torch.stack(out, 1).cpu()
    if not torch.isfinite(logits).all() or logits.shape != (B, cfg.vocab):
        raise AssertionError(f"hybrid logits shaped {tuple(logits.shape)} "
                             f"or not finite")
    if generated.shape != (B, n_new) or not bool(
            ((generated >= 0) & (generated < cfg.vocab)).all()):
        raise AssertionError(f"hybrid generated tokens {generated}")
    expect = hybrid_expected(cfg)
    for name, n in launches.items():
        if launches[name] != expect.get(name, 0):
            raise AssertionError(f"hybrid serving {name}: {launches[name]} "
                                 f"launches, expected {expect.get(name, 0)} "
                                 f"(one prefill)")
    for name in ("ssd_scan", "flash_attention_fwd_dh112"):
        kernel_rows[name]["launches"] = launches[name.replace("_dh112", "")]
    prefill_s, decode_s = t1 - t0, t2 - t1
    log(f"serving {HYBRID}: prefill of {B} x {S} tokens in "
        f"{1e3 * prefill_s:.2f} ms, {B * S / prefill_s:.1f} prompt tokens/s; "
        f"{n_new} decode steps in {decode_s:.3f} s, "
        f"{1e3 * decode_s / n_new:.2f} ms per step, "
        f"{B * n_new / decode_s:.2f} generated tokens/s {card.tag()}")
    log(f"serving {HYBRID}: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (cache "
        f"{cache_bytes / 1e9:.3f} GB) {card.tag()}")
    log(f"serving {HYBRID}: launches {launches}; first generated tokens "
        f"{generated[:, :8].tolist()}")
    del cache, logits
    profile_hybrid(card, model, tokens)
    del model, tokens
    free_card()
    hybrid_f32_checks(rng)


# ------------------------------------------------------------ serving A/B
AB_ROUNDS = 5


def serving_ab(parent: str) -> int:
    """``python3 chip_smoke.py --serving-ab PARENT``: the serving workloads
    of phases 4 and 5 (``SERVING``) and phase 7's hybrid prefill, served by
    the port under PARENT/src and by this tree's, in turns (parent, this,
    this, parent), one process each on the same card.  The host's speed
    differs from one machine to the next and from run to run, so two
    versions compare only inside one such call."""
    for tree in (parent, HERE, HERE, parent):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--serving-child", os.path.abspath(tree)],
                       check=True, timeout=900)
    return 0


def ab_hybrid_prefill(card, label: str, tree: str) -> None:
    """Phase 7's prefill (HYBRID_BATCH prompts of HYBRID_PROMPT tokens
    through ``zamba2_7b`` at its published widths, the same weights and
    tokens) by the port under TREE: a warm-up prefill, then AB_ROUNDS
    timed ones, each on a fresh cache, ending in a synchronise."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.models import Model

    cfg = get(HYBRID)
    model = Model(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(SEED + 6))
    rng = np.random.default_rng(SEED + 6)
    B, S = HYBRID_BATCH, HYBRID_PROMPT
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to("cuda")
    for i in range(1 + AB_ROUNDS):
        cache = model.init_cache(B, S + HYBRID_NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(tokens, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"ab {label} ({tree}) {HYBRID} prefill"
            f"{' warm-up' if i == 0 else ''}: {1e3 * wall:.2f} ms, "
            f"{B * S / wall:.1f} prompt tokens/s {card.tag()}")
        del cache, logits
    del model, tokens
    free_card()


def serving_child(tree: str) -> int:
    """One turn of ``serving_ab``: a warm-up round (the first run of each
    workload in a process is slow: cold library and kernel paths), then
    AB_ROUNDS rounds of the dense and the MoE workload, each on a fresh
    ``LLM`` (its build not timed), then the hybrid prefill's rounds, all
    served by the port under TREE/src."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    card = Card()
    label = "this tree" if tree == HERE else "parent"
    for i, arch in enumerate((DENSE, MOE) * (1 + AB_ROUNDS)):
        llm, _, _, _, wall, _, _ = serving_run(card, arch)
        _, n_req, _, n_new, _ = SERVING[arch]
        log(f"ab {label} ({tree}) {arch}{' warm-up' if i < 2 else ''}: "
            f"{n_req * n_new / wall:.2f} generated tokens/s, {wall:.3f} s "
            f"{card.tag()}")
        del llm
        free_card()
    ab_hybrid_prefill(card, label, tree)
    return 0


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--serving-child":
        return serving_child(os.path.abspath(args[1]))
    if len(args) == 2 and args[0] == "--serving-ab":
        return serving_ab(args[1])
    if args:
        print("usage: python3 chip_smoke.py [--serving-ab PARENT_TREE]",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch is not beside this script; run "
              "it from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    # Full f32 products: a TF32 router product would flip experts.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = Card()
    log(f"device: {card.name} x{card.count}; nvidia-smi: {card.smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {len(logs)} CUDA source(s) in "
        f"{time.perf_counter() - t0:.1f} s for sm_90a")
    for name, text in logs.items():
        log(f"--- ptxas report for csrc/{name}.cu\n{text.strip()}")

    kernel_rows = check_paged_kernels(card)
    kernel_rows["moe_grouped_ffn"] = check_moe_kernel(card)
    kernel_rows.update(check_flash_kernel(card))
    kernel_rows["ssd_scan"] = check_ssd_kernel(card)
    for phase in (serve_dense, serve_moe, train_dense, serve_hybrid):
        phase(card, kernel_rows)
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError(f"{phase.__name__} turned TF32 matmuls on")
    log(card.smi)
    log(json.dumps({"kernels": [kernel_rows[name] for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card.name, "count": card.count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
