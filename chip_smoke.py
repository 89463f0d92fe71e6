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
   24 query heads over 8), prefill rows bitwise equal to decode rows, beside
   ``scaled_dot_product_attention`` over K/V gathered contiguously.  The
   grouped-expert FFN: decode (32 rows) and prefill (2048 rows) at
   granite's widths, empty groups, a ``group_experts`` map with more groups
   than experts and a slot remap, rows past the segments zero, and the
   first 32 rows of a 2048-row call bitwise equal to the same rows alone;
   no single PyTorch call computes a grouped SwiGLU, so it has no yardstick.
4. Dense serving: ``LLM.from_arch("llama3_2_1b", smoke=False).generate`` at
   the published widths in bf16 with random weights: 8 requests of 512
   prompt tokens, KV pages migrating between HBM and pinned host memory
   under the guidance runtime.  The launch counters are zeroed just before
   and read just after.  Then a synchronised breakdown and a profiler pass
   of the same workload, one-shot prefill == chunked prefill on a
   100-token prompt, and an f32 copy cut to 2 layers against a plain
   contiguous forward pass.
5. MoE serving, after the dense model is freed:
   ``LLM.from_arch("granite_moe_3b_a800m", smoke=False).generate`` at the
   published widths (32 layers, 40 experts, top-8) in bf16: 8 requests of
   256 prompt tokens with pages migrating both ways, every expert FFN
   through the grouped-expert kernel (counters zeroed just before, read
   just after); one-shot == chunked on a 64-token prompt at all 32 layers;
   an f32 copy cut to 2 layers against a plain forward pass with plain
   routing and combine.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

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
SOURCES = {"paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "paged_prefill": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "moe_grouped_ffn": "src/repro_torch/kernels/csrc/moe_gemm.cu"}
REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:113",
            "paged_prefill": "src/repro/kernels/paged_attention.py:95",
            "moe_grouped_ffn": "src/repro/kernels/moe_gemm.py:221"}
F32_CHECK_LAYERS = 2
DENSE, MOE = "llama3_2_1b", "granite_moe_3b_a800m"


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
            want = ref.moe_grouped_ffn_reference(x, wg, wu, wd, gs, ge)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"moe {label}: non-finite output")
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
                f"abs err {err:.3e} (atol=rtol={tol})")
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

    row = None
    for label, T, sizes in (("prefill T=2048", 2048, prefill),
                            ("decode T=32", 32, decode)):
        x, wg, wu, wd = moe_case(gen, T, E, d, f, torch.bfloat16)
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        ms = time_ms(lambda: mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs))
        plain_ms = time_ms(lambda: ref.moe_grouped_ffn_reference(
            x, wg, wu, wd, gs), iters=10)
        b_ms, b_by = moe_bound_ms(x, wg, sizes, list(range(E)))
        log(f"time moe_grouped_ffn {label} bf16 ({sum(n > 0 for n in sizes)}"
            f" experts with rows): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library none, bound {b_ms:.5f} ms "
            f"({b_by}) {card.tag()}")
        row = {"name": "moe_grouped_ffn", "route": "cuda",
               "source": SOURCES["moe_grouped_ffn"],
               "replaces": REPLACES["moe_grouped_ffn"], "launches": 0,
               "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return row


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


def where_time_goes(card, arch, cfg, prompts, params, main_wall) -> None:
    """The serving workload twice more on fresh engines.  First with the
    engine's layers of work timed on the host clock, the device
    synchronised around each (which slows the run a little); eviction is
    the ranking of pages to demote, host work only.  Then under
    ``torch.profiler`` for the device's time by kernel; the device's busy
    time over the main run's wall time gives its idle share there (the
    profiler slows the host, not the kernels)."""
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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in events) / 1e6
    log(f"device {arch}: kernels and copies busy {busy:.3f} s, "
        f"{100 * busy / main_wall:.1f}% of the main run's {main_wall:.3f} s: "
        f"idle share {100 * (1 - busy / main_wall):.1f}% {card.tag()}")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        log(f"  device {dev_us(e) / 1e3:10.2f} ms  calls {e.count:7d}  "
            f"{e.key[:90]}")
    del llm
    free_card()


def free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def reset_launches() -> None:
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import paged_attention as pa

    pa.reset_launches()
    mg.reset_launches()


def read_launches() -> dict:
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import paged_attention as pa

    return {**pa.LAUNCHES, **mg.LAUNCHES}


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
    kernels' per-row orders make them equal."""
    import numpy as np

    from repro_torch.serve import Engine, ServeConfig

    streams = {}
    for mode in ("one_shot", "chunked"):
        eng = Engine(model, ServeConfig(max_batch=4, page_size=16,
                                        hbm_pages=16, host_pages=16,
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


def serve_dense(card, kernel_rows) -> None:
    """Phase 4: the dense main path, its breakdown and its checks."""
    import numpy as np

    from repro_torch.serve import ServeConfig

    cfg = ServeConfig(max_batch=4, page_size=16, max_pages_per_seq=64,
                      hbm_pages=160, host_pages=512, policy="gdt",
                      interval_steps=4)
    rng = np.random.default_rng(SEED)
    llm, prompts, params, wall, launches = main_run(card, DENSE, cfg, 8, 512,
                                                    32, rng)
    for name in ("paged_attention", "paged_prefill"):
        kernel_rows[name]["launches"] = launches[name]
    where_time_goes(card, DENSE, cfg, prompts, params, wall)
    model = llm.engine.model
    one_shot_equals_chunked(model,
                            rng.integers(0, model.cfg.vocab, 100).tolist())
    del llm, model
    free_card()
    f32_check(DENSE, rng)


def serve_moe(card, kernel_rows) -> None:
    """Phase 5: the MoE main path at the published widths and its checks.
    A page is 1 MiB (32 layers of K and V); a request needs 17 pages, so
    4 requests fit the 79 usable HBM slots and 8 do not."""
    import numpy as np

    from repro_torch.serve import ServeConfig

    cfg = ServeConfig(max_batch=4, page_size=16, max_pages_per_seq=32,
                      hbm_pages=80, host_pages=256, policy="gdt",
                      interval_steps=4)
    rng = np.random.default_rng(SEED + 3)
    llm, _, _, _, launches = main_run(card, MOE, cfg, 8, 256, 16, rng)
    kernel_rows["moe_grouped_ffn"]["launches"] = launches["moe_grouped_ffn"]
    model = llm.engine.model
    one_shot_equals_chunked(model,
                            rng.integers(0, model.cfg.vocab, 64).tolist())
    del llm, model
    free_card()
    f32_check(MOE, rng)


def main() -> int:
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
    for phase in (serve_dense, serve_moe):
        phase(card, kernel_rows)
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError(f"{phase.__name__} turned TF32 matmuls on")
    log(card.smi)
    log(json.dumps({"kernels": [kernel_rows[name] for name in
                                ("paged_attention", "paged_prefill",
                                 "moe_grouped_ffn")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card.name, "count": card.count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
