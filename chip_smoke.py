#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Device: the card's name, count and power limit.
2. Build: every CUDA source of the port, one nvcc each, started together;
   the build time and ptxas's register and spill report.
3. Kernels: each hand-written kernel against its plain PyTorch version at
   the serving path's shapes (bf16 and f32, decode and prefill, with and
   without a window), prefill rows bitwise equal to decode rows, then
   timed with CUDA events beside its plain version, the memory bound and
   ``scaled_dot_product_attention`` over K/V gathered contiguously (a
   yardstick the port never calls).
4. Serving: ``LLM.from_arch("llama3_2_1b", smoke=False).generate`` at the
   published widths in bf16 with random weights: 8 requests of 512 prompt
   tokens, KV pages migrating between HBM and pinned host memory under the
   guidance runtime.  The launch counters are zeroed just before and read
   just after.  Then one-shot prefill == chunked prefill on a 100-token
   prompt, and an f32 copy of the model against a plain contiguous
   forward pass on a short prompt.

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
SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
F32_CHECK_LAYERS = 2


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


def check_kernels(card) -> dict:
    """Phase 3.  Returns the kernel rows of the result line (launches
    filled in by the serving phase)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng_lengths = torch.Generator().manual_seed(SEED)
    H, K, dh, P = 32, 8, 64, 16

    def ragged(rows, lo, hi):
        return torch.randint(lo, hi + 1, (rows,),
                             generator=rng_lengths).tolist()

    # (label, prefill?, rows, MP, N, lengths): the sweep at MP=128, then the
    # serving path's own shapes (max_pages_per_seq=64, hbm_pages=160).
    cases = [
        ("decode B=4 MP=128", False, 4, 128, 4096, ragged(4, 1, 2048)),
        ("decode B=32 MP=128", False, 32, 128, 4096, ragged(32, 1, 2048)),
        ("prefill S=512 MP=128", True, 512, 128, 4096,
         list(range(1, 481)) + [0] * 32),
        ("decode B=4 serving", False, 4, 64, 160, ragged(4, 513, 544)),
        ("prefill S=512 serving", True, 512, 64, 160,
         list(range(1, 512)) + [0]),
    ]
    worst = {"paged_attention": 0.0, "paged_prefill": 0.0}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for window in (None, 200):
            for label, prefill, rows, MP, N, lengths in cases:
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
    replaces = {"paged_attention": "src/repro/kernels/paged_attention.py:113",
                "paged_prefill": "src/repro/kernels/paged_attention.py:95"}
    for label, prefill, rows, MP, N, lengths in cases:
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
        if label.endswith("serving"):
            rows_out[name] = {
                "name": name, "route": "cuda",
                "source": SOURCE,
                "replaces": replaces[name], "launches": 0,
                "max_abs_err": worst[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}
    return rows_out


# ----------------------------------------------------------------- serving
def dense_forward_reference(model, tokens):
    """Logits of the last position of ``tokens`` by a plain contiguous
    forward pass: no pages, attention as an explicit masked softmax."""
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
        g = h2 @ lp.mlp.w_gate
        u = h2 @ lp.mlp.w_up
        x = x + (torch.nn.functional.silu(g.to(f32)).to(x.dtype) * u) \
            @ lp.mlp.w_down
    x = norm(model.final_ln.scale, x)
    return (x[-1] @ model.head.w).to(f32)


def where_time_goes(card, cfg, prompts, params, main_wall) -> None:
    """The serving workload twice more on fresh engines.  First with the
    engine's layers of work timed on the host clock, the device
    synchronised around each (which slows the run a little).  Then under
    ``torch.profiler`` for the device's time by kernel; the device's busy
    time over the main run's wall time gives its idle share there (the
    profiler slows the host, not the kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import LLM

    def fresh():
        return LLM.from_arch("llama3_2_1b", smoke=False, cfg=cfg, seed=SEED,
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llm.generate(prompts, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rest = wall - sum(spent.values())
    parts = ", ".join(f"{k} {v:.3f} s ({100 * v / wall:.1f}%)"
                      for k, v in sorted(spent.items(), key=lambda kv: -kv[1]))
    log(f"breakdown (synchronised run, {wall:.3f} s): {parts}, rest of the "
        f"engine {rest:.3f} s ({100 * rest / wall:.1f}%) {card.tag()}")
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
    log(f"device: kernels and copies busy {busy:.3f} s, "
        f"{100 * busy / main_wall:.1f}% of the main run's {main_wall:.3f} s: idle share "
        f"{100 * (1 - busy / main_wall):.1f}% {card.tag()}")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        log(f"  device {dev_us(e) / 1e3:10.2f} ms  calls {e.count:7d}  "
            f"{e.key[:90]}")
    del llm
    torch.cuda.empty_cache()


def serve(card, kernel_rows) -> None:
    """Phase 4: the main path through ``LLM.generate``."""
    import numpy as np
    import torch

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import LLM, Engine, SamplingParams, ServeConfig

    cfg = ServeConfig(max_batch=4, page_size=16, max_pages_per_seq=64,
                      hbm_pages=160, host_pages=512, policy="gdt",
                      interval_steps=4)
    t0 = time.perf_counter()
    llm = LLM.from_arch("llama3_2_1b", smoke=False, cfg=cfg, seed=SEED,
                        device="cuda")
    torch.cuda.synchronize()
    mc = llm.engine.model.cfg
    log(f"model llama3_2_1b: {mc.n_layers} layers, d_model {mc.d_model}, "
        f"{mc.n_heads}/{mc.kv_heads} heads, d_ff {mc.d_ff}, vocab "
        f"{mc.vocab}, {mc.dtype}; page {llm.engine.pool.page_bytes} bytes; "
        f"built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    n_req, n_prompt, n_new = 8, 512, 32
    prompts = [rng.integers(0, mc.vocab, n_prompt).tolist()
               for _ in range(n_req)]
    params = [SamplingParams(max_tokens=n_new) for _ in range(n_req)]
    params[3] = SamplingParams(max_tokens=n_new, temperature=0.8, top_k=40,
                               top_p=0.9, seed=7)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    pa.reset_launches()
    t0 = time.perf_counter()
    outs = llm.generate(prompts, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.LAUNCHES)
    st = llm.stats()
    for o in outs:
        if len(o.token_ids) != n_new or o.finish_reason != "length":
            raise AssertionError(
                f"request {o.request_id}: {len(o.token_ids)} tokens, "
                f"finish {o.finish_reason}")
    if not (st["swap_outs"] > 0 and st["swap_ins"] > 0):
        raise AssertionError(f"no migration both ways: {st}")
    runtime = llm.engine.runtime
    if not runtime.history:
        raise AssertionError("the guidance runtime recorded no interval")
    L = mc.n_layers
    need = {"paged_attention": L * st["decode_dispatches"],
            "paged_prefill": L * st["prefill_dispatches"]}
    for name, n in need.items():
        if launches[name] < n or launches[name] == 0:
            raise AssertionError(f"{name}: {launches[name]} launches < "
                                 f"{n} (layers x dispatches)")
        kernel_rows[name]["launches"] = launches[name]
    tokens = n_req * n_new
    log(f"serving: {n_req} requests x {n_prompt} prompt + {n_new} new "
        f"tokens in {wall:.3f} s: {tokens / wall:.2f} generated tokens/s, "
        f"{(n_req * n_prompt + tokens) / wall:.1f} tokens/s in all, "
        f"{1e3 * wall / st['steps']:.2f} ms per engine step "
        f"({st['steps']} steps) {card.tag()}")
    log(f"serving: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB {card.tag()}")
    log(f"serving: swap_ins {st['swap_ins']}, swap_outs {st['swap_outs']}, "
        f"transfer_events {st['transfer_events']}, bytes_moved "
        f"{st['bytes_moved']}, preemptions {st['preemptions']}, "
        f"prefill_dispatches {st['prefill_dispatches']}, decode_dispatches "
        f"{st['decode_dispatches']}, intervals {len(runtime.history)}, "
        f"launches {launches}")

    where_time_goes(card, cfg, prompts, params, wall)

    # One-shot == chunked prefill at full width: the projections' row
    # tiles and the kernel's per-row order make them bitwise equal.
    prompt = rng.integers(0, mc.vocab, 100).tolist()
    streams = {}
    for mode in ("one_shot", "chunked"):
        eng = Engine(llm.engine.model,
                     ServeConfig(max_batch=4, page_size=16, hbm_pages=16,
                                 host_pages=16, prefill=mode,
                                 keep_logits=True))
        eng.add_request(0, prompt, max_new=8)
        rows = []
        while eng.requests:
            eng.step()
            rows.extend(eng.last_logits.values())
        streams[mode] = (eng.finished[0].generated, rows)
    (a, la), (b, lb) = streams["one_shot"], streams["chunked"]
    if a != b or not all(np.array_equal(x, y) for x, y in zip(la[-7:],
                                                               lb[-7:])):
        raise AssertionError(f"one-shot {a} != chunked {b}")
    log(f"one-shot == chunked prefill (100-token prompt): {a}")
    del llm
    torch.cuda.empty_cache()

    # The f32 model's logits against a plain contiguous forward pass, at
    # the published widths cut to F32_CHECK_LAYERS layers: with random
    # weights of the reference's statistics the attention softmaxes are
    # nearly one-hot, and f32 round-off that flips one of them grows
    # layer by layer, so a deep random stack cannot be held to 1e-3.
    from repro_torch.configs import get
    from repro_torch.models import Model

    model = Model(dataclasses.replace(get("llama3_2_1b"),
                                      n_layers=F32_CHECK_LAYERS,
                                      dtype=torch.float32), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(SEED + 1))
    eng = Engine(model, ServeConfig(max_batch=4, page_size=16, hbm_pages=16,
                                    host_pages=16, keep_logits=True))
    prompt = rng.integers(0, mc.vocab, 40).tolist()
    eng.add_request(0, prompt, max_new=4)
    worst = 0.0
    while eng.requests:
        context = eng.requests[0].context
        eng.step()
        if 0 not in eng.last_logits:      # finished: its row left with it
            break
        got = torch.from_numpy(eng.last_logits[0])
        with torch.no_grad():
            want = dense_forward_reference(model, context).cpu()
        if not torch.isfinite(got).all() or got.shape != want.shape:
            raise AssertionError(f"logits shaped {tuple(got.shape)} or "
                                 f"not finite")
        worst = max(worst, float((got - want).abs().max()
                                 / want.abs().max()))
    if worst > 1e-3:
        raise AssertionError(f"f32 engine logits vs plain forward: relative "
                             f"max err {worst} > 1e-3")
    log(f"f32 engine logits vs plain contiguous forward "
        f"({F32_CHECK_LAYERS} layers): relative max err {worst:.3e} "
        f"(tol 1e-3)")


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

    kernel_rows = check_kernels(card)
    serve(card, kernel_rows)
    log(card.smi)
    log(json.dumps({"kernels": [kernel_rows["paged_attention"],
                                kernel_rows["paged_prefill"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card.name, "count": card.count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
