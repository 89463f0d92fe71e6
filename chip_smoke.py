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
   tiles); the expert cache's call (the 40 experts at scattered rows of a
   320-row array through ``group_experts``) bitwise equal to the resident
   call, and groups at slot -1 NaN with every other row untouched, the
   kernel equal to the plain version under ``equal_nan``; the route each
   dtype takes (bf16 on tensor cores, f32 on SIMT);
   timed by CUDA events and by the profiler's device time; no single
   PyTorch call computes a grouped SwiGLU, so it has no yardstick.  Its
   backward at granite's widths and training's 32768 routed rows, bf16
   and f32: dx, dWg, dWu, dWd against the plain backward (2e-2 / 1e-4 of
   each output's largest entry), two launches bitwise equal, with empty
   groups, a map of 48 groups with repeats and groups at slot -1 (NaN dx
   rows, the other rows and experts untouched); the route each dtype
   takes; segments of the 32768-row call alone equal to the same rows of
   the whole call (dx and their expert's gradients, bitwise); the forward
   at the same 32768 rows against its plain version; both timed (events
   and profiler) beside the bound and the plain version, the backward's
   three launches (rows, dx, weights: wgmma, TMA) by kernel name, and
   ptxas's registers, shared memory and spills for them.
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
   the profiler.  The SSD backward: bf16 and f32 against
   ``ref.ssd_bwd_reference`` at hybrid training's call (32 chunk rows of
   128, 112 heads of 64, state 64), an odd shape (Q = 72, N = 13) and the
   largest (Q = 256, N = 128), each output within 1e-2 (bf16 outputs) or
   1e-4 (f32) of its largest entry, two launches bitwise equal, chunk
   rows of the 32-row call equal to each row alone in dx, ddt, dB, dC;
   timed beside the plain backward (no library call computes it).  The
   flash backward at dh 112 at hybrid training's shape (B=2, S=2048,
   32/32 heads), checked, bitwise repeated and timed beside SDPA's.
4. Dense serving: ``LLM.from_arch("llama3_2_1b", smoke=False).generate`` at
   the published widths in bf16 with random weights: 8 requests of 512
   prompt tokens, KV pages migrating between HBM and pinned host memory
   under the guidance runtime.  The launch counters are zeroed just before
   and read just after.  Then a synchronised breakdown of the same
   workload, one-shot prefill == chunked prefill on a 100-token prompt and on a
   300-token one (across the kernel's key-block edges), and an f32 copy
   cut to 2 layers against a plain contiguous forward pass.
5. MoE serving, after the dense model is freed:
   ``LLM.from_arch("granite_moe_3b_a800m", smoke=False).generate`` at the
   published widths (32 layers, 40 experts, top-8) in bf16: 8 requests of
   256 prompt tokens with pages migrating both ways, every expert FFN
   through the grouped-expert kernel (counters zeroed just before, read
   just after); then a synchronised breakdown of the same workload;
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

8. Prefix sharing and expert tiering, run after phase 5 (before
   training).  8a: ``llama3_2_1b`` on phase
   4's ServeConfig, 8 requests of one shared 448-token prefix (28 full
   pages) plus 64 tokens of their own, 32 new tokens, request 3 sampled,
   served with the prefix cache off and on: streams bitwise equal, 7 x 448
   prompt tokens served from the cache; then with 64-token interleaved
   prefill through the cache, equal to the one-shot run.  8b: phase 5's
   workload with the expert weights in pinned host memory and 320 of the
   1280 (layer, expert) blocks cached on the card (``expert_offchip``):
   streams and grouped-FFN launches equal phase 5's resident run, the
   engine's device memory after build lower by at least the 960 blocks
   left on the host; then 2 requests with double buffering off and on,
   bitwise equal, and a synchronised breakdown of the 2-request run.

9. Cluster serving, run after phase 8 (before training): ``llama3_2_1b``
   at its published widths behind ``LLM(model, cfg, replicas=N)``, phase
   4's workload and ServeConfig with 80 HBM pages a replica (about two of
   its sessions), the launch counters zeroed just before each main run
   and read just after, each run's paged launches, wall time and
   ``serving_summary`` logged.  9a: three replicas == one replica
   bitwise, and one replica == phase 4's streams.  9b: replica 0 fails
   after 2 steps (heartbeat timeout 2): its requests are rebuilt cold on
   the survivors, streams bitwise equal.  9c: replica 0 drained after 3
   steps and removed: every move warm, pages from the host tier among
   the exports, streams bitwise equal; then a rolling restart of all
   three replicas under load, nothing lost, streams equal.  9d: a
   two-tenant trace from ``synthesize`` replayed by ``TraceReplayer`` on
   two replicas, eagerly under the priority policy and with 256-token
   interleaved prefill under DRR: equal streams; the modeled TTFT, TPOT
   and goodput and the wall clock's generated tokens/s logged.  9e:
   ``python -m repro_torch.launch.serve --arch llama3_2_1b --replicas 2
   --rolling-restart ...`` exits 0 with 2 restarts and nothing lost.
   Phases 4, 5 and 8 time their breakdown on the single replica's
   ``Engine`` (``llm.engine`` is the ``Router``); a layer that records no
   time raises.

10. MoE training, after dense training: ``Trainer`` on
   ``granite_moe_3b_a800m`` at the published widths (32 layers, 40
   experts top-8, nothing cut) in bf16 with remat and phase 6's AdamW on
   ``SyntheticLM(seed=0)`` batches of 2 x 2048: MOE_TRAIN_STEPS steps
   unguided, then guided with 60% of the parameter and moment bytes on
   HBM (losses equal to rtol 1e-5, slow bytes > 0); the counters zeroed
   just before each run and read just after (a step: 64
   ``moe_grouped_ffn``, 32 ``moe_grouped_ffn_bwd``, 64 flash forward, 32
   flash backward launches); step times, tokens/s and peak memory; two
   profiled steps (device time by kernel, the grouped-expert kernels'
   share, the idle share); layer 0's MoE backward at full width twice,
   bitwise equal; and an f32 copy cut to 2 layers against a plain path
   (plain routing, grouped FFN and its backward, combine, attention) to
   1e-4.

11. Hybrid training, after hybrid serving: ``Trainer`` on ``zamba2_7b``
   at the published widths cut to 24 layers (all 81 need 81.0 GB of
   training state) in bf16 with remat and phase 6's AdamW on
   ``SyntheticLM(seed=0)`` batches of 2 x 2048: HYBRID_TRAIN_STEPS steps
   unguided, then guided with 60% of the parameter and moment bytes on
   HBM (losses equal to rtol 1e-5, slow bytes > 0); the counters zeroed
   just before each run and read just after (a step: 48 ``ssd_scan``, 24
   ``ssd_scan_bwd``, 4 flash forward and 4 flash backward launches at dh
   112; the shared block is outside the checkpoints); step times,
   tokens/s and peak memory; two profiled steps (device time by kernel,
   the SSD and flash kernels' shares, the idle share); an f32 copy cut to
   7 layers on 256 tokens against a plain path (``ref.ssd_reference`` and
   ``ref.ssd_bwd_reference`` per chunk, ``ref.mha_reference``) to 1e-4.

12. The four newer decoder configs served on the card:
   ``LLM.from_arch(arch, smoke=False).generate`` for ``granite_8b``,
   ``minitron_4b`` and ``stablelm_3b`` (dh 80) at their published widths:
   4 requests of 512 prompt + 16 new tokens (one sampled), max_batch 2,
   80 HBM pages, so that about half the sessions fit and pages migrate
   under gdt; launches, tokens/s, peak memory; one-shot == chunked prefill
   bitwise on a 300-token prompt.  Then ``mixtral_8x7b`` at its published
   widths cut to 8 of 32 layers: one-shot == chunked, then 2 requests of
   4160 prompt tokens (past its 4096 window) + 16 new, resident and tiered
   (24 of its 64 expert blocks on the card, the rest in pinned host
   memory), bitwise equal, the same grouped-expert launches, and the
   tiered build's device bytes down by the blocks off the card.

13. ``stablelm_3b`` trained whole at its published widths with remat and
   phase 6's AdamW on 2 x 2048 batches, 4 steps unguided (64 flash forward
   and 32 flash backward launches a step, all at dh 80), two profiled
   steps, 4 guided with 60% of the state on HBM (losses equal to rtol
   1e-5), and an f32 2-layer copy against the plain path to 1e-4.  Then
   the contiguous cache (``Model.init_cache`` / ``prefill`` / ``decode``):
   ``granite_8b`` whole, 2 prompts of 1024 tokens and 16 greedy steps (36
   flash launches), and the 8-layer mixtral, one 4160-token prompt over a
   4096-slot ring and 16 greedy steps (8 windowed flash and 136
   grouped-expert launches), each held to its launch counts; an f32 copy
   of each cut to 2 layers: prefill against the plain path, and
   prefill-then-decode against stepwise decode (greedy tokens equal,
   logits within 2e-3).

14. The last three families at their published widths in bf16, random
   weights from seeded generators, the launch counters zeroed just before
   each run and read just after.  14a: ``phi3_vision_4_2b`` whole (dh 96):
   ``prefill`` of 2 x (576 seeded patch embeddings + 448 tokens) and 16
   greedy ``decode`` steps (32 flash launches at dh 96), ``Trainer`` 4
   steps of 2 x (576 + 1472) with remat and phase 6's AdamW (64 forward
   and 32 backward flash launches a step) and two profiled steps; an f32
   copy cut to 2 layers, its attention projections scaled to unit score
   deviation: loss and each gradient leaf against the plain path
   (``plain_kernels``) to 1e-4, prefill logits and cache to 1e-4, each
   greedy decode step after the prefill against the full forward of the
   sequence so far (logits within 2e-3).  14b: ``seamless_m4t_medium``
   whole (12 + 12 layers, dh 64, vocab 256206): prefill of 2 x (1024
   frames + 256 tokens) and 16 greedy steps (36 flash launches: 12
   causal in the encoder, 12 causal self and 12 non-causal cross in the
   decoder), 2 training steps of 2 x (1024 frames, 1024 tokens), the f32
   2-layer check.  14c: ``xlstm_350m`` whole (plain torch, every counter
   0): prefill of 4 x 1024 and 32 greedy steps, 2 ``Trainer`` steps at 2
   x 1024 (the sLSTM's time loop), and an f32 copy at the smoke depth (4
   layers, one sLSTM):
   prefill-then-decode against stepwise decode.

15. The MoE dispatches beside the flat layout, and the paper's simulator.
   15a: one ``granite_moe_3b_a800m`` MoE layer at its published widths (d
   1536, f 512, 40 experts, top-8) from the seed, bf16 and f32, at 4 x 512
   and 2 x 2048 tokens: the per-row dropless layout (the grouped-expert
   kernels over B*E groups, ``group_experts`` = arange(E) tiled B times,
   the counters zeroed just before and read just after) against the flat
   layout: output, input gradient and router gradient bit for bit, the
   expert weights' gradients bitwise or within ``GRAD_TOL`` of their
   largest entry (logged which).  15b:
   the capacity dispatch at the same widths, capacity factor 1.0, 2 x 2048
   tokens: the dropped picks counted (more than 0), two forward and
   backward runs bitwise equal, the bf16 output within ``TOL`` of the same
   call in float64, 64 single-token rows within ``TOL`` of dropless;
   timed beside the flat dropless layer.  15c: ``granite_moe_3b_a800m``
   whole with ``moe_dispatch="capacity"``, 2 ``Trainer`` steps of 2 x 2048
   (finite losses, tokens/s, peak memory; no grouped-expert launch).  15d:
   the simulator's headline on the host: ``lulesh`` online against
   first-touch at half its peak RSS (online faster).

16. The distribution layer on one card (last, after phase 15).  16a:
   ``llama3_2_1b`` whole, phase 6's unguided training step (2 x 2048,
   bf16, remat, AdamW) counted by the cost walk
   (``launch.analysis.cost_of``) on the card and on ``meta``: the two
   ``flops`` equal (the card's walk launches the flash kernels, counted in
   ``LAUNCHES``), printed beside the analytic 8 * N * D; then 3 timed steps
   give the walk's model flops over step time (full Sq x Sk attention,
   remat's recompute included) and the rate with attention's causal half
   only, each with its share of the card's 989 TF/s.  16b:
   4 training steps fed by ``data.ShardedLoader`` (no mesh, prefetch 2,
   pinned host memory) against the same steps fed ``SyntheticLM.batch_np``
   directly: the losses bitwise equal; both step times.  16c: the dry
   run's ``build_cell`` on a 1 x 1 abstract mesh: its per-device parameter
   and moment bytes equal the bytes the ``Trainer``'s parameters and AdamW
   moments hold on the card.  The 2-D ep layout, the rings and the
   overlapped MLP need more than one card (NCCL refuses two ranks on one
   GPU); they are tested on the CPU over gloo.
17. The port's linter and its walkthroughs (last, after phase 16).  17a:
   ``repro_torch.check`` over ``src/repro_torch`` (the four CUDA sources
   included) and ``examples/*_torch.py``: 0 findings, or the phase fails.
   17b: ``examples/quickstart_torch.py`` on the card (20 ``Trainer``
   steps at the smoke ``llama3_2_1b``, then ``LLM.generate``); 17c:
   ``examples/serve_guided_kv_torch.py`` (the session/scan workload under
   gdt, lru and fifo, greedy); 17d:
   ``examples/train_guided_offload_torch.py`` at its ~100M default widths
   for 40 steps under the guidance runtime's HBM budget.  Each run's
   launch counters are zeroed just before and read just after: the flash
   forward and backward launch once a layer a step in both training runs
   (remat off), paged decode and prefill launch in both serving runs; the
   three policies' streams are equal and each moves pages; the training
   losses are finite and the last is below the first.  17d then trains
   the same widths, init and batches without tiering: its losses must be
   the tiered run's bit for bit (tiering is lossless) and every weight
   matrix must have moved from the init (the unmoved tensors, bf16 norm
   scales whose updates round away, are logged).  Wall times and steps (or
   tokens) a second are logged.  Only 17d's flash launches join the
   kernel rows (head dim 64, as the rows are timed); 17b and 17c run the
   smoke llama at head dim 16 and their launches are logged on their own
   lines.

Phase 3 also checks the flash kernels on the encoder-decoder's cross
attention (B=2, 16/16 heads of 64, non-causal, bf16 and f32, forward and
backward, bitwise repeats: Sq 256 on Sk 1024, timed beside SDPA, and
training's Sq = Sk = 1024), and flash
attention at dh 80 and 96 (2 x 2048 tokens,
32/32 heads, bf16 and f32, forward and backward, bitwise repeats, timed
beside SDPA, ptxas's registers and spills), the flash forward at dh 128
on the contiguous prefill's shapes (granite's and mixtral's, windowed),
paged attention at stablelm's 32/32 heads of 80 and granite's 32/8 of
128 (the per-row contract included), and the grouped-expert forward at
mixtral's widths (32 and 2048 rows, 8 experts top-2, bf16 and f32), and
the grouped-expert kernels under the per-row layout (2 x 2048 tokens of
granite: G = 80 groups): forward rows and dx rows bitwise equal to the
flat call's (G = 40), both against their plain versions, both layouts
timed beside their bounds.

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
           "moe_grouped_ffn_bwd": "src/repro_torch/kernels/csrc/moe_gemm.cu",
           "flash_attention_fwd":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_bwd":
               "src/repro_torch/kernels/csrc/flash_attention.cu"}
for _dh in (112, 80, 96, "cross"):
    for _way in ("fwd", "bwd"):
        _name = f"flash_attention_{_way}_{'' if _dh == 'cross' else 'dh'}{_dh}"
        SOURCES[_name] = SOURCES[f"flash_attention_{_way}"]
SOURCES["ssd_scan_bwd"] = SOURCES["ssd_scan"]
# The grouped-expert kernels under the per-row layout (G = B*E groups,
# phase 15a).
for _way in ("", "_bwd"):
    SOURCES[f"moe_grouped_ffn{_way}_per_row"] = SOURCES["moe_grouped_ffn"]
REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:113",
            "paged_prefill": "src/repro/kernels/paged_attention.py:95",
            "moe_grouped_ffn": "src/repro/kernels/moe_gemm.py:221",
            "moe_grouped_ffn_bwd": "src/repro/kernels/moe_gemm.py:203",
            "flash_attention_fwd": "src/repro/kernels/flash_attention.py:153",
            "flash_attention_bwd": "src/repro/kernels/flash_attention.py:166",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:65"}
for _dh in (112, 80, 96, "cross"):
    for _way in ("fwd", "bwd"):
        _name = f"flash_attention_{_way}_{'' if _dh == 'cross' else 'dh'}{_dh}"
        REPLACES[_name] = REPLACES[f"flash_attention_{_way}"]
# The SSD backward stands for the autograd the JAX package takes through
# its jnp ssd_chunked (ssd_scan_pallas has no VJP).
REPLACES["ssd_scan_bwd"] = "src/repro/models/ssm.py:84"
REPLACES["moe_grouped_ffn_per_row"] = REPLACES["moe_grouped_ffn"]
REPLACES["moe_grouped_ffn_bwd_per_row"] = REPLACES["moe_grouped_ffn_bwd"]
# flash_attention_fwd_dh112 is the flash forward at zamba2's head dim, its
# launches those of the hybrid prefill; flash_attention_bwd_dh112 the
# backward at that head dim, its launches those of hybrid training.  The
# dh 80 pair's launches are stablelm_3b training's (phase 13); the dh 96
# pair's phi3_vision_4_2b's prefill and training (phase 14a).  The dh 64
# pair counts dense training's (phase 6) and the encoder-decoder's (phase
# 14b); the cross pair is the encoder-decoder's non-causal calls among
# them (its cross attention, Sq != Sk).  Phase 17's walkthroughs add to
# the dh 64 pair (the ~100M training walkthrough's head dim; the
# quickstart's smoke model, at dh 16, has no pair of its own) and to the
# paged rows (the smoke model's dh 16).
KERNELS = ("paged_attention", "paged_prefill", "moe_grouped_ffn",
           "moe_grouped_ffn_bwd", "flash_attention_fwd",
           "flash_attention_bwd", "ssd_scan", "flash_attention_fwd_dh112",
           "ssd_scan_bwd", "flash_attention_bwd_dh112",
           "flash_attention_fwd_dh80", "flash_attention_bwd_dh80",
           "flash_attention_fwd_dh96", "flash_attention_bwd_dh96",
           "flash_attention_fwd_cross", "flash_attention_bwd_cross",
           "moe_grouped_ffn_per_row", "moe_grouped_ffn_bwd_per_row")
F32_CHECK_LAYERS = 2
DENSE, MOE, HYBRID = "llama3_2_1b", "granite_moe_3b_a800m", "zamba2_7b"
# The SSD kernel against its plain version: as a fraction of max|y| (the
# JAX package's kernel test scaling), 1e-4 in both dtypes: f32 computes in
# f32 in another order; bf16 inputs are exact and the weights reach the
# tensor cores as a bf16 hi/lo pair (about 16 bits).
SSD_TOL = 1e-4
# The grouped-expert backward against its plain version, as a fraction of
# each output's largest entry: bf16 outputs round once and its f32
# intermediates reach the tensor cores as bf16 hi/lo pairs; f32 sums in
# other orders.
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# The SSD backward against its plain version, as a fraction of each
# output's largest entry, by the output's dtype: every sum runs in f32 in
# both, in other orders (bf16 inputs are exact; on tensor cores the f32
# operands dY, W and dS go in as bf16 hi/lo pairs); dx, dB and dC in bf16
# then round once, and two roundings of nearly equal f32 values may differ
# by one bf16 unit (2^-7 of the value).
SSD_BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


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


def profiled(run, what: str, tries: int = 3):
    """``run()`` under ``torch.profiler``, recording the device's activity
    only (recording every host operator too, the training profiles'
    ``key_averages`` took about 150 s of a whole run by
    ``scripts/stack_sample.py``):
    ``(device events, wall seconds)`` of the first of ``tries`` profiles
    that saw any device time, else ``(None, None)``.  CUPTI now and then hands a profile no device activity at all
    in a long run; each empty profile is logged and taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
        if sum(dev_us(e) for e in events) > 0:
            return events, wall
        log(f"profile of {what}: attempt {attempt + 1} of {tries} saw no "
            f"device time")
    return None, None


def device_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of what ``fn`` launches, by
    ``torch.profiler`` over ``iters`` calls after 3 warm-ups: the kernels'
    own time, without the host's time to launch them (which ``time_ms``
    includes when the host is the slower of the two).  Where three
    profiles saw no device time, the time comes from ``queued_ms`` and the
    log says so."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(iters):
            fn()

    events, _ = profiled(run, "device_ms")
    if events is not None:
        return sum(dev_us(e) for e in events) / iters / 1e3
    ms = queued_ms(fn, iters)
    log(f"device_ms: {ms:.4f} ms by CUDA events behind a queued sleep, not "
        f"by the profiler")
    return ms


def queued_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call by CUDA events, with the calls
    queued behind a sleeping kernel: the host enqueues all ``iters`` calls
    while the card sleeps, so the events time the kernels back to back and
    not the host's launches (unless ``fn`` synchronises)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s at the H100's clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    if ms <= 0:
        raise AssertionError("CUDA events saw no device time")
    return ms


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


def check_paged_contract(gen, dtype, H, K, MP, N, S, window, hole,
                         dh: int = 64) -> None:
    """The per-row contract at a serving shape: every row of an S-row
    prefill equals, bit for bit, the decode of the same query, table and
    length, in batches of 4 (the serving ``max_batch``; row t at slot t % 4)
    and alone (B=1) on the block, page and window edges.  ``hole`` puts a -1
    slot in the middle of the table; a window of 37 ends mid-page and
    mid-block.  (The kernel splits no row's keys, so there is no split edge
    to cross.)"""
    import torch

    from repro_torch.kernels import paged_attention as pa

    P = 16
    q, kp, vp, table, lens = paged_case(gen, S, H, K, dh, P, MP, N,
                                        list(range(1, S + 1)), True, dtype)
    if hole:
        table[-(-S // P) // 2] = -1
    pre = pa.paged_prefill_cuda(q, kp, vp, table, lens, window=window)
    tables = table[None].expand(4, -1).contiguous()
    label = (f"{H}/{K} heads of {dh} S={S} {dtype} window={window} "
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


# Phase 12's dense serving shapes (NEW_SERVING: max_batch 2, 40 pages a
# sequence, 80 HBM pages) at the head layouts this slice puts on the paged
# kernel's path: stablelm_3b's 32/32 heads of 80 and granite_8b's 32/8 of
# 128 (minitron_4b's 24/8 of 128 and mixtral's 32/8 of 128 share it).
NEW_PAGED = (("stablelm_3b", 32, 32, 80), ("granite_8b", 32, 8, 128))
NEW_PAGED_MP, NEW_PAGED_N = 40, 80


def check_paged_new_paths(card) -> None:
    """Phase 3, paged attention at NEW_PAGED's head layouts: decode B=2 and
    a 512-row prefill, bf16 and f32, with and without a window, against
    the plain version, prefill rows == decode rows bitwise; the per-row
    contract; then timed in bf16 beside the plain version, SDPA and the
    bound (events and the profiler)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    lengths = torch.Generator().manual_seed(SEED + 8)
    MP, N, P = NEW_PAGED_MP, NEW_PAGED_N, 16
    for arch, H, K, dh in NEW_PAGED:
        cases = [(f"decode B=2 {arch} serving", False, 2,
                  torch.randint(513, 529, (2,), generator=lengths).tolist()),
                 (f"prefill S=512 {arch} serving", True, 512,
                  list(range(1, 512)) + [0])]
        for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                                  ("float32", torch.float32)):
            for window in (None, 200):
                for label, prefill, rows, lens_ in cases:
                    q, kp, vp, table, lens = paged_case(
                        gen, rows, H, K, dh, P, MP, N, lens_, prefill, dtype)
                    if prefill:
                        got = pa.paged_prefill_cuda(q, kp, vp, table, lens,
                                                    window=window)
                        want = ref.paged_prefill_reference(
                            q, kp, vp, table, lens, window=window)
                        dec = pa.paged_attention_cuda(
                            q, kp, vp,
                            table[None].expand(rows, -1).contiguous(), lens,
                            window=window)
                        if not torch.equal(dec, got):
                            raise AssertionError(f"{label} {dtype_name}: "
                                                 f"prefill rows differ from "
                                                 f"decode rows")
                    else:
                        got = pa.paged_attention_cuda(q, kp, vp, table, lens,
                                                      window=window)
                        want = ref.paged_attention_reference(
                            q, kp, vp, table, lens, window=window)
                    torch.cuda.synchronize()
                    diff = (got.float() - want.float()).abs()
                    tol = TOL[dtype_name]
                    if not torch.isfinite(got).all() or not bool(
                            (diff <= tol + tol * want.float().abs()).all()):
                        raise AssertionError(
                            f"{label} {dtype_name} window={window}: max abs "
                            f"err {float(diff.max())} outside atol=rtol={tol}")
                    log(f"kernel check paged {H}/{K} heads dh={dh} {label} "
                        f"{dtype_name} window={window}: max abs err "
                        f"{float(diff.max()):.3e} (atol=rtol={tol})")
        for dtype in (torch.bfloat16, torch.float32):
            for window in (None, 37):
                check_paged_contract(gen, dtype, H, K, MP, N, 512, window,
                                     window is not None, dh=dh)
        for label, prefill, rows, lens_ in cases:
            q, kp, vp, table, lens = paged_case(
                gen, rows, H, K, dh, P, MP, N, lens_, prefill, torch.bfloat16)
            if prefill:
                kern = lambda: pa.paged_prefill_cuda(q, kp, vp, table, lens)
                plain = lambda: ref.paged_prefill_reference(q, kp, vp, table,
                                                            lens)
                name = "paged_prefill"
            else:
                kern = lambda: pa.paged_attention_cuda(q, kp, vp, table,
                                                       lens)
                plain = lambda: ref.paged_attention_reference(
                    q, kp, vp, table, lens)
                name = "paged_attention"
            sq, sk, sv, mask, causal = sdpa_inputs(q, kp, vp, table, lens,
                                                   prefill)
            lib = lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, is_causal=causal,
                enable_gqa=True)
            ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain, iters=10), \
                time_ms(lib)
            b_ms, b_by = bound_ms(q, kp, table, lens, P)
            log(f"time {name} {H}/{K} heads dh={dh} {label} bf16: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
                f"ms, bound {b_ms:.5f} ms ({b_by}); device (profiler) kernel "
                f"{device_ms(kern):.4f} ms, sdpa {device_ms(lib):.4f} ms "
                f"{card.tag()}")
    free_card()


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


def check_moe_cache(mg, ref, gen, host, E, k, d, f) -> None:
    """The expert cache's call at granite's widths: the 40 experts at
    scattered rows of an EXPERT_CACHE-row weight array, mapped by
    ``group_experts``, give rows bitwise equal to the 40-row resident call
    (decode and prefill tiles); with some groups' slots -1, those groups'
    rows are NaN and every other row is untouched.  The kernel equals the
    plain version, NaN rows included (``equal_nan``)."""
    import torch

    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for T in (32, 2048):
            sizes = routed_sizes(host, T // k, E, k)
            x, wg, wu, wd = moe_case(gen, T, E, d, f, dtype)
            rows = torch.randperm(EXPERT_CACHE, generator=host)[:E]
            bank = []
            for w in (wg, wu, wd):
                b = torch.randn((EXPERT_CACHE,) + w.shape[1:], generator=gen,
                                device="cuda").to(dtype)
                b[rows.to("cuda")] = w
                bank.append(b)
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            slots = rows.to(torch.int32).to("cuda")
            resident = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs)
            cached = mg.moe_grouped_ffn_cuda(x, *bank, gs, slots)
            if not torch.equal(cached, resident):
                raise AssertionError(
                    f"moe cache {dtype_name} T={T}: rows through a "
                    f"{EXPERT_CACHE}-row cache differ from the resident "
                    f"call")
            absent = [g for g in range(E) if sizes[g] > 0][1::3]
            holes = slots.clone()
            holes[absent] = -1
            got = mg.moe_grouped_ffn_cuda(x, *bank, gs, holes)
            want = ref.moe_grouped_ffn_reference(x, *bank, gs, holes)
            torch.cuda.synchronize()
            bounds = [0]
            for n in sizes:
                bounds.append(bounds[-1] + n)
            dead = torch.zeros(T, dtype=torch.bool, device="cuda")
            for g in absent:
                dead[bounds[g]:bounds[g + 1]] = True
            if not (torch.isnan(got[dead].float()).all()
                    and torch.equal(got[~dead], resident[~dead])):
                raise AssertionError(
                    f"moe cache {dtype_name} T={T}: -1 slots do not give "
                    f"NaN rows with every other row untouched")
            tol = TOL[dtype_name]
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol, equal_nan=True):
                raise AssertionError(
                    f"moe cache {dtype_name} T={T}: kernel and plain version "
                    f"differ (atol=rtol={tol}, equal_nan)")
            log(f"kernel check moe_grouped_ffn cache {dtype_name} T={T}: "
                f"{E} experts at scattered rows of a {EXPERT_CACHE}-row "
                f"array == the resident call, bitwise; {len(absent)} groups "
                f"at slot -1 ({int(dead.sum())} rows) NaN, the other rows "
                f"untouched; kernel == plain (atol=rtol={tol}, equal_nan)")
            del bank, x, wg, wu, wd


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

    check_moe_cache(mg, ref, gen, host, E, k, d, f)
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



# mixtral_8x7b's experts: 8 of d 4096, f 14336, top-2.
MIXTRAL_FFN = (8, 2, 4096, 14336)


def check_moe_mixtral(card) -> None:
    """Phase 3, the grouped-expert FFN at mixtral_8x7b's widths: decode (32
    rows: 16 tokens' top-2 picks) and prefill (2048 rows) in bf16 and f32
    against the plain version, two launches bitwise equal, rows past the
    segments zero, each call's route; then timed in bf16 beside the plain
    version and the bound (events and the profiler)."""
    import torch

    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    host = torch.Generator().manual_seed(SEED + 9)
    E, k, d, f = MIXTRAL_FFN
    cases = [("decode T=32", 32, routed_sizes(host, 16, E, k)),
             ("prefill T=2048", 2048, routed_sizes(host, 1024, E, k))]
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for label, T, sizes in cases:
            x, wg, wu, wd = moe_case(gen, T, E, d, f, dtype)
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            got = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs)
            again = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs)
            want = ref.moe_grouped_ffn_reference(x, wg, wu, wd, gs)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            tol = TOL[dtype_name]
            if not torch.isfinite(got).all() or not bool(
                    (diff <= tol + tol * want.float().abs()).all()):
                raise AssertionError(
                    f"moe mixtral {label} {dtype_name}: max abs err "
                    f"{float(diff.max())} outside atol=rtol={tol}")
            if not torch.equal(got, again):
                raise AssertionError(f"moe mixtral {label} {dtype_name}: two "
                                     f"launches differ")
            log(f"kernel check moe_grouped_ffn mixtral {label} (d {d}, f "
                f"{f}, {E} experts top-{k}) {dtype_name}: max abs err "
                f"{float(diff.max()):.3e} (atol=rtol={tol}); two launches "
                f"bitwise equal; route {mg.plan(T, d, f, E, E, dtype).route}")
            del x, wg, wu, wd, got, again, want, diff
            free_card()
    for label, T, sizes in cases:
        x, wg, wu, wd = moe_case(gen, T, E, d, f, torch.bfloat16)
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        kern = lambda: mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs)
        ms, dev = time_ms(kern), device_ms(kern)
        plain_ms = time_ms(lambda: ref.moe_grouped_ffn_reference(
            x, wg, wu, wd, gs), iters=10)
        b_ms, b_by = moe_bound_ms(x, wg, sizes, list(range(E)))
        log(f"time moe_grouped_ffn mixtral {label} bf16 "
            f"({sum(n > 0 for n in sizes)} experts with rows): kernel "
            f"{ms:.4f} ms (events), device {dev:.4f} ms (profiler), plain "
            f"{plain_ms:.4f} ms, library none, bound {b_ms:.5f} ms ({b_by}) "
            f"{card.tag()}")
        del x, wg, wu, wd
        free_card()


def moe_bwd_bound_ms(x, wg, sizes, experts, dtype_name) -> tuple:
    """The least time for the backward: x and dy read, dx written, the
    weights of every expert with rows read and every weight gradient
    written, over HBM bandwidth; the 16 rows d f operations of the rows in
    the segments (recompute 2, da 1, dx 2, dW 3) over the dtype's peak.
    Returns (ms, bound_by)."""
    T, d = x.shape
    E, _, f = wg.shape
    item = x.element_size()
    used = {experts[g] for g, n in enumerate(sizes)
            if n > 0 and 0 <= experts[g] < E}
    nbytes = 3 * T * d * item + (len(used) + E) * 3 * d * f * item
    rows = min(sum(n for g, n in enumerate(sizes)
                   if 0 <= experts[g] < E), T)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 16 * rows * d * f / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a, b) -> bool:
    """Bitwise equality that holds for NaNs too."""
    import torch

    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


BWD_LAUNCHES = ("moe_bwd_rows", "moe_bwd_dx", "moe_bwd_weights")
# The SSD backward's bf16 launches: the per-(chunk row, head group) pass
# and the dC/dB/dA reduction.
SSD_BWD_LAUNCHES = ("ssd_bwd_mma", "ssd_bwd_reduce_mma")


def check_moe_bwd_rows(mg, x, wg, wu, wd, dy, sizes, full, dtype_name):
    """Row invariance: the dx rows of a segment of the R-row call equal,
    bitwise, the same rows of a call over that segment alone, and so do
    its expert's weight gradients (the same steps from the segment's
    start); at the first, second, a middle and the last segment."""
    import torch

    E = len(sizes)
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + n)
    for g in (0, 1, E // 2, E - 1):
        lo, hi = starts[g], starts[g + 1]
        alone = [0] * E
        alone[g] = hi - lo
        part = mg.moe_grouped_ffn_bwd_cuda(
            x[lo:hi].contiguous(), wg, wu, wd,
            torch.tensor(alone, dtype=torch.int32, device="cuda"), None,
            dy[lo:hi].contiguous())
        if not (same_bits(part[0], full[0][lo:hi]) and all(
                same_bits(a[g], b[g]) for a, b in zip(part[1:], full[1:]))):
            raise AssertionError(
                f"moe backward {dtype_name}: segment {g} (rows {lo}..{hi}) "
                f"alone differs from the same rows of the {starts[-1]}-row "
                f"call")
    log(f"kernel check moe_grouped_ffn_bwd {dtype_name}: the dx rows and the "
        f"expert's gradients of segments 0, 1, {E // 2}, {E - 1} alone == "
        f"the same in the {starts[-1]}-row call, bitwise")


def log_ptxas(source: str, kernels) -> None:
    """ptxas's registers, shared memory and spills for each entry function
    of ``csrc/<source>.cu`` whose name holds one of ``kernels``
    (``-Xptxas -v`` in the build's log)."""
    from repro_torch.kernels import _build

    lines = _build.BUILD_LOGS.get(source, "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or \
                not any(k in line for k in kernels):
            continue
        entry = line.split("'")[1] if "'" in line else line.strip()
        report = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                  if "Used" in x or "spill" in x]
        log(f"ptxas {entry}: {'; '.join(report)}")


def log_launches(card, fn, names, title) -> None:
    """Each of ``fn``'s launches' device time by kernel name (each name a
    substring of one kernel's), from the profiler over 10 calls."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(10):
            fn()

    events, _ = profiled(run, title)
    if events is None:
        log(f"time {title} by launch: not measured (the profiler saw no "
            f"device time) {card.tag()}")
        return
    times = {}
    for e in events:
        for name in names:
            if name in e.key:
                times[name] = times.get(name, 0.0) + dev_us(e) / 10 / 1e3
    if set(times) != set(names):
        raise AssertionError(f"{title}: the profiler saw {sorted(times)}, "
                             f"expected {names}")
    log(f"time {title} by launch (profiler): " +
        ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items()) +
        f" {card.tag()}")


def check_moe_backward(card) -> dict:
    """Phase 3, the grouped-expert backward at granite's widths (d 1536, f
    512, 40 experts) and training's routed rows (MOE_TRAIN_ROWS), bf16 and
    f32: dx, dWg, dWu, dWd against ``ref.moe_grouped_ffn_bwd_reference``
    (BWD_TOL of each output's largest entry), two launches bitwise equal,
    with 6 empty groups, 48 groups over 40 experts through a map with
    repeats, and groups at slot -1 (their dx rows NaN, every other dx row
    and every other expert's weight gradient bitwise as without the holes,
    their experts' zero); the route each dtype takes; the forward kernel at
    the same rows against its plain version; segments of the training call
    alone equal to the same rows of the whole call, bitwise; then both
    timed, the backward's three launches by kernel name, and ptxas's
    report of its bf16 kernels.  Returns the backward's kernel row
    (launches filled in by phase 10)."""
    import torch

    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    host = torch.Generator().manual_seed(SEED + 3)
    E, k, d, f, R = 40, 8, 1536, 512, MOE_TRAIN_ROWS
    train = routed_sizes(host, R // k, E, k)
    empty = list(train)
    for g in (0, 7, 13, 21, 30, 39):
        empty[(g + 1) % E] += empty[g]
        empty[g] = 0
    mapped = routed_sizes(host, R // k, 48, k)
    map48 = torch.randint(0, E, (48,), generator=host).tolist()
    holes = list(range(E))
    absent = [g for g in range(E) if train[g] > 0][1::5]
    for g in absent:
        holes[g] = -1
    cases = [("train", train, None), ("6 empty groups", empty, None),
             ("G=48 > E=40 map", mapped, map48), ("-1 slots", train, holes)]
    routes = {"bfloat16": "mma", "float32": "simt"}
    worst = 0.0
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        tol = BWD_TOL[dtype_name]
        for label, sizes, experts in cases:
            x, wg, wu, wd = moe_case(gen, R, E, d, f, dtype)
            dy = torch.randn((R, d), generator=gen, device="cuda").to(dtype)
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            ge = None if experts is None else torch.tensor(
                experts, dtype=torch.int32, device="cuda")
            got = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, ge, dy)
            again = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, ge, dy)
            want = ref.moe_grouped_ffn_bwd_reference(x, wg, wu, wd, gs, ge,
                                                     dy)
            torch.cuda.synchronize()
            if not all(same_bits(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"moe backward {label} {dtype_name}: "
                                     f"two launches differ")
            dead = torch.zeros(R, dtype=torch.bool, device="cuda")
            if experts is holes:
                base = mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, None,
                                                   dy)
                bounds = [0]
                for n in sizes:
                    bounds.append(bounds[-1] + n)
                for g in absent:
                    dead[bounds[g]:bounds[g + 1]] = True
                live = [e for e in range(E) if e not in absent]
                if not (torch.isnan(got[0][dead].float()).all()
                        and same_bits(got[0][~dead], base[0][~dead])
                        and all(same_bits(a[live], b[live]) and
                                bool((a[absent] == 0).all())
                                for a, b in zip(got[1:], base[1:]))):
                    raise AssertionError(
                        f"moe backward -1 slots {dtype_name}: dx rows not "
                        f"NaN, or other rows or experts touched")
            errs = []
            for name, a, b in zip(("dx", "dWg", "dWu", "dWd"), got, want):
                if name == "dx":
                    a, b = a[~dead], b[~dead]
                if not torch.isfinite(a).all():
                    raise AssertionError(f"moe backward {label} "
                                         f"{dtype_name}: {name} not finite")
                err = float((a.float() - b.float()).abs().max())
                scale = float(b.float().abs().max())
                if err > tol * scale:
                    raise AssertionError(
                        f"moe backward {label} {dtype_name}: {name} max abs "
                        f"err {err:.3e} > {tol} x max|plain| {scale:.3e}")
                errs.append(f"{name} {err:.3e} ({err / scale:.2e} of max)")
                if label == "train" and dtype == torch.bfloat16:
                    worst = max(worst, err)
            log(f"kernel check moe_grouped_ffn_bwd {label} {dtype_name} "
                f"R={R}: {', '.join(errs)} (tol {tol} of max); two launches "
                f"bitwise equal")
            if label == "train":
                check_moe_bwd_rows(mg, x, wg, wu, wd, dy, sizes, got,
                                   dtype_name)
            del x, wg, wu, wd, dy, got, again, want
        route = mg.plan_bwd(R, d, f, E, E, dtype).route
        if route != routes[dtype_name]:
            raise AssertionError(f"moe backward {dtype_name} takes route "
                                 f"{route}, expected {routes[dtype_name]}")
        log(f"route moe_grouped_ffn_bwd {dtype_name}: {route}")
        # The forward at training's row count (its grid's largest).
        x, wg, wu, wd = moe_case(gen, R, E, d, f, dtype)
        gs = torch.tensor(train, dtype=torch.int32, device="cuda")
        got = mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs)
        want = ref.moe_grouped_ffn_reference(x, wg, wu, wd, gs)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        tol = TOL[dtype_name]
        if not bool((diff <= tol + tol * want.float().abs()).all()):
            raise AssertionError(f"moe forward R={R} {dtype_name}: max abs "
                                 f"err {float(diff.max())} outside "
                                 f"atol=rtol={tol}")
        log(f"kernel check moe_grouped_ffn R={R} {dtype_name}: max abs err "
            f"{float(diff.max()):.3e} (atol=rtol={tol})")
    free_card()

    x, wg, wu, wd = moe_case(gen, R, E, d, f, torch.bfloat16)
    dy = torch.randn((R, d), generator=gen, device="cuda").to(torch.bfloat16)
    gs = torch.tensor(train, dtype=torch.int32, device="cuda")

    def bwd():
        return mg.moe_grouped_ffn_bwd_cuda(x, wg, wu, wd, gs, None, dy)

    ms = time_ms(bwd, iters=20)
    dev = device_ms(bwd, iters=10)
    plain_ms = time_ms(lambda: ref.moe_grouped_ffn_bwd_reference(
        x, wg, wu, wd, gs, None, dy), iters=5, warmup=2)
    b_ms, b_by = moe_bwd_bound_ms(x, wg, train, list(range(E)), "bfloat16")
    f_ms = time_ms(lambda: mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs),
                   iters=20)
    f_dev = device_ms(lambda: mg.moe_grouped_ffn_cuda(x, wg, wu, wd, gs),
                      iters=10)
    f_bound, f_by = moe_bound_ms(x, wg, train, list(range(E)))
    log_launches(card, bwd, BWD_LAUNCHES, f"moe_grouped_ffn_bwd R={R} bf16")
    log_ptxas("moe_gemm", [f"{name}_wgmma" for name in BWD_LAUNCHES])
    log(f"time moe_grouped_ffn_bwd R={R} bf16 ({sum(n > 0 for n in train)} "
        f"experts with rows): kernel {ms:.4f} ms (events), device "
        f"{dev:.4f} ms (profiler), plain {plain_ms:.4f} ms, library none, "
        f"bound {b_ms:.5f} ms ({b_by}) {card.tag()}")
    log(f"time moe_grouped_ffn R={R} bf16: kernel {f_ms:.4f} ms (events), "
        f"device {f_dev:.4f} ms (profiler), bound {f_bound:.5f} ms ({f_by}) "
        f"{card.tag()}")
    del x, wg, wu, wd, dy
    free_card()
    return {"name": "moe_grouped_ffn_bwd", "route": "cuda",
            "source": SOURCES["moe_grouped_ffn_bwd"],
            "replaces": REPLACES["moe_grouped_ffn_bwd"], "launches": 0,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_moe_per_row_kernel(card) -> dict:
    """Phase 3, the grouped-expert kernels under the per-row layout at
    granite's widths and training's routed rows (2 rows of 2048 tokens,
    top-8: G = 2 x 40 groups, ``group_experts`` = arange(40) twice), bf16:
    the forward and the backward against their plain versions, and both
    layouts (per-row, and flat: G = 40, each expert's rows of both batch
    rows in one segment) timed by CUDA events and the profiler beside
    their bounds.  Phase 15a holds the per-row layer to the flat one bit
    for bit.  Returns the per-row rows (launches filled in by phase
    15a)."""
    import torch

    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    host = torch.Generator().manual_seed(SEED + 25)
    E, k, d, f, B = 40, 8, 1536, 512, TRAIN_BATCH
    R = MOE_TRAIN_ROWS
    per_row = [routed_sizes(host, R // (B * k), E, k) for _ in range(B)]
    sizes = [n for row in per_row for n in row]
    x, wg, wu, wd = moe_case(gen, R, E, d, f, torch.bfloat16)
    dy = torch.randn((R, d), generator=gen, device="cuda").to(x.dtype)
    args = {"per-row": (x, wg, wu, wd, torch.tensor(
                sizes, dtype=torch.int32, device="cuda"), torch.tensor(
                list(range(E)) * B, dtype=torch.int32, device="cuda")),
            "flat": (x, wg, wu, wd, torch.tensor(
                [sum(row[e] for row in per_row) for e in range(E)],
                dtype=torch.int32, device="cuda"), None)}
    y_row = mg.moe_grouped_ffn_cuda(*args["per-row"])
    g_row = mg.moe_grouped_ffn_bwd_cuda(*args["per-row"], dy)
    torch.cuda.synchronize()
    want = ref.moe_grouped_ffn_reference(*args["per-row"]).float()
    tol = TOL["bfloat16"]
    worst = {"fwd": float((y_row.float() - want).abs().max())}
    if not bool(((y_row.float() - want).abs() <= tol + tol * want.abs())
                .all()):
        raise AssertionError(f"per-row moe_grouped_ffn: max abs err "
                             f"{worst['fwd']:.3e} outside atol=rtol={tol}")
    want = ref.moe_grouped_ffn_bwd_reference(*args["per-row"], dy)
    worst["bwd"] = 0.0
    for name, a, b in zip(("dx", "dWg", "dWu", "dWd"), g_row, want):
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        if err > BWD_TOL["bfloat16"] * scale:
            raise AssertionError(f"per-row moe_grouped_ffn_bwd: {name} max "
                                 f"abs err {err:.3e} > {BWD_TOL['bfloat16']}"
                                 f" x {scale:.3e}")
        worst["bwd"] = max(worst["bwd"], err)
    log(f"kernel check per-row layout R={R} G={B * E} bf16: against the "
        f"plain versions forward {worst['fwd']:.3e} (atol=rtol={tol}), "
        f"backward {worst['bwd']:.3e} (tol {BWD_TOL['bfloat16']} of each "
        f"max)")
    del y_row, g_row, want
    timed = {}
    for label, a in args.items():
        sz = a[4].tolist()
        ex = list(range(E)) if a[5] is None else a[5].tolist()

        def fwd():
            return mg.moe_grouped_ffn_cuda(*a)

        def bwd():
            return mg.moe_grouped_ffn_bwd_cuda(*a, dy)

        timed[label] = {
            "fwd": (time_ms(fwd, iters=20), device_ms(fwd, iters=10),
                    *moe_bound_ms(a[0], wg, sz, ex)),
            "bwd": (time_ms(bwd, iters=20), device_ms(bwd, iters=10),
                    *moe_bwd_bound_ms(a[0], wg, sz, ex, "bfloat16"))}
        for way, (ms, dev, b_ms, b_by) in timed[label].items():
            log(f"time moe_grouped_ffn{'_bwd' if way == 'bwd' else ''} "
                f"{label} layout R={R} G={len(sz)} bf16: kernel {ms:.4f} ms "
                f"(events), device {dev:.4f} ms (profiler), bound "
                f"{b_ms:.5f} ms ({b_by}) {card.tag()}")
    plain = {"fwd": time_ms(lambda: ref.moe_grouped_ffn_reference(
        *args["per-row"]), iters=3, warmup=1),
        "bwd": time_ms(lambda: ref.moe_grouped_ffn_bwd_reference(
            *args["per-row"], dy), iters=3, warmup=1)}
    rows = {}
    for way, name in (("fwd", "moe_grouped_ffn_per_row"),
                      ("bwd", "moe_grouped_ffn_bwd_per_row")):
        ms, _, b_ms, b_by = timed["per-row"][way]
        rows[name] = {"name": name, "route": "cuda",
                      "source": SOURCES[name], "replaces": REPLACES[name],
                      "launches": 0, "max_abs_err": worst[way], "ms": ms,
                      "plain_ms": plain[way], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None}
    del args, x, wg, wu, wd, dy
    free_card()
    return rows


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
    rows["flash_attention_bwd_dh112"] = check_flash_bwd_112(card, case)
    free_card()
    rows.update(check_flash_new_dims(card, case))
    rows.update(check_flash_cross(card, case))
    check_flash_prefill_128(card, case)
    return rows


# The flash forward at dh 128 on the contiguous prefill's paths (phase 13):
# (label, B, S, H, K, window): granite_8b's 2 x 1024 tokens and mixtral's
# 4160 tokens under its 4096-token window.
FLASH_PREFILL_128 = (("granite_8b prefill", 2, 1024, 32, 8, None),
                     ("mixtral_8x7b prefill", 1, 4160, 32, 8, 4096))


def check_flash_prefill_128(card, case) -> None:
    """Phase 3, the flash forward at dh 128 at FLASH_PREFILL_128's shapes,
    bf16: against the plain version (TOL), two launches bitwise equal,
    timed beside the plain version and SDPA (the window as a boolean mask)
    and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dh, tol = 128, TOL["bfloat16"]
    for label, B, S, H, K, window in FLASH_PREFILL_128:
        q, k, v, _ = case(B, S, S, H, K, dh, torch.bfloat16)
        out, _ = fa.flash_attention_fwd_cuda(q, k, v, True, window)
        again, _ = fa.flash_attention_fwd_cuda(q, k, v, True, window)
        want = ref.mha_reference(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        if not torch.equal(out, again) or not bool(
                (diff <= tol + tol * want.float().abs()).all()):
            raise AssertionError(f"flash dh=128 {label}: max abs err "
                                 f"{float(diff.max())} (atol=rtol={tol}) or "
                                 f"two launches differ")
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if window is not None:
            pos = torch.arange(S, device="cuda")
            gap = pos[:, None] - pos[None, :]
            mask = (gap >= 0) & (gap < window)

        def kern():
            fa.flash_attention_fwd_cuda(q, k, v, True, window)

        def plain():
            with torch.no_grad():
                ref.mha_reference(q, k, v, causal=True, window=window)

        def lib():
            with torch.no_grad():
                F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=True)

        ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain, iters=5), \
            time_ms(lib)
        b_ms, b_by = flash_bound_ms(B, S, S, H, K, dh, True, 2, False)
        log(f"kernel check flash_attention_fwd dh=128 {label} B={B} S={S} "
            f"{H}/{K} heads window={window} bf16: max abs err "
            f"{float(diff.max()):.3e} (atol=rtol={tol}); two launches "
            f"bitwise equal")
        log(f"time flash_attention_fwd dh=128 {label} B={B} S={S} {H}/{K} "
            f"heads window={window} bf16: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by}: the causal half of the pairs; the window drops "
            f"0.02% of mixtral's); device "
            f"(profiler) kernel {device_ms(kern):.4f} ms, sdpa "
            f"{device_ms(lib):.4f} ms {card.tag()}")
        del q, k, v, out, again, want, diff, qs, ks, vs, mask
        free_card()


def check_flash_bwd_112(card, case) -> dict:
    """The flash backward at hybrid training's shared attention (HYBRID_
    TRAIN_ATTN, dh 112), bf16: dq, dk, dv against autograd through the
    plain version, two runs bitwise equal, then timed beside the plain
    backward and SDPA's.  Returns its kernel row (launches filled in by
    phase 11)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, S, _, H, K, dh = HYBRID_TRAIN_ATTN
    q, k, v, do = case(B, S, S, H, K, dh, torch.bfloat16)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v)
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    plain_out = ref.mha_reference(qr, kr, vr)
    want = torch.autograd.grad(plain_out, (qr, kr, vr), do,
                               retain_graph=True)
    torch.cuda.synchronize()
    tol, worst = GRAD_TOL["bfloat16"], 0.0
    for name, g, a, w in zip(("dq", "dk", "dv"), grads, again, want):
        diff = (g.float() - w.float()).abs()
        if not bool((diff <= tol + tol * w.float().abs()).all()):
            raise AssertionError(f"flash backward dh=112 {HYBRID_TRAIN_ATTN}"
                                 f": {name} max abs err {float(diff.max())} "
                                 f"outside atol=rtol={tol}")
        if not torch.equal(g, a):
            raise AssertionError(f"flash backward dh=112: two runs differ in "
                                 f"{name}")
        worst = max(worst, float(diff.max()))
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dos = do.transpose(1, 2).contiguous()
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    def kernel():
        fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)

    def sdpa():
        torch.autograd.grad(sdpa_out, (qs, ks, vs), dos, retain_graph=True)

    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: torch.autograd.grad(
        plain_out, (qr, kr, vr), do, retain_graph=True), iters=10)
    lib_ms = time_ms(sdpa)
    b_ms, b_by = flash_bound_ms(B, S, S, H, K, dh, True, 2, True)
    log(f"kernel check flash_attention_bwd B={B} S={S} {H}/{K} heads "
        f"dh={dh} causal bf16 (hybrid training): dq/dk/dv max abs err "
        f"{worst:.3e} (atol=rtol={tol}); two runs bitwise equal")
    log(f"time flash_attention_bwd B={B} S={S} {H}/{K} heads dh={dh} causal "
        f"bf16 (hybrid training): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); device "
        f"(profiler) kernel {device_ms(kernel):.4f} ms, sdpa "
        f"{device_ms(sdpa):.4f} ms {card.tag()}")
    del q, k, v, do, out, lse, grads, again, qr, kr, vr, plain_out, want
    del qs, ks, vs, dos, sdpa_out
    name = "flash_attention_bwd_dh112"
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


# (B, S, S, H, K) of stablelm_3b's training attention (2 x 2048 tokens,
# 32/32 heads of 80), which phi3_vision_4_2b's 32/32 heads of 96 share.
NEW_FLASH_SHAPE = (2, 2048, 2048, 32, 32)
NEW_FLASH_DIMS = (80, 96)


def check_flash_new_dims(card, case) -> dict:
    """Phase 3, flash attention at head dims 80 (stablelm_3b) and 96
    (phi3_vision_4_2b), at NEW_FLASH_SHAPE, causal: forward and backward in
    bf16 and f32 against the plain version and its autograd gradients
    (TOL, GRAD_TOL), two launches of each bitwise equal, each dtype's route
    from its plan; then, in bf16, timed beside the plain version and SDPA
    forward and backward, by CUDA events and by the profiler.  Returns the
    four kernel rows (launches filled in by phase 13: dh 80's; dh 96 has no
    path yet)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, S, _, H, K = NEW_FLASH_SHAPE
    rows = {}
    # Every instantiation at the new head dims: registers and spills.
    log_ptxas("flash_attention", [f"ILi{dh}E" for dh in NEW_FLASH_DIMS])
    for dh in NEW_FLASH_DIMS:
        worst = {}
        for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                                  ("float32", torch.float32)):
            p = fa.plan(B, S, S, H, K, dh, dtype)
            log(f"flash route {dtype_name} dh={dh}: {p.route} (forward "
                f"{p.rows_per_cta} rows over {p.warps} warps, dK/dV steps "
                f"of {p.bwd_rows} rows, shared {p.fwd_smem}/{p.dkdv_smem}/"
                f"{p.dq_smem} bytes)")
            q, k, v, do = case(B, S, S, H, K, dh, dtype)
            out, lse = fa.flash_attention_fwd_cuda(q, k, v)
            out2, lse2 = fa.flash_attention_fwd_cuda(q, k, v)
            grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
            again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)
            qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
            want = ref.mha_reference(qr, kr, vr)
            want_grads = torch.autograd.grad(want, (qr, kr, vr), do)
            torch.cuda.synchronize()
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)
                    and all(torch.equal(a, b)
                            for a, b in zip(grads, again))):
                raise AssertionError(f"flash dh={dh} {dtype_name}: two "
                                     f"launches differ")
            errs = {}
            for name, got, w, tol in (
                    ("out", out, want, TOL[dtype_name]),
                    *((n, g, wg, GRAD_TOL[dtype_name]) for n, g, wg in
                      zip(("dq", "dk", "dv"), grads, want_grads))):
                w = w.detach().float()
                diff = (got.float() - w).abs()
                if not torch.isfinite(got).all() or not bool(
                        (diff <= tol + tol * w.abs()).all()):
                    raise AssertionError(
                        f"flash dh={dh} {dtype_name} {name}: max abs err "
                        f"{float(diff.max())} outside atol=rtol={tol}")
                errs[name] = float(diff.max())
            if dtype == torch.bfloat16:
                worst = errs
            log(f"kernel check flash_attention dh={dh} B={B} S={S} {H}/{K} "
                f"heads causal {dtype_name}: forward max abs err "
                f"{errs['out']:.3e} (atol=rtol={TOL[dtype_name]}), dq/dk/dv "
                f"{errs['dq']:.3e}/{errs['dk']:.3e}/{errs['dv']:.3e} "
                f"(atol=rtol={GRAD_TOL[dtype_name]}); two forward and two "
                f"backward launches bitwise equal")
            del q, k, v, do, out, lse, out2, lse2, grads, again, qr, kr, vr
            del want, want_grads
        q, k, v, do = case(B, S, S, H, K, dh, torch.bfloat16)
        out, lse = fa.flash_attention_fwd_cuda(q, k, v)
        qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
        plain_out = ref.mha_reference(qr, kr, vr)
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        dos = do.transpose(1, 2).contiguous()
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

        def fwd():
            fa.flash_attention_fwd_cuda(q, k, v)

        def bwd():
            fa.flash_attention_bwd_cuda(q, k, v, out, lse, do)

        def plain_fwd():
            with torch.no_grad():
                ref.mha_reference(q, k, v)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

        def sdpa_bwd():
            torch.autograd.grad(sdpa_out, (qs, ks, vs), dos,
                                retain_graph=True)

        timed = {
            f"flash_attention_fwd_dh{dh}": (
                fwd, plain_fwd, sdpa_fwd, False, "out"),
            f"flash_attention_bwd_dh{dh}": (
                bwd, lambda: torch.autograd.grad(
                    plain_out, (qr, kr, vr), do, retain_graph=True),
                sdpa_bwd, True, "dq"),
        }
        for name, (kern, plain, lib, backward, err_key) in timed.items():
            ms, plain_ms, lib_ms = (time_ms(kern), time_ms(plain, iters=10),
                                    time_ms(lib))
            b_ms, b_by = flash_bound_ms(B, S, S, H, K, dh, True, 2,
                                        backward)
            err = (max(worst["dq"], worst["dk"], worst["dv"]) if backward
                   else worst["out"])
            log(f"time {name} B={B} S={S} {H}/{K} heads dh={dh} causal "
                f"bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); device "
                f"(profiler) kernel {device_ms(kern):.4f} ms, sdpa "
                f"{device_ms(lib):.4f} ms {card.tag()}")
            rows[name] = {"name": name, "route": "cuda",
                          "source": SOURCES[name],
                          "replaces": REPLACES[name], "launches": 0,
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": lib_ms}
        del q, k, v, do, out, lse, qr, kr, vr, plain_out, qs, ks, vs, dos
        del sdpa_out
        free_card()
    return rows


# The encoder-decoder's cross attention (phase 14b's shapes, seamless's
# 16/16 heads of 64): (B, Sq, Sk, H, K, dh), no mask.  CROSS_FLASH is the
# prefill's call (256 tokens on 1024 frames), checked and timed;
# CROSS_FLASH_TRAIN training's (1024 tokens on 1024 frames), checked.
CROSS_FLASH = (2, 256, 1024, 16, 16, 64)
CROSS_FLASH_TRAIN = (2, 1024, 1024, 16, 16, 64)


def check_flash_cross(card, case) -> dict:
    """Phase 3, the flash kernels on the encoder-decoder's non-causal
    calls (CROSS_FLASH: Sq != Sk, and CROSS_FLASH_TRAIN): forward and
    backward in bf16 and f32 against the plain version and its autograd
    gradients (TOL, GRAD_TOL), two launches of each bitwise equal; then,
    in bf16 at CROSS_FLASH, timed beside the plain version and SDPA
    forward and backward, by CUDA events and by the profiler.  Returns the
    two kernel rows (launches filled in by phase 14b)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    worst = {}
    for shape, dtype_name, dtype in (
            (s, n, d) for s in (CROSS_FLASH, CROSS_FLASH_TRAIN)
            for n, d in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32))):
        B, Sq, Sk, H, K, dh = shape
        q, k, v, do = case(B, Sq, Sk, H, K, dh, dtype)
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, causal=False)
        out2, lse2 = fa.flash_attention_fwd_cuda(q, k, v, causal=False)
        grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                            causal=False)
        again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                            causal=False)
        qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
        want = ref.mha_reference(qr, kr, vr, causal=False)
        want_grads = torch.autograd.grad(want, (qr, kr, vr), do)
        torch.cuda.synchronize()
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)
                and all(torch.equal(a, b) for a, b in zip(grads, again))):
            raise AssertionError(f"flash cross Sq={Sq} Sk={Sk} {dtype_name}:"
                                 f" two launches differ")
        errs = {}
        for name, got, w, tol in (
                ("out", out, want, TOL[dtype_name]),
                *((n, g, wg, GRAD_TOL[dtype_name]) for n, g, wg in
                  zip(("dq", "dk", "dv"), grads, want_grads))):
            w = w.detach().float()
            diff = (got.float() - w).abs()
            if not torch.isfinite(got).all() or not bool(
                    (diff <= tol + tol * w.abs()).all()):
                raise AssertionError(
                    f"flash cross Sq={Sq} Sk={Sk} {dtype_name} {name}: max "
                    f"abs err "
                    f"{float(diff.max())} outside atol=rtol={tol}")
            errs[name] = float(diff.max())
        if shape == CROSS_FLASH and dtype == torch.bfloat16:
            worst = errs
        log(f"kernel check flash_attention cross B={B} Sq={Sq} Sk={Sk} "
            f"{H}/{K} heads dh={dh} non-causal {dtype_name}: forward max abs "
            f"err {errs['out']:.3e} (atol=rtol={TOL[dtype_name]}), dq/dk/dv "
            f"{errs['dq']:.3e}/{errs['dk']:.3e}/{errs['dv']:.3e} "
            f"(atol=rtol={GRAD_TOL[dtype_name]}); two forward and two "
            f"backward launches bitwise equal")
        del q, k, v, do, out, lse, out2, lse2, grads, again, qr, kr, vr
        del want, want_grads
    B, Sq, Sk, H, K, dh = CROSS_FLASH
    q, k, v, do = case(B, Sq, Sk, H, K, dh, torch.bfloat16)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, causal=False)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    plain_out = ref.mha_reference(qr, kr, vr, causal=False)
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dos = do.transpose(1, 2).contiguous()
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)

    def fwd():
        fa.flash_attention_fwd_cuda(q, k, v, causal=False)

    def bwd():
        fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=False)

    def plain_fwd():
        with torch.no_grad():
            ref.mha_reference(q, k, v, causal=False)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qs, ks, vs)

    def sdpa_bwd():
        torch.autograd.grad(sdpa_out, (qs, ks, vs), dos, retain_graph=True)

    rows = {}
    timed = {
        "flash_attention_fwd_cross": (fwd, plain_fwd, sdpa_fwd, False),
        "flash_attention_bwd_cross": (
            bwd, lambda: torch.autograd.grad(plain_out, (qr, kr, vr), do,
                                             retain_graph=True),
            sdpa_bwd, True),
    }
    for name, (kern, plain, lib, backward) in timed.items():
        ms, plain_ms, lib_ms = (time_ms(kern), time_ms(plain, iters=10),
                                time_ms(lib))
        b_ms, b_by = flash_bound_ms(B, Sq, Sk, H, K, dh, False, 2, backward)
        err = (max(worst["dq"], worst["dk"], worst["dv"]) if backward
               else worst["out"])
        log(f"time {name} B={B} Sq={Sq} Sk={Sk} {H}/{K} heads dh={dh} "
            f"non-causal bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); device "
            f"(profiler) kernel {device_ms(kern):.4f} ms, sdpa "
            f"{device_ms(lib):.4f} ms {card.tag()}")
        rows[name] = {"name": name, "route": "cuda", "source": SOURCES[name],
                      "replaces": REPLACES[name], "launches": 0,
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms}
    del q, k, v, do, out, lse, qr, kr, vr, plain_out, qs, ks, vs, dos
    del sdpa_out
    free_card()
    return rows


# (B, S, S, H, K, dh) of the hybrid prefill's shared attention: 4 prompts
# of 1024 tokens, zamba2's 32/32 heads of 112.
HYBRID_ATTN = (4, 1024, 1024, 32, 32, 112)
# The hybrid prefill's SSD call: 4 x 1024 tokens in chunks of 128, 112
# heads of 64, state 64; hybrid training's (2 x 2048 tokens) is the same.
HYBRID_SSD = (32, 128, 112, 64, 64)
# (B, S, S, H, K, dh) of hybrid training's shared attention: 2 x 2048.
HYBRID_TRAIN_ATTN = (2, 2048, 2048, 32, 32, 112)


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


def ssd_bwd_bound_ms(x, dt, A, bm) -> tuple:
    """The least time for the backward: x, dt, A, B, C and the f32 dy read
    once, dx, ddt, dA, dB and dC written once, over HBM bandwidth; and the
    causal pairs' work over the peak rate of x's type: per chunk row Q(Q+1)
    /2 pairs, each with the scores (2N), dS B and dS^T C (4N), and per head
    dW (2P), W^T dY (2P) and the weight and G terms (6).  Returns (ms,
    bound_by)."""
    Bc, Q, H, P = x.shape
    N = bm.shape[-1]
    item = x.element_size()
    nbytes = (2 * x.numel() * item + x.numel() * 4 + 2 * dt.numel() * 4
              + 2 * A.numel() * 4 + 4 * bm.numel() * item)
    ops = Bc * Q * (Q + 1) // 2 * (6 * N + H * (4 * P + 6))
    dtype = "bfloat16" if item == 2 else "float32"
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_ssd_backward(card) -> dict:
    """Phase 3, the SSD backward kernel against ``ref.ssd_bwd_reference``
    at hybrid training's shape (HYBRID_SSD: 2 x 2048 tokens in chunks of
    128), an odd one (Q and N not multiples of 16) and the largest chunk
    and state, bf16 and f32: each output within SSD_BWD_TOL of its largest
    entry, two launches bitwise equal, and chunk rows of the 32-row call
    equal to each row alone in every output but dA; each dtype's route
    from its plan (bf16 on tensor cores, f32 on SIMT); then timed at
    hybrid training's shape, each bf16 launch's device time by kernel name
    and ptxas's registers and spills for them.  Returns its kernel row
    (launches filled in by phase 11)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    names = ("dx", "ddt", "dA", "dB", "dC")
    worst = 0.0
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for shape in (HYBRID_SSD, (3, 72, 6, 32, 13), (2, 256, 8, 64, 128)):
            args = ssd_case(gen, *shape, dtype)
            dy = torch.randn(args[0].shape, generator=gen, device="cuda")
            got = ss.ssd_scan_bwd_cuda(*args, dy)
            again = ss.ssd_scan_bwd_cuda(*args, dy)
            want = ref.ssd_bwd_reference(*args, dy)
            torch.cuda.synchronize()
            errs = []
            for name, g, a, w in zip(names, got, again, want):
                if g.dtype != w.dtype or not torch.isfinite(g).all():
                    raise AssertionError(f"ssd backward {shape} {dtype_name}"
                                         f": {name} is {g.dtype} or not "
                                         f"finite")
                if not torch.equal(g, a):
                    raise AssertionError(f"ssd backward {shape} {dtype_name}"
                                         f": two launches differ in {name}")
                tol = SSD_BWD_TOL[str(g.dtype).split(".")[-1]]
                scale = float(w.float().abs().max()) + 1e-30
                err = float((g.float() - w.float()).abs().max()) / scale
                if err > tol:
                    raise AssertionError(
                        f"ssd backward {shape} {dtype_name}: {name} max err "
                        f"{err:.3e} of its max {scale:.3e}, tolerance {tol}")
                errs.append(err)
                if shape == HYBRID_SSD and dtype == torch.bfloat16:
                    worst = max(worst, err * scale)
            log(f"kernel check ssd_scan_bwd (Bc, Q, H, P, N)={shape} "
                f"{dtype_name}: "
                f"{', '.join(f'{n} {e:.2e}' for n, e in zip(names, errs))} "
                f"of each output's max (tol {SSD_BWD_TOL['bfloat16']} for "
                f"bf16 outputs, {SSD_BWD_TOL['float32']} for f32); two "
                f"launches bitwise equal")
            if shape == HYBRID_SSD:
                x, dt, A, bm, cm = args
                for k in (0, x.shape[0] // 2, x.shape[0] - 1):
                    one = ss.ssd_scan_bwd_cuda(
                        *(t[k:k + 1].contiguous() for t in (x, dt)), A,
                        *(t[k:k + 1].contiguous() for t in (bm, cm, dy)))
                    for i in (0, 1, 3, 4):
                        if not torch.equal(one[i][0], got[i][k]):
                            raise AssertionError(
                                f"ssd backward {dtype_name}: chunk row {k} "
                                f"alone differs from its rows of the "
                                f"{x.shape[0]}-row call in {names[i]}")
                log(f"kernel check ssd_scan_bwd {dtype_name}: rows (0, "
                    f"{x.shape[0] // 2}, {x.shape[0] - 1}) of the "
                    f"{x.shape[0]}-row call == each row alone in dx, ddt, dB, "
                    f"dC, bitwise")
            del args, dy, got, again, want
    for dtype_name, dtype in (("bf16", torch.bfloat16),
                              ("f32", torch.float32)):
        p = ss.plan_bwd(*HYBRID_SSD, dtype)
        log(f"route ssd_scan_bwd {dtype_name}: {p.route} ({p.grid[0]} "
            f"blocks of {p.head_group} heads, {p.threads} threads, "
            f"{p.smem} bytes of shared memory, runs of {p.chunk} subtiles, "
            f"triangles in shared memory {p.tri_smem}; reduce grid "
            f"{p.reduce_grid}, {p.reduce_smem} bytes)")

    args = ssd_case(gen, *HYBRID_SSD, torch.bfloat16)
    dy = torch.randn(args[0].shape, generator=gen, device="cuda")
    ms = time_ms(lambda: ss.ssd_scan_bwd_cuda(*args, dy))
    dev = device_ms(lambda: ss.ssd_scan_bwd_cuda(*args, dy))
    plain_ms = time_ms(lambda: ref.ssd_bwd_reference(*args, dy), iters=10)
    b_ms, b_by = ssd_bwd_bound_ms(*args[:4])
    log_launches(card, lambda: ss.ssd_scan_bwd_cuda(*args, dy),
                 SSD_BWD_LAUNCHES, f"ssd_scan_bwd {HYBRID_SSD} bf16")
    log_ptxas("ssd_scan", SSD_BWD_LAUNCHES)
    log(f"time ssd_scan_bwd (Bc, Q, H, P, N)={HYBRID_SSD} bf16 (hybrid "
        f"training): kernel {ms:.4f} ms (events), device {dev:.4f} ms "
        f"(profiler), plain {plain_ms:.4f} ms, library none, bound "
        f"{b_ms:.5f} ms ({b_by}) {card.tag()}")
    del args, dy
    free_card()
    return {"name": "ssd_scan_bwd", "route": "cuda",
            "source": SOURCES["ssd_scan_bwd"],
            "replaces": REPLACES["ssd_scan_bwd"], "launches": 0,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


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


def breakdown(card, label, engines, run, idle_ok=()) -> None:
    """Run ``run()`` with each engine's layers of work timed on the host
    clock, the device synchronised around each (which slows the run a
    little), summed over ``engines``; eviction is the ranking of pages to
    demote, host work only.  The wrappers go on the ``Engine`` objects
    themselves (``llm.engine`` is the ``Router``, which an engine never
    calls through); a layer that records no time raises unless
    ``idle_ok`` names it (a run that moves no page)."""
    import torch

    spent = {}
    inside = []
    wrapped = set()

    def timed(obj, attr, what):
        fn = getattr(obj, attr)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            inside.append(what)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                inside.pop()
                dt = time.perf_counter() - t
                spent[what] = spent.get(what, 0.0) + dt
                if what == "migration" and "guidance" in inside:
                    spent["guidance"] = spent.get("guidance", 0.0) - dt

        setattr(obj, attr, wrapper)
        wrapped.add(what)

    for eng in engines:
        timed(eng, "_prefill", "prefill forward")
        timed(eng, "_decode", "decode forward")
        for attr in ("exchange", "swap_in_many", "swap_out_many"):
            timed(eng.pool, attr, "migration")
        timed(eng.runtime, "on_step", "guidance")
        timed(eng.eviction, "pick_many", "eviction")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    idle = sorted(w for w in wrapped if spent.get(w, 0.0) <= 0.0)
    if set(idle) - set(idle_ok):
        raise AssertionError(f"breakdown {label}: {idle} recorded no time: "
                             f"the wrappers were not on the serving path")
    rest = wall - sum(spent.values())
    parts = ", ".join(f"{k} {v:.3f} s ({100 * v / wall:.1f}%)"
                      for k, v in sorted(spent.items(), key=lambda kv: -kv[1]))
    log(f"breakdown {label} (synchronised run, {wall:.3f} s): {parts}, rest "
        f"of the engine {rest:.3f} s ({100 * rest / wall:.1f}%) "
        f"{card.tag()}")


def where_time_goes(card, arch, cfg, prompts, params, label=None,
                    idle_ok=()) -> None:
    """The serving workload again on a fresh engine, through ``breakdown``
    on the single replica's engine (``idle_ok`` passes on).  ``label``
    names the run in the log (default ``arch``).  No profiled pass: the
    profiler slowed the host about eightfold here, and the passes of
    phases 4, 5 and 8b took 155.7 s of a run's 1200 s limit."""
    from repro_torch.serve import LLM

    label = label or arch
    llm = LLM.from_arch(arch, smoke=False, cfg=cfg, seed=SEED, device="cuda")
    breakdown(card, label, [llm.cluster.replicas[0].engine],
              lambda: llm.generate(prompts, params), idle_ok)
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


# What each main run left for later phases: its streams, launches, wall
# time and the device bytes its LLM took when built ({label: dict}).
RUNS = {}


def main_run(card, arch, cfg, n_req, n_prompt, n_new, rng, label=None):
    """The main path: ``LLM.from_arch(arch, smoke=False).generate`` on 8
    requests (request 3 sampled), launch counters zeroed just before and
    read just after.  Records the run in ``RUNS[label or arch]``.  Returns
    (llm, prompts, params, wall, launches)."""
    import torch

    from repro_torch.serve import LLM, SamplingParams

    # Collect earlier phases' garbage on both sides of the build: a tensor
    # freed by a collection inside it would count against the build.
    free_card()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    llm = LLM.from_arch(arch, smoke=False, cfg=cfg, seed=SEED, device="cuda")
    free_card()
    built = torch.cuda.memory_allocated() - before
    mc = llm.engine.model.cfg
    moe = (f", {mc.n_experts} experts top-{mc.top_k}"
           if mc.family == "moe" else "")
    log(f"model {arch}: {mc.n_layers} layers, d_model {mc.d_model}, "
        f"{mc.n_heads}/{mc.kv_heads} heads, d_ff {mc.d_ff}{moe}, vocab "
        f"{mc.vocab}, {mc.dtype}; page {llm.engine.pool.page_bytes} bytes; "
        f"built in {time.perf_counter() - t0:.1f} s, {built} bytes on the "
        f"device (memory_allocated) {card.tag()}")
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
    RUNS[label or arch] = dict(streams=[o.token_ids for o in outs],
                               launches=launches, wall=wall, built=built,
                               tokens=tokens)
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
    llm, cfg, prompts, params, _, launches, rng = serving_run(card, DENSE)
    for name in ("paged_attention", "paged_prefill"):
        kernel_rows[name]["launches"] = launches[name]
    where_time_goes(card, DENSE, cfg, prompts, params)
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
    llm, cfg, prompts, params, _, launches, rng = serving_run(card, MOE)
    kernel_rows["moe_grouped_ffn"]["launches"] = launches["moe_grouped_ffn"]
    where_time_goes(card, MOE, cfg, prompts, params)
    model = llm.engine.model
    one_shot_equals_chunked(model,
                            rng.integers(0, model.cfg.vocab, 64).tolist())
    one_shot_equals_chunked(model, long_prompt(model.cfg.vocab))
    del llm, model
    free_card()
    f32_check(MOE, rng)


# ------------------------------------------- prefix sharing, expert tiering
# Phase 8a: 8 requests, each one shared 448-token prefix (28 full pages)
# and 64 tokens of its own, 32 new tokens, on phase 4's ServeConfig.
PREFIX_REQ, PREFIX_SHARED, PREFIX_OWN, PREFIX_NEW = 8, 448, 64, 32
# Phase 8b: phase 5's workload with a quarter of granite's 1280 (layer,
# expert) blocks in the expert cache (at least one prefill's 40).
EXPERT_CACHE = 320


def prefix_workload(vocab: int):
    """Phase 8a's prompts and SamplingParams (request 3 sampled, as in
    phase 4), from a generator of their own."""
    import numpy as np

    from repro_torch.serve import SamplingParams

    rng = np.random.default_rng(SEED + 8)
    shared = rng.integers(0, vocab, PREFIX_SHARED).tolist()
    prompts = [shared + rng.integers(0, vocab, PREFIX_OWN).tolist()
               for _ in range(PREFIX_REQ)]
    params = [SamplingParams(max_tokens=PREFIX_NEW)
              for _ in range(PREFIX_REQ)]
    params[3] = SamplingParams(max_tokens=PREFIX_NEW, temperature=0.8,
                               top_k=40, top_p=0.9, seed=7)
    return prompts, params


def prefix_run(card, label, cache, first_alone=False, **extra):
    """Serve phase 8a's workload through ``LLM.submit``/``step`` on a fresh
    ``llama3_2_1b`` (prefix cache on or off), the counters zeroed just
    before and read just after.  ``first_alone``: request 0 runs its
    prefill before the others are submitted (an interleaved prefill
    inserts its prefix only when it completes).  Logs and returns (streams,
    stats, launches)."""
    import torch

    from repro_torch.serve import LLM, ServeConfig

    fields = dict(SERVING[DENSE][0], enable_prefix_cache=cache, **extra)
    llm = LLM.from_arch(DENSE, smoke=False, cfg=ServeConfig(**fields),
                        seed=SEED, device="cuda")
    prompts, params = prefix_workload(llm.engine.model.cfg.vocab)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    handles = [llm.submit(prompts[0], params[0])]
    if first_alone:
        while llm.engine.requests[0].state != "active":
            llm.step()
    handles += [llm.submit(p, sp) for p, sp in zip(prompts[1:], params[1:])]
    first = {}
    while any(not h.finished for h in handles):
        llm.step()
        for h in handles:
            if h.token_ids and h.request_id not in first:
                first[h.request_id] = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = llm.stats()
    streams = [h.result().token_ids for h in handles]
    if any(len(t) != PREFIX_NEW for t in streams):
        raise AssertionError(f"prefix {label}: stream lengths "
                             f"{[len(t) for t in streams]}")
    L = llm.engine.model.cfg.n_layers
    if (launches["paged_prefill"] != L * st["prefill_dispatches"]
            or launches["paged_attention"] < L * st["decode_dispatches"]
            or launches["paged_prefill"] == 0):
        raise AssertionError(f"prefix {label}: launches {launches} for "
                             f"{st['prefill_dispatches']} prefill and "
                             f"{st['decode_dispatches']} decode passes")
    ttft = sorted(first.values())
    log(f"prefix {label}: saved_prefill_tokens "
        f"{st['saved_prefill_tokens']}, prefill_tokens "
        f"{st['prefill_tokens']}, prefill passes "
        f"{st['prefill_dispatches']}, paged_prefill launches "
        f"{launches['paged_prefill']}, paged_attention launches "
        f"{launches['paged_attention']}, pages migrated "
        f"{st['swap_ins'] + st['swap_outs']} ({st['swap_ins']} in, "
        f"{st['swap_outs']} out), prefix hits "
        f"{st.get('prefix_hit_requests', 0)}, cached pages "
        f"{st.get('prefix_cached_pages', 0)}, reclaimed "
        f"{st.get('prefix_evicted_pages', 0)}; "
        f"{PREFIX_REQ * PREFIX_NEW / wall:.2f} generated tokens/s in "
        f"{wall:.3f} s, first token after {ttft[0]:.3f} s (first request) "
        f"and {sum(ttft) / len(ttft):.3f} s (mean of {len(ttft)}) "
        f"{card.tag()}")
    del llm, handles
    free_card()
    return streams, st, launches


def serve_prefix(card) -> None:
    """Phase 8a: the prefix cache on dense serving, bitwise."""
    off, _, _ = prefix_run(card, "cache off", False)
    on, st, _ = prefix_run(card, "cache on", True)
    if on != off:
        raise AssertionError("prefix cache on: streams differ from the "
                             "cache-off run")
    want = (PREFIX_REQ - 1) * PREFIX_SHARED
    if st["saved_prefill_tokens"] != want and not st["prefix_evicted_pages"]:
        raise AssertionError(f"prefix cache on: saved "
                             f"{st['saved_prefill_tokens']} prompt tokens, "
                             f"expected {want}")
    log(f"prefix cache on == off: {PREFIX_REQ} streams of {PREFIX_NEW} "
        f"tokens bitwise equal; {st['saved_prefill_tokens']} prompt tokens "
        f"served from the cache (expected {want} unless a prefix was "
        f"reclaimed: {st['prefix_evicted_pages']} pages reclaimed)")
    chunked, cst, _ = prefix_run(card, "cache on, prefill_chunk_tokens=64",
                                 True, first_alone=True,
                                 prefill_chunk_tokens=64)
    if chunked != on:
        raise AssertionError("prefix cache on, chunked prefill: streams "
                             "differ from the one-shot run")
    if not cst["saved_prefill_tokens"]:
        raise AssertionError("prefix cache on, chunked prefill: no hit")
    log(f"prefix cache, chunked (64-token chunks) == one-shot: streams "
        f"bitwise equal, {cst['saved_prefill_tokens']} prompt tokens from "
        f"the cache")


def serve_tiered(card, kernel_rows) -> None:
    """Phase 8b: phase 5's workload with the expert weights in pinned host
    memory and EXPERT_CACHE blocks on the card, bitwise equal to phase 5's
    resident run, then double buffering off == on."""
    import numpy as np
    import torch

    from repro_torch.serve import LLM, ServeConfig

    fields, n_req, n_prompt, n_new, seed = SERVING[MOE]
    cfg = ServeConfig(**fields, expert_offchip=True,
                      expert_cache_size=EXPERT_CACHE)
    llm, prompts, params, wall, launches = main_run(
        card, MOE, cfg, n_req, n_prompt, n_new,
        np.random.default_rng(seed), label="tiered")
    tiered, resident = RUNS["tiered"], RUNS[MOE]
    if tiered["streams"] != resident["streams"]:
        raise AssertionError("tiered experts: streams differ from phase 5's "
                             "resident run")
    name = "moe_grouped_ffn"
    if launches[name] != resident["launches"][name]:
        raise AssertionError(f"tiered experts: {launches[name]} grouped-FFN "
                             f"launches, resident {resident['launches'][name]}")
    store = llm.engine.expert_store
    st = llm.stats()
    drop = resident["built"] - tiered["built"]
    need = (store.n_layers * store.n_experts - EXPERT_CACHE) \
        * store.block_bytes
    if drop < need:
        raise AssertionError(f"tiered experts: the engine took {drop} fewer "
                             f"device bytes than the resident one, less than "
                             f"the {need} of the blocks off the card")
    passes = st["decode_dispatches"] + st["prefill_dispatches"]
    log(f"tiered experts == resident: {n_req} streams bitwise equal, "
        f"{launches[name]} grouped-FFN launches in both; cache "
        f"{EXPERT_CACHE} of {store.n_layers * store.n_experts} blocks of "
        f"{store.block_bytes} bytes; memory_allocated after build "
        f"{tiered['built']} vs resident {resident['built']}: {drop} bytes "
        f"less (>= {need}) {card.tag()}")
    log(f"tiered experts: demand fetches {st['expert_demand_fetches']}, "
        f"prefetches {st['expert_prefetch_fetches']}, prefetch hits "
        f"{st['expert_prefetch_hits']}, dropped prefetches "
        f"{st['expert_dropped_prefetches']}, evictions "
        f"{st['expert_evictions']}, bytes fetched "
        f"{st['expert_bytes_fetched']}; host syncs "
        f"{st['expert_host_syncs']} ({st['expert_host_syncs'] / passes:.1f} "
        f"a pass over {passes} passes, "
        f"{st['expert_host_syncs'] / st['steps']:.1f} an engine step); "
        f"{tiered['tokens'] / wall:.2f} generated tokens/s against the "
        f"resident run's {resident['tokens'] / resident['wall']:.2f} "
        f"{card.tag()}")
    del llm, store
    free_card()
    streams = {}
    for db in (False, True):
        cfg = ServeConfig(**fields, expert_offchip=True,
                          expert_cache_size=EXPERT_CACHE,
                          expert_double_buffer=db)
        llm = LLM.from_arch(MOE, smoke=False, cfg=cfg, seed=SEED,
                            device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = llm.generate(prompts[:2], params[:2])
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        streams[db] = [o.token_ids for o in outs]
        st = llm.stats()
        log(f"tiered experts, 2 requests, double buffer {db}: "
            f"{2 * n_new / t:.2f} generated tokens/s in {t:.3f} s, demand "
            f"fetches {st['expert_demand_fetches']}, prefetch hits "
            f"{st['expert_prefetch_hits']}, host syncs "
            f"{st['expert_host_syncs']} {card.tag()}")
        del llm
        free_card()
    if streams[False] != streams[True] \
            or streams[True] != resident["streams"][:2]:
        raise AssertionError("tiered experts: double buffer on, off and the "
                             "resident run differ")
    log("tiered experts: double buffer off == on == resident, bitwise")
    where_time_goes(card, MOE, cfg, prompts[:2], params[:2],
                    label=f"{MOE} tiered, 2 requests",
                    idle_ok=("migration", "eviction"))


def serve_shared_tiers(card, kernel_rows) -> None:
    """Phase 8: prefix sharing on dense serving (8a), expert tiering on MoE
    serving (8b)."""
    serve_prefix(card)
    serve_tiered(card, kernel_rows)


# ------------------------------------------------------- cluster serving
# Phase 9: phase 4's workload and ServeConfig with CLUSTER_HBM pages per
# replica, so that each replica's HBM holds about two of its sessions.
CLUSTER_HBM = 80
# Phase 9d's two-tenant trace: its arrival window in engine steps.
TRACE_HORIZON = 64


def cluster_workload(vocab: int):
    """Phase 4's prompts and SamplingParams (the same generator and draws
    as ``main_run``'s), so phase 9's streams can be held to phase 4's."""
    import numpy as np

    from repro_torch.serve import SamplingParams

    _, n_req, n_prompt, n_new, seed = SERVING[DENSE]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n_prompt).tolist()
               for _ in range(n_req)]
    params = [SamplingParams(max_tokens=n_new) for _ in range(n_req)]
    params[3] = SamplingParams(max_tokens=n_new, temperature=0.8, top_k=40,
                               top_p=0.9, seed=7)
    return prompts, params


def cluster_cfg(**extra):
    from repro_torch.serve import ServeConfig

    return ServeConfig(**dict(SERVING[DENSE][0], hbm_pages=CLUSTER_HBM,
                              **extra))


def log_cluster_run(card, label, llm, wall, n_tokens, launches) -> dict:
    """Check a phase 9 run's paged launches against its passes (a removed
    replica's passes leave the stats, so at least) and log them with the
    wall time and ``serving_summary``'s cluster and migration keys."""
    from repro_torch.launch.analysis import serving_summary

    summary = serving_summary(llm.engine)
    L = llm.cluster.replicas[0].engine.model.cfg.n_layers
    for name, key in (("paged_attention", "engine_decode_dispatches"),
                      ("paged_prefill", "engine_prefill_dispatches")):
        if launches[name] == 0 or launches[name] < L * summary[key]:
            raise AssertionError(f"cluster {label}: {launches[name]} "
                                 f"{name} launches for {summary[key]} "
                                 f"passes of {L} layers")
    keys = ("cluster_replicas", "cluster_migrations_warm",
            "cluster_migrations_cold", "cluster_failovers",
            "cluster_restarts", "cluster_requests_lost", "engine_steps",
            "engine_prefill_dispatches", "engine_decode_dispatches",
            "engine_swap_ins", "engine_swap_outs", "engine_exported_pages",
            "engine_imported_pages", "engine_preemptions", "intervals",
            "migrations")
    shown = ", ".join(f"{k} {summary[k]:g}" for k in keys if k in summary)
    log(f"cluster {label}: {n_tokens / wall:.2f} generated tokens/s in "
        f"{wall:.3f} s; paged_attention {launches['paged_attention']}, "
        f"paged_prefill {launches['paged_prefill']} launches; "
        f"serving_summary: {shown} {card.tag()}")
    return summary


def cluster_run(card, model, label, replicas, drive=None, **kw):
    """Phase 4's workload through ``LLM(model, cfg, replicas=N)``, the
    launch counters zeroed just before and read just after.  ``drive``
    submits (and may step, fail, drain or restart) and returns the
    handles; the run then steps to the end.  Returns (streams, llm,
    summary)."""
    import torch

    from repro_torch.serve import LLM

    prompts, params = cluster_workload(model.cfg.vocab)
    llm = LLM(model, cluster_cfg(), replicas=replicas, **kw)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    if drive is None:
        handles = [llm.submit(p, sp, request_id=i)
                   for i, (p, sp) in enumerate(zip(prompts, params))]
    else:
        handles = drive(llm, prompts, params)
    while any(not h.finished for h in handles):
        llm.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    streams = [h.result().token_ids for h in handles]
    n_new = SERVING[DENSE][3]
    if any(len(t) != n_new for t in streams):
        raise AssertionError(f"cluster {label}: stream lengths "
                             f"{[len(t) for t in streams]}")
    summary = log_cluster_run(card, label, llm, wall,
                              sum(map(len, streams)), launches)
    return streams, llm, summary


def cluster_chaos(card, model, want) -> dict:
    """Phases 9b and 9c: a crash, a drain, a rolling restart, each held to
    the single replica's streams.  Returns each run's summary."""
    out = {}
    seen = {}

    def crash(llm, prompts, params):
        handles = [llm.submit(p, sp, request_id=i)
                   for i, (p, sp) in enumerate(zip(prompts, params))]
        for _ in range(2):
            llm.step()
        seen["orphaned"] = sorted(rid for rid, rep in
                                  llm.cluster.owner.items()
                                  if rep.replica_id == 0)
        llm.cluster.fail(0)
        return handles

    streams, llm, out["crash"] = cluster_run(card, model, "9b crash", 3,
                                             crash, heartbeat_timeout=2.0)
    c = llm.cluster
    if streams != want or c.failovers != 1 \
            or c.migrations_cold != len(seen["orphaned"]) \
            or c.requests_lost:
        raise AssertionError(f"cluster crash: streams equal "
                             f"{streams == want}, failovers {c.failovers}, "
                             f"cold {c.migrations_cold} for "
                             f"{seen['orphaned']}, lost {c.requests_lost}")
    log(f"cluster 9b: replica 0 failed after 2 steps, detected after the "
        f"2-tick heartbeat timeout; {c.migrations_cold} requests "
        f"{seen['orphaned']} rebuilt cold on survivors; streams bitwise "
        f"equal to one replica")
    del llm, c
    free_card()

    def drain(llm, prompts, params):
        handles = [llm.submit(p, sp, request_id=i)
                   for i, (p, sp) in enumerate(zip(prompts, params))]
        for _ in range(3):
            llm.step()
        src = llm.cluster.replicas[0].engine
        owned = sorted(src.requests)
        pages = [p for rid in owned for p in src.pool.request_pages(rid)]
        seen.update(owned=owned, pages=len(pages),
                    host=sum(p.hbm_slot is None for p in pages))
        seen["moved"] = llm.cluster.drain(0)
        llm.cluster.remove_replica(0)
        return handles

    streams, llm, out["drain"] = cluster_run(card, model, "9c drain", 3,
                                             drain)
    c = llm.cluster
    imported = out["drain"]["engine_imported_pages"]
    if streams != want or c.migrations_cold or seen["moved"] != len(
            seen["owned"]) or c.migrations_warm != seen["moved"] \
            or imported <= 0 or seen["host"] <= 0:
        raise AssertionError(f"cluster drain: streams equal "
                             f"{streams == want}, {seen}, warm "
                             f"{c.migrations_warm}, cold "
                             f"{c.migrations_cold}, imported {imported}")
    log(f"cluster 9c: replica 0 drained after 3 steps: {seen['moved']} "
        f"requests {seen['owned']} moved warm with {seen['pages']} pages "
        f"({seen['host']} from the host tier), {imported:g} imported; "
        f"streams bitwise equal to one replica")
    del llm, c
    free_card()

    def rolling(llm, prompts, params):
        handles = [llm.submit(p, sp, request_id=i)
                   for i, (p, sp) in enumerate(zip(prompts[:5], params))]
        for _ in range(2):
            llm.step()
        for i, rep_id in enumerate([r.replica_id
                                    for r in llm.cluster.replicas]):
            llm.cluster.restart_replica(rep_id)
            # Submissions keep landing while the restart sweeps.
            handles.append(llm.submit(prompts[5 + i], params[5 + i],
                                      request_id=5 + i))
            llm.step()
        return handles

    streams, llm, out["rolling"] = cluster_run(card, model,
                                               "9c rolling restart", 3,
                                               rolling)
    c = llm.cluster
    if streams != want or c.restarts != 3 or c.requests_lost:
        raise AssertionError(f"cluster rolling restart: streams equal "
                             f"{streams == want}, restarts {c.restarts}, "
                             f"lost {c.requests_lost}")
    log(f"cluster 9c: rolling restart of all 3 replicas under load, "
        f"{c.migrations_warm} warm and {c.migrations_cold} cold moves, "
        f"nothing lost; streams bitwise equal to one replica")
    del llm, c
    free_card()
    return out


def cluster_trace(card, model) -> None:
    """Phase 9d: a two-tenant trace from ``synthesize`` replayed through
    ``TraceReplayer`` on two replicas, eagerly under the priority policy
    and with 256-token interleaved prefill under DRR: equal streams."""
    import torch

    from repro_torch.serve import (LLM, SLO, TenantSpec, TraceReplayer,
                                   WorkloadConfig, synthesize)

    trace = synthesize(WorkloadConfig(tenants=(
        TenantSpec(name="chat", arrival="poisson", rate=0.25,
                   prompt_mix=((128, 2.0), (512, 1.0)),
                   output_mix=((32, 1.0),), temperature=0.7),
        TenantSpec(name="batch", arrival="bursty", rate=0.2,
                   burst_factor=4.0, burst_period=32, burst_duty=0.25,
                   priority=1, prompt_mix=((768, 1.0),),
                   output_mix=((16, 1.0),), deadline_steps=64),
    ), horizon_steps=TRACE_HORIZON, vocab=model.cfg.vocab, seed=0))
    tenants = {t: sum(r.tenant == t for r in trace.requests)
               for t in ("chat", "batch")}
    log(f"cluster 9d: trace of {len(trace)} requests ({tenants}) over "
        f"{TRACE_HORIZON} steps, "
        f"{sum(len(r.prompt) for r in trace.requests)} prompt tokens")
    runs = {}
    for label, extra in (("eager, priority", dict(scheduler="priority")),
                         ("prefill_chunk_tokens=256, drr",
                          dict(scheduler="drr", prefill_chunk_tokens=256))):
        llm = LLM(model, cluster_cfg(**extra), replicas=2)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        report = TraceReplayer(llm, trace).run(max_steps=4096)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        n_tokens = sum(map(len, report.token_ids.values()))
        log_cluster_run(card, f"9d replay {label}", llm, wall, n_tokens,
                        launches)
        s = report.summary(slo=SLO())
        if s["finished"] != len(trace):
            raise AssertionError(f"cluster replay {label}: {s}")
        log(f"cluster 9d replay {label}: {report.steps_run} steps, modeled "
            f"{report.modeled_ms:.1f} ms; modeled TTFT p50 "
            f"{s['p50_ttft_ms']:.1f} / p99 {s['p99_ttft_ms']:.1f} ms, TPOT "
            f"p50 {s['p50_tpot_ms']:.1f} / p99 {s['p99_tpot_ms']:.1f} ms, "
            f"goodput {s['goodput_slo']:.3f} (SLO {SLO().ttft_ms:g} / "
            f"{SLO().tpot_ms:g} ms modeled); wall clock "
            f"{n_tokens / wall:.2f} generated tokens/s ({n_tokens} tokens "
            f"in {wall:.3f} s) {card.tag()}")
        runs[label] = report.token_ids
        del llm
        free_card()
    a, b = runs.values()
    if a != b:
        raise AssertionError("cluster replay: eager and interleaved streams "
                             "differ")
    log(f"cluster 9d: the two replays' token_ids are equal "
        f"({len(a)} requests)")


def cluster_launcher(card) -> None:
    """Phase 9e: the serving launcher with two replicas and a rolling
    restart, as a user would run it."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", DENSE,
           "--replicas", "2", "--rolling-restart", "--sessions", "8",
           "--rounds", "8", "--prompt-len", "512"]
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=HERE, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"launcher exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    stats = json.loads(out.stdout)
    if stats["cluster_restarts"] != 2 or stats["cluster_requests_lost"]:
        raise AssertionError(f"launcher: restarts "
                             f"{stats['cluster_restarts']}, lost "
                             f"{stats['cluster_requests_lost']}")
    log(f"cluster 9e: {' '.join(cmd[1:])} exited 0 in "
        f"{time.perf_counter() - t0:.1f} s: restarts "
        f"{stats['cluster_restarts']:g}, lost "
        f"{stats['cluster_requests_lost']:g}, warm "
        f"{stats['cluster_migrations_warm']:g}, cold "
        f"{stats['cluster_migrations_cold']:g}, imported pages "
        f"{stats['engine_imported_pages']:g}, "
        f"{stats['tokens_per_second']} tokens/s {card.tag()}")


def serve_cluster(card, kernel_rows) -> None:
    """Phase 9: ``llama3_2_1b`` at its published widths served by a
    ``Router`` of engine replicas on the card: N=3 == N=1, a crash, a
    drain, a rolling restart, a trace replay and the launcher."""
    from repro_torch.serve import LLM

    llm = LLM.from_arch(DENSE, smoke=False, cfg=cluster_cfg(), seed=SEED,
                        device="cuda")
    model = llm.engine.model
    del llm
    free_card()
    want, llm, _ = cluster_run(card, model, "9a one replica", 1)
    del llm
    free_card()
    if DENSE in RUNS:
        if RUNS[DENSE]["streams"] != want:
            raise AssertionError("cluster, one replica: streams differ from "
                                 "phase 4's")
        log(f"cluster 9a: one replica at {CLUSTER_HBM} HBM pages == phase "
            f"4's run at {SERVING[DENSE][0]['hbm_pages']}, bitwise")
    got, llm, _ = cluster_run(card, model, "9a three replicas", 3)
    if got != want:
        raise AssertionError("cluster: three replicas' streams differ from "
                             "one replica's")
    log("cluster 9a: three replicas == one replica, bitwise")
    del llm
    free_card()
    # Where 9a's time goes, at one replica and at three (summed over the
    # replicas' engines, which step one after another).
    prompts, params = cluster_workload(model.cfg.vocab)
    for n in (1, 3):
        llm = LLM(model, cluster_cfg(), replicas=n)
        breakdown(card, f"cluster 9a, {n} replica(s)",
                  [r.engine for r in llm.cluster.replicas],
                  lambda: llm.generate(prompts, params))
        del llm
        free_card()
    cluster_chaos(card, model, want)
    cluster_trace(card, model)
    del model
    free_card()
    cluster_launcher(card)


# ---------------------------------------------------------------- training
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 2, 2048
# Phase 10: MoE training steps a run; granite's routed rows a layer.
MOE_TRAIN_STEPS = 6
MOE_TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ * 8


def per_step_launches(cfg, steps: int) -> dict:
    """Kernel launches a training run makes under remat: each layer's
    forward twice (the step's and the recompute's) and its backward once.
    The hybrid family's shared block runs outside the checkpoints, as in
    the JAX package: its flash forward runs once an application.  The
    encoder-decoder's flash calls a step: one per encoder layer and two per
    decoder layer (self and cross attention); the xLSTM family launches
    none, and the MoE family's capacity dispatch no grouped-expert
    kernel."""
    if cfg.family == "xlstm":
        return {}
    if cfg.family == "encdec":
        n_attn = cfg.enc_layers + 2 * cfg.n_layers
        return {"flash_attention_fwd": 2 * n_attn * steps,
                "flash_attention_bwd": n_attn * steps}
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        return {"ssd_scan": 2 * cfg.n_layers * steps,
                "ssd_scan_bwd": cfg.n_layers * steps,
                "flash_attention_fwd": n_attn * steps,
                "flash_attention_bwd": n_attn * steps}
    out = {"flash_attention_fwd": 2 * cfg.n_layers * steps,
           "flash_attention_bwd": cfg.n_layers * steps}
    if cfg.family == "moe" and cfg.moe_dispatch == "dropless":
        out.update({"moe_grouped_ffn": 2 * cfg.n_layers * steps,
                    "moe_grouped_ffn_bwd": cfg.n_layers * steps})
    return out


def train_run(card, label, cfg, batches, gdt):
    """One ``Trainer.run`` of one step a batch from the seeded init, the
    launch counters zeroed just before and read just after.  Each step ends
    in the host reading its loss, so the times between steps are
    synchronised step times.  Returns (losses, launches, trainer)."""
    import torch

    from repro_torch.models import Model
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import Trainer, TrainerConfig

    steps = len(batches)
    model = Model(cfg, device="cuda")
    opt = AdamW(lr=cosine_schedule(3e-4, warmup=1, total=steps))
    trainer = Trainer(model, opt, TrainerConfig(steps=steps,
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
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training {label}: losses {losses}")
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    wall = stamps[-1] - stamps[0]
    # Positions a step: the tokens, and the VLM's patches before them.
    per_batch = sum(batches[0][k].shape[0] * batches[0][k].shape[1]
                    for k in ("tokens", "patches") if k in batches[0])
    tokens = steps * per_batch
    log(f"training {label}: losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}")
    steady = 1e3 * (steps - 1) * per_batch / sum(step_ms[1:])
    log(f"training {label}: step ms {', '.join(f'{t:.1f}' for t in step_ms)}"
        f"; {wall:.3f} s for {steps} steps, {tokens / wall:.1f} "
        f"training tokens/s ({steady:.1f} after the first step) "
        f"{card.tag()}")
    log(f"training {label}: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB {card.tag()}")
    per_step = per_step_launches(cfg, steps)
    for name, n in per_step.items():
        if launches[name] != n:
            raise AssertionError(f"training {label} {name}: "
                                 f"{launches[name]} launches, expected {n} "
                                 f"(remat: 2 forwards and 1 backward per "
                                 f"layer and step)")
    for name, n in launches.items():
        if name not in per_step and n:
            raise AssertionError(f"training {label}: {n} launches of {name}"
                                 f", which its path does not run")
    log(f"training {label}: launches "
        f"{', '.join(f'{n} {launches[n]}' for n in per_step)}")
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
    its gradient), MoE layers through ``plain_moe_train``, one cross
    entropy over the whole logits."""
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
        if model.moe_cfg is not None:
            x = x + plain_moe_train(p, h2, model.moe_cfg)
            continue
        g = torch.einsum("bsd,df->bsf", h2, p["mlp.w_gate"])
        u = torch.einsum("bsd,df->bsf", h2, p["mlp.w_up"])
        x = x + torch.einsum("bsf,fd->bsd",
                             F.silu(g.to(f32)).to(x.dtype) * u,
                             p["mlp.w_down"])
    x = norm(params["final_ln.scale"], x)
    logits = torch.einsum("bsd,dv->bsv", x, params["head.w"]).to(f32)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def plain_moe_train(p, h, cfg):
    """A plain MoE layer for training: f32 router logits by one product,
    softmax, ``torch.topk``, renormalised gates; the picks sorted by
    expert, the plain grouped FFN with its plain backward; the
    gate-weighted rows summed per token by ``index_add``."""
    import torch

    from repro_torch.kernels import ref

    class PlainFFN(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, wg, wu, wd, sizes):
            ctx.save_for_backward(x, wg, wu, wd, sizes)
            return ref.moe_grouped_ffn_reference(x, wg, wu, wd, sizes)

        @staticmethod
        def backward(ctx, dy):
            x, wg, wu, wd, sizes = ctx.saved_tensors
            return (*ref.moe_grouped_ffn_bwd_reference(
                x, wg, wu, wd, sizes, None, dy), None)

    f32 = torch.float32
    B, S, d = h.shape
    T, k = B * S, cfg.top_k
    hf = h.reshape(T, d)
    probs = (hf.to(f32) @ p["moe.router"]).softmax(-1)
    gates, experts = probs.topk(k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    order = torch.argsort(experts.reshape(-1), stable=True)
    tok = order // k
    sizes = torch.bincount(experts.reshape(-1),
                           minlength=cfg.n_experts).to(torch.int32)
    ys = PlainFFN.apply(hf[tok], p["moe.w_gate"], p["moe.w_up"],
                        p["moe.w_down"], sizes)
    contrib = ys.to(f32) * gates.reshape(-1)[order][:, None]
    y = torch.zeros((T, d), dtype=f32, device=h.device).index_add(
        0, tok, contrib)
    return y.to(h.dtype).reshape(B, S, d)


def train_f32_check(batch, arch: str = DENSE) -> None:
    """The f32 model cut to F32_CHECK_LAYERS layers (the hybrid family to
    HYBRID_CHECK_LAYERS, a segment of 6 and a remainder layer, on
    HYBRID_CHECK_PROMPT tokens: two SSD chunks): the kernel path's loss
    and gradients (``train.step.value_and_grad``: ``Model.loss``, the
    flash, grouped-expert and SSD kernels, remat) against a plain path's
    (``plain_loss``; for the hybrid family ``Model.loss`` under
    ``plain_kernels``), each gradient leaf within 1e-4 of the plain one in
    norm."""
    import torch

    from repro_torch.configs import get
    from repro_torch.models import Model
    from repro_torch.train import value_and_grad

    hybrid = arch == HYBRID
    n_layers = HYBRID_CHECK_LAYERS if hybrid else F32_CHECK_LAYERS
    if hybrid:
        batch = {k: v[:, :HYBRID_CHECK_PROMPT] for k, v in batch.items()}
    model = Model(dataclasses.replace(get(arch), n_layers=n_layers,
                                      dtype=torch.float32), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(SEED + 5))
    params = dict(model.named_parameters())
    before = read_launches()
    loss, grads = value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    after = read_launches()
    for name in per_step_launches(model.cfg, 1):
        if after[name] == before[name]:
            raise AssertionError(f"f32 training check ({arch}): the kernel "
                                 f"path launched no {name}")
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    reset_launches()
    # The backward recomputes the remat layers: it too runs in the context.
    with plain_kernels() if hybrid else contextlib.nullcontext():
        want = (model.loss(batch, leaves) if hybrid
                else plain_loss(model, leaves, batch))
        want_grads = dict(zip(leaves, torch.autograd.grad(
            want, list(leaves.values()))))
    torch.cuda.synchronize()
    if any(read_launches().values()):
        raise AssertionError(f"the plain path launched kernels: "
                             f"{read_launches()}")
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
    log(f"f32 kernel-path loss and gradients vs plain path ({arch}, "
        f"{n_layers} layers, B={TRAIN_BATCH} S={batch['tokens'].shape[1]}): "
        f"loss {float(loss):.6f} vs {want:.6f} (rel {rel_loss:.3e}), worst "
        f"gradient {worst_name} rel err {worst:.3e} in norm (tol 1e-4)")
    del model, params, grads, leaves, want_grads
    free_card()


def profile_training(card, trainer, batches,
                     shares=(("flash attention", "flash_"),)) -> None:
    """Two more unguided steps under ``torch.profiler``: the device's busy
    time by kernel, its idle share over the two steps' wall time (the
    profiler slows the host, not the kernels), and the share of each
    ``(label, kernel name part)`` of ``shares``."""
    trainer.cfg.steps = len(batches)
    events, wall = profiled(lambda: trainer.run(iter(batches)), "training")
    if events is None:
        log(f"device training: not measured (the profiler saw no device "
            f"time) {card.tag()}")
        return
    busy = sum(dev_us(e) for e in events) / 1e6
    log(f"device training: kernels and copies busy {busy:.3f} s of "
        f"{wall:.3f} s for {len(batches)} profiled steps: idle share "
        f"{100 * max(0.0, 1 - busy / wall):.1f}% {card.tag()}")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        log(f"  device {dev_us(e) / 1e3:10.2f} ms  calls {e.count:7d}  "
            f"{e.key[:90]}")
    for what, needle in shares:
        log_kernel_share(card, "training", events, busy, what, needle)


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


def moe_layer_backward_twice(model, params) -> None:
    """Layer 0's MoE block at full width on TRAIN_BATCH x TRAIN_SEQ random
    rows: two backward passes of a random projection give the same bits
    in the input's and every parameter's gradient."""
    from types import SimpleNamespace

    import torch

    from repro_torch.models.moe import moe

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model)
    h = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype)
    proj = torch.randn(shape, generator=gen, device="cuda")
    names = ("router", "w_gate", "w_up", "w_down")
    runs = []
    for _ in range(2):
        leaves = [params[f"layers.0.moe.{w}"].detach().requires_grad_(True)
                  for w in names]
        x = h.clone().requires_grad_(True)
        y = moe(SimpleNamespace(**dict(zip(names, leaves))), x,
                model.moe_cfg)
        runs.append(torch.autograd.grad((y.float() * proj).sum(),
                                        [x, *leaves]))
    torch.cuda.synchronize()
    for name, a, b in zip(("x", *names), *runs):
        if not same_bits(a, b):
            raise AssertionError(f"MoE layer backward: two passes differ in "
                                 f"the gradient of {name}")
    log(f"MoE layer 0 backward at full width ({TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, {MOE_TRAIN_ROWS} routed rows): two passes bitwise equal "
        f"in x, router, w_gate, w_up, w_down gradients")


def train_moe(card, kernel_rows) -> None:
    """Phase 10: MoE training at the published widths, unguided then
    guided, a profiled pair of steps, the full-width layer backward twice,
    and the 2-layer f32 check."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.core import GuidanceConfig
    from repro_torch.data import SyntheticLM

    cfg = get(MOE)                         # bf16, remat on
    src = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to("cuda")
                for k, v in src.batch_np(i).items()}
               for i in range(MOE_TRAIN_STEPS)]
    log(f"model {MOE} training: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads, {cfg.n_experts} "
        f"experts top-{cfg.top_k}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}, remat {cfg.remat}; batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"{MOE_TRAIN_STEPS} steps a run")
    losses, launches, trainer = train_run(card, "moe unguided", cfg,
                                          batches, None)
    kernel_rows["moe_grouped_ffn_bwd"]["launches"] = \
        launches["moe_grouped_ffn_bwd"]
    profile_training(card, trainer, batches[:2],
                     (("flash attention", "flash_"),
                      ("grouped-expert (forward and backward)", "moe_"),
                      ("grouped-expert backward", "moe_bwd")))
    moe_layer_backward_twice(trainer.model, trainer.params)
    n_params = sum(p.numel() for p in trainer.params.values())
    state = sum(p.numel() * p.element_size()
                for p in trainer.params.values()) + 2 * 4 * n_params
    log(f"training state ({MOE}): {n_params} parameters, {state} bytes of "
        f"parameters and f32 moments")
    del trainer
    free_card()
    gdt = GuidanceConfig(enabled=True, fast_capacity_bytes=int(state * 0.6),
                         interval_steps=2, promotion_threshold=64 * 1024)
    guided, _, trainer = train_run(card, "moe guided", cfg, batches, gdt)
    if not np.allclose(guided, losses, rtol=1e-5, atol=0):
        raise AssertionError(f"MoE guided losses {guided} != unguided "
                             f"{losses} (rtol 1e-5)")
    if trainer.placer.slow_bytes() <= 0:
        raise AssertionError("MoE guided training kept nothing on pinned "
                             "host")
    log(f"MoE guided == unguided losses (rtol 1e-5), max rel diff "
        f"{max(abs(a - b) / abs(b) for a, b in zip(guided, losses)):.3e}; "
        f"{trainer.placer.slow_bytes()} bytes on pinned host")
    del trainer
    free_card()
    train_f32_check(batches[0], MOE)


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
    versions on any device: ``ref.ssd_reference`` per chunk (its gradient
    ``ref.ssd_bwd_reference``), ``ref.mha_reference`` (its gradient by
    autograd) and ``ref.moe_grouped_ffn_reference`` (forward only).  The
    comparison path of the f32 hybrid and contiguous-cache checks."""
    import torch

    from repro_torch.kernels import ops, ref

    class PlainSSD(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, A, bm, cm):
            ctx.save_for_backward(x, dt, A, bm, cm)
            return ref.ssd_reference(x, dt, A, bm, cm)

        @staticmethod
        def backward(ctx, dy):
            return ref.ssd_bwd_reference(*ctx.saved_tensors,
                                         dy.contiguous())

    saved = ops.ssd_scan, ops.flash_attention, ops.moe_grouped_ffn
    ops.ssd_scan = PlainSSD.apply
    ops.flash_attention = ref.mha_reference
    ops.moe_grouped_ffn = ref.moe_grouped_ffn_reference
    try:
        yield
    finally:
        ops.ssd_scan, ops.flash_attention, ops.moe_grouped_ffn = saved


def profile_contiguous(card, model, tokens, n_decode: int = 4,
                       label: str = "hybrid",
                       shares=(("flash attention", "flash_"),
                               ("SSD", "ssd_chunk")), **frontend) -> None:
    """One more prefill (of ``tokens`` and the ``frontend`` embeddings),
    then ``n_decode`` decode steps, each part under ``torch.profiler``
    recording the device only (recording every host operator too slows
    the xLSTM's 76,611-launch prefill pass by about half a minute): the
    device's busy time by kernel, and its idle share over the part's wall
    time (the profiler slows the host, not the kernels, so the idle share
    is an upper bound); the prefill's share of each ``(what, kernel name
    part)`` of ``shares``."""
    S = tokens.shape[1] + sum(t.shape[1] for k, t in frontend.items()
                              if k == "patches")
    cache = model.init_cache(tokens.shape[0], S + n_decode)
    state = {}

    def prefill():
        state["logits"], _ = model.prefill(tokens, cache, **frontend)

    def decode():
        logits = state["logits"]
        for pos in range(S, S + n_decode):
            logits, _ = model.decode(logits.argmax(-1), cache, pos)

    for part_label, part, top in (("prefill", prefill, 12),
                                  (f"{n_decode} decode steps", decode, 6)):
        events, wall = profiled(part, f"{label} {part_label}")
        if events is None:
            log(f"device {label} {part_label}: not measured (the profiler "
                f"saw no device time) {card.tag()}")
            continue
        busy = sum(dev_us(e) for e in events) / 1e6
        log(f"device {label} {part_label}: kernels and copies busy "
            f"{busy:.3f} s of {wall:.3f} s, {sum(e.count for e in events)} "
            f"launches: idle share {100 * max(0.0, 1 - busy / wall):.1f}% "
            f"{card.tag()}")
        for e in sorted(events, key=dev_us, reverse=True)[:top]:
            log(f"  device {dev_us(e) / 1e3:10.2f} ms  calls {e.count:7d}  "
                f"{e.key[:90]}")
        if part_label == "prefill":
            for what, needle in shares:
                log_kernel_share(card, f"{label} {part_label}", events, busy,
                                 what, needle)
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
    profile_contiguous(card, model, tokens)
    del model, tokens
    free_card()
    hybrid_f32_checks(rng)


# -------------------------------------------------------- hybrid training
# Phase 11: zamba2 at its published widths cut to 24 layers (four full
# segments of 6, the shared block applied 4 times; 2,306,193,792
# parameters, 27.7 GB of bf16 parameters and gradients and f32 moments):
# all 81 layers would need 81.0 GB of that state, more than the card.
HYBRID_TRAIN_LAYERS = 24
HYBRID_TRAIN_STEPS = 4


def train_hybrid(card, kernel_rows) -> None:
    """Phase 11: hybrid training at the published widths cut to
    HYBRID_TRAIN_LAYERS layers, unguided then guided, a profiled pair of
    steps, and the 7-layer f32 check."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.core import GuidanceConfig
    from repro_torch.data import SyntheticLM

    full = get(HYBRID)                     # bf16, remat on
    cfg = dataclasses.replace(full, n_layers=HYBRID_TRAIN_LAYERS)
    src = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to("cuda")
                for k, v in src.batch_np(i).items()}
               for i in range(HYBRID_TRAIN_STEPS)]
    log(f"model {HYBRID} training: {cfg.n_layers} of {full.n_layers} layers "
        f"(cut: all {full.n_layers} need 81.0 GB of bf16 parameters and "
        f"gradients and f32 moments, more than the card's 80 GB), d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads, shared block "
        f"every {cfg.attn_every} ({cfg.n_layers // cfg.attn_every} "
        f"applications), vocab {cfg.vocab}, {cfg.dtype}, remat {cfg.remat}; "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, {HYBRID_TRAIN_STEPS} steps a run")
    losses, launches, trainer = train_run(card, "hybrid unguided", cfg,
                                          batches, None)
    kernel_rows["ssd_scan_bwd"]["launches"] = launches["ssd_scan_bwd"]
    kernel_rows["flash_attention_bwd_dh112"]["launches"] = \
        launches["flash_attention_bwd"]
    profile_training(card, trainer, batches[:2],
                     (("flash attention", "flash_"),
                      ("SSD (forward and backward)", "ssd_"),
                      ("SSD backward", "ssd_bwd")))
    n_params = sum(p.numel() for p in trainer.params.values())
    state = sum(p.numel() * p.element_size()
                for p in trainer.params.values()) + 2 * 4 * n_params
    log(f"training state ({HYBRID}, {cfg.n_layers} layers): {n_params} "
        f"parameters, {state} bytes of parameters and f32 moments")
    del trainer
    free_card()
    gdt = GuidanceConfig(enabled=True, fast_capacity_bytes=int(state * 0.6),
                         interval_steps=2, promotion_threshold=64 * 1024)
    guided, _, trainer = train_run(card, "hybrid guided", cfg, batches, gdt)
    if not np.allclose(guided, losses, rtol=1e-5, atol=0):
        raise AssertionError(f"hybrid guided losses {guided} != unguided "
                             f"{losses} (rtol 1e-5)")
    if trainer.placer.slow_bytes() <= 0:
        raise AssertionError("hybrid guided training kept nothing on "
                             "pinned host")
    log(f"hybrid guided == unguided losses (rtol 1e-5), max rel diff "
        f"{max(abs(a - b) / abs(b) for a, b in zip(guided, losses)):.3e}; "
        f"{trainer.placer.slow_bytes()} bytes on pinned host")
    del trainer
    free_card()
    train_f32_check(batches[0], HYBRID)


# ------------------------------------------------ the new decoder configs
# Phase 12: granite_8b, minitron_4b and stablelm_3b whole at their
# published widths, 4 requests of 512 prompt + 16 new tokens (request 3
# sampled), max_batch 2 and 80 HBM pages of 16 tokens: a request needs 33
# pages, so HBM holds about two of the four sessions and pages migrate
# under gdt (phase 4's ratio).
NEW_DENSE = ("granite_8b", "minitron_4b", "stablelm_3b")
NEW_SERVING = (dict(max_batch=2, page_size=16, max_pages_per_seq=40,
                    hbm_pages=80, host_pages=256, policy="gdt",
                    interval_steps=4), 4, 512, 16)
# mixtral_8x7b at its published widths cut to 8 of 32 layers: 22.5 GB of
# bf16 experts (all 32 layers hold 90.2 GB, which tiered serving would pin
# in host memory, against the machine's 96 GiB).  Served tiered with 24 of
# its 64 (layer, expert) blocks on the card, 2 requests of 4160 prompt
# tokens (past the 4096 window) + 16 new, greedy; 560 HBM pages hold both.
MIXTRAL, MIXTRAL_LAYERS, MIXTRAL_CACHE = "mixtral_8x7b", 8, 24
MIXTRAL_PROMPT, MIXTRAL_NEW = 4160, 16
MIXTRAL_SERVING = dict(max_batch=2, page_size=16, max_pages_per_seq=264,
                       hbm_pages=560, host_pages=64, policy="gdt",
                       interval_steps=4)
STABLELM, GRANITE8B = "stablelm_3b", "granite_8b"


def mixtral_model(seed: int):
    """mixtral_8x7b at its published widths cut to MIXTRAL_LAYERS layers,
    random weights from ``seed``, on the card."""
    import torch

    from repro_torch.configs import get
    from repro_torch.models import Model

    cfg = dataclasses.replace(get(MIXTRAL), n_layers=MIXTRAL_LAYERS)
    model = Model(cfg, device="cuda")
    return model.init(torch.Generator(device="cuda").manual_seed(seed))


def mixtral_run(card, model, label, prompts, **extra):
    """One ``LLM(model, cfg).generate`` of ``prompts`` (greedy,
    MIXTRAL_NEW tokens each) on MIXTRAL_SERVING plus ``extra``, the launch
    counters zeroed just before and read just after.  Returns (streams,
    launches, wall, device bytes the LLM took when built, stats)."""
    import torch

    from repro_torch.serve import LLM, SamplingParams, ServeConfig

    free_card()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    llm = LLM(model, ServeConfig(**MIXTRAL_SERVING, **extra))
    free_card()
    built = torch.cuda.memory_allocated() - before
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = llm.generate(prompts, SamplingParams(max_tokens=MIXTRAL_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = llm.stats()
    for o in outs:
        if len(o.token_ids) != MIXTRAL_NEW or o.finish_reason != "length":
            raise AssertionError(f"{label} request {o.request_id}: "
                                 f"{len(o.token_ids)} tokens, finish "
                                 f"{o.finish_reason}")
    L = model.cfg.n_layers
    need = {"paged_attention": L * st["decode_dispatches"],
            "paged_prefill": L * st["prefill_dispatches"],
            "moe_grouped_ffn": L * (st["decode_dispatches"]
                                    + st["prefill_dispatches"])}
    for name, n in need.items():
        if launches[name] < n or launches[name] == 0:
            raise AssertionError(f"{label} {name}: {launches[name]} launches"
                                 f" < {n} (layers x dispatches)")
    n_tok = len(prompts) * MIXTRAL_NEW
    log(f"serving {label}: {len(prompts)} requests x {len(prompts[0])} "
        f"prompt + {MIXTRAL_NEW} new tokens in {wall:.3f} s: "
        f"{n_tok / wall:.2f} generated tokens/s, {st['steps']} steps; built "
        f"in {build_s:.1f} s, device bytes {built:+d} by the build; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB; launches {launches} {card.tag()}")
    streams = [o.token_ids for o in outs]
    del llm, outs
    free_card()
    return streams, launches, wall, built, st


def serve_mixtral(card) -> None:
    """Phase 12's mixtral part: one-shot == chunked on the resident model,
    the resident run, then the tiered run (MIXTRAL_CACHE blocks on the
    card, the rest in pinned host memory), bitwise equal to it."""
    import numpy as np

    model = mixtral_model(SEED + 10)
    mc = model.cfg
    log(f"model {MIXTRAL}: {mc.n_layers} of 32 layers (cut: the 32 layers' "
        f"experts hold 90.2 GB of bf16, which tiered serving pins in host "
        f"memory), d_model {mc.d_model}, {mc.n_heads}/{mc.kv_heads} heads of "
        f"{model.head_dim}, d_ff {mc.d_ff}, {mc.n_experts} experts top-"
        f"{mc.top_k}, window {mc.window}, vocab {mc.vocab}, {mc.dtype}")
    one_shot_equals_chunked(model, long_prompt(mc.vocab))
    rng = np.random.default_rng(SEED + 10)
    prompts = [rng.integers(0, mc.vocab, MIXTRAL_PROMPT).tolist()
               for _ in range(2)]
    resident, r_launches, _, r_built, _ = mixtral_run(
        card, model, f"{MIXTRAL} resident", prompts)
    blocks = mc.n_layers * mc.n_experts
    block_bytes = 3 * mc.d_model * mc.d_ff * 2
    tiered, t_launches, wall, t_built, st = mixtral_run(
        card, model, f"{MIXTRAL} tiered", prompts, expert_offchip=True,
        expert_cache_size=MIXTRAL_CACHE)
    # The tiered build moves the model's expert stacks off the card: the
    # device holds less after it than before.
    drop, need = r_built - t_built, (blocks - MIXTRAL_CACHE) * block_bytes
    if drop < need:
        raise AssertionError(f"{MIXTRAL} tiered: {drop} fewer device bytes "
                             f"than the resident build, less than the "
                             f"{need} of the blocks off the card")
    if tiered != resident:
        raise AssertionError(f"{MIXTRAL}: tiered streams {tiered} differ "
                             f"from resident {resident}")
    name = "moe_grouped_ffn"
    if t_launches[name] != r_launches[name]:
        raise AssertionError(f"{MIXTRAL}: tiered {t_launches[name]} grouped-"
                             f"FFN launches, resident {r_launches[name]}")
    log(f"{MIXTRAL} tiered == resident: {len(prompts)} streams bitwise "
        f"equal (first tokens {[s[:4] for s in tiered]}); the tiered build "
        f"took {drop} device bytes fewer than the resident one (>= {need}: "
        f"{blocks - MIXTRAL_CACHE} of {blocks} blocks of {block_bytes} "
        f"bytes on pinned host); {wall:.3f} s; demand fetches "
        f"{st['expert_demand_fetches']}, prefetch hits "
        f"{st['expert_prefetch_hits']}, evictions {st['expert_evictions']}, "
        f"bytes fetched {st['expert_bytes_fetched']}, host syncs "
        f"{st['expert_host_syncs']} {card.tag()}")
    del model
    free_card()


def serve_new_archs(card, kernel_rows) -> None:
    """Phase 12: the dense archs granite_8b, minitron_4b and stablelm_3b
    whole at their published widths through ``LLM.from_arch(arch,
    smoke=False).generate`` on NEW_SERVING (launches, tokens/s, peak
    memory; pages migrate), one-shot == chunked on a 300-token prompt;
    then mixtral_8x7b (``serve_mixtral``)."""
    import numpy as np

    from repro_torch.serve import ServeConfig

    fields, n_req, n_prompt, n_new = NEW_SERVING
    for i, arch in enumerate(NEW_DENSE):
        t0 = time.perf_counter()
        llm, _, _, _, launches = main_run(
            card, arch, ServeConfig(**fields), n_req, n_prompt, n_new,
            np.random.default_rng(SEED + 20 + i))
        model = llm.engine.model
        if arch == STABLELM:
            log(f"serving {arch}: the paged kernels at dh "
                f"{model.head_dim}: {launches['paged_attention']} decode and "
                f"{launches['paged_prefill']} prefill launches")
        del llm
        free_card()
        one_shot_equals_chunked(model, long_prompt(model.cfg.vocab))
        del model
        free_card()
        log(f"phase 12 {arch}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_mixtral(card)
    log(f"phase 12 {MIXTRAL}: {time.perf_counter() - t0:.1f} s")


# Phase 13: stablelm_3b trained whole (2,795,276,800 parameters: 33.5 GB
# of bf16 parameters and gradients and f32 moments), 4 steps a run; the
# contiguous cache at granite_8b's and mixtral's published widths.
STABLELM_TRAIN_STEPS = 4
CONTIG_DENSE = (2, 1024, 16)          # granite_8b: prompts, tokens, steps
CONTIG_CHECK_PROMPT = 256


def train_stablelm(card, kernel_rows) -> None:
    """Phase 13a: stablelm_3b (dh 80) trained whole at its published widths,
    unguided, two profiled steps, then guided with 60% of the state on HBM,
    and the 2-layer f32 check against the plain path."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.core import GuidanceConfig
    from repro_torch.data import SyntheticLM

    cfg = get(STABLELM)                    # bf16, remat on
    src = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to("cuda")
                for k, v in src.batch_np(i).items()}
               for i in range(STABLELM_TRAIN_STEPS)]
    log(f"model {STABLELM} training: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}, remat {cfg.remat}; batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"{STABLELM_TRAIN_STEPS} steps a run")
    losses, launches, trainer = train_run(card, f"{STABLELM} unguided", cfg,
                                          batches, None)
    for way in ("fwd", "bwd"):
        kernel_rows[f"flash_attention_{way}_dh80"]["launches"] = \
            launches[f"flash_attention_{way}"]
    profile_training(card, trainer, batches[:2])
    n_params = sum(p.numel() for p in trainer.params.values())
    state = sum(p.numel() * p.element_size()
                for p in trainer.params.values()) + 2 * 4 * n_params
    log(f"training state ({STABLELM}): {n_params} parameters, {state} bytes "
        f"of parameters and f32 moments")
    del trainer
    free_card()
    gdt = GuidanceConfig(enabled=True, fast_capacity_bytes=int(state * 0.6),
                         interval_steps=2, promotion_threshold=64 * 1024)
    guided, _, trainer = train_run(card, f"{STABLELM} guided", cfg, batches,
                                   gdt)
    if not np.allclose(guided, losses, rtol=1e-5, atol=0):
        raise AssertionError(f"{STABLELM} guided losses {guided} != unguided "
                             f"{losses} (rtol 1e-5)")
    if trainer.placer.slow_bytes() <= 0:
        raise AssertionError(f"{STABLELM} guided training kept nothing on "
                             f"pinned host")
    log(f"{STABLELM} guided == unguided losses (rtol 1e-5), max rel diff "
        f"{max(abs(a - b) / abs(b) for a, b in zip(guided, losses)):.3e}; "
        f"{trainer.placer.slow_bytes()} bytes on pinned host")
    del trainer
    free_card()
    train_f32_check(batches[0], STABLELM)


def contiguous_run(card, model, tokens, n_new, expect,
                   **frontend) -> list:
    """A warm-up prefill, then the counted one: ``prefill`` of ``tokens``
    (and the VLM's ``patches`` or the encoder-decoder's ``frames`` in
    ``frontend``) into a fresh ``init_cache`` and ``n_new`` greedy
    ``decode`` steps, the launch counters zeroed just before and read just
    after, held to ``expect`` exactly.  Returns the generated tokens."""
    import torch

    cfg = model.cfg
    B, T = tokens.shape
    S = T + (frontend["patches"].shape[1] if "patches" in frontend else 0)
    model.prefill(tokens, model.init_cache(B, S + n_new), **frontend)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(B, S + n_new)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, cache, **frontend)
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
        raise AssertionError(f"{cfg.arch} contiguous logits shaped "
                             f"{tuple(logits.shape)} or not finite")
    for name in launches:
        if launches[name] != expect.get(name, 0):
            raise AssertionError(f"{cfg.arch} contiguous serving {name}: "
                                 f"{launches[name]} launches, expected "
                                 f"{expect.get(name, 0)}")
    slots = cache["kv"]["k"].shape[2] if "kv" in cache else None
    inputs = " + ".join(f"{t.shape[1]} {name}" for name, t in
                        frontend.items())
    prefill_s, decode_s = t1 - t0, t2 - t1
    log(f"contiguous {cfg.arch} ({cfg.n_layers} layers): prefill of {B} x "
        f"({inputs + ' + ' if inputs else ''}{T} tokens) in "
        f"{1e3 * prefill_s:.2f} ms, {B * S / prefill_s:.1f} prompt "
        f"positions/s; {n_new} decode steps in {decode_s:.3f} s, "
        f"{1e3 * decode_s / n_new:.2f} ms per step; "
        f"{'no KV cache' if slots is None else f'cache of {slots} slots'}"
        f"{' (a ring)' if slots and slots < S + n_new else ''}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB; launches {launches}; first tokens "
        f"{generated[:, :6].tolist()} {card.tag()}")
    del cache, logits
    return generated


def contiguous_f32_check(arch, rng) -> None:
    """``arch`` in f32 at its published widths cut to F32_CHECK_LAYERS
    layers: the kernel path's prefill logits and cache against the plain
    path's (``plain_kernels``), then prefill-then-decode against stepwise
    decode on CONTIG_CHECK_PROMPT tokens, greedy tokens equal and logits
    within HYBRID_TOL (the JAX package's own tolerance for the two forms),
    as phase 7 checks the hybrid family."""
    import torch

    from repro_torch.configs import get
    from repro_torch.models import Model

    cfg = dataclasses.replace(get(arch), n_layers=F32_CHECK_LAYERS,
                              dtype=torch.float32)
    model = Model(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(SEED + 11))
    S, n_new = CONTIG_CHECK_PROMPT, 4
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S))).to("cuda")
    reset_launches()
    logits, cache = model.prefill(tokens, model.init_cache(1, S + n_new))
    torch.cuda.synchronize()
    if read_launches()["flash_attention_fwd"] != cfg.n_layers:
        raise AssertionError(f"f32 {arch} prefill: {read_launches()}")
    reset_launches()
    with plain_kernels():
        want, want_cache = model.prefill(tokens,
                                         model.init_cache(1, S + n_new))
    torch.cuda.synchronize()
    if any(read_launches().values()):
        raise AssertionError(f"the plain path launched kernels: "
                             f"{read_launches()}")
    err = float((logits - want).abs().max() / want.abs().max())
    kv_err = max(float((cache["kv"][n][i] - want_cache["kv"][n][i]).norm()
                       / want_cache["kv"][n][i].norm())
                 for n in ("k", "v") for i in range(cfg.n_layers))
    if err > HYBRID_TOL or kv_err > HYBRID_TOL:
        raise AssertionError(f"f32 {arch} prefill, kernel vs plain path: "
                             f"logits {err:.3e}, K/V {kv_err:.3e} (tol "
                             f"{HYBRID_TOL})")
    del want, want_cache
    a, diff = prefill_then_decode_vs_stepwise(model, tokens, logits, cache,
                                              n_new, arch)
    log(f"f32 contiguous {arch} ({F32_CHECK_LAYERS} layers, {S}-token "
        f"prompt): prefill kernel vs plain path logits {err:.3e} of "
        f"max|logit|, K/V {kv_err:.3e} in norm; prefill-then-decode == "
        f"stepwise decode, greedy {a}, logits max abs diff {diff:.3e} "
        f"(atol=rtol={HYBRID_TOL})")
    del model, cache
    free_card()


def prefill_then_decode_vs_stepwise(model, tokens, logits, cache, n_new,
                                    label):
    """Greedy decode of ``n_new`` tokens on from a prefill of ``tokens``
    (its ``logits`` and ``cache``) against the same from ``tokens``
    stepped through ``decode`` one by one: greedy tokens equal and every
    step's logits within HYBRID_TOL (atol = rtol).  Returns (the greedy
    tokens, the largest logit difference)."""
    S = tokens.shape[1]
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
        raise AssertionError(f"f32 {label} prefill-then-decode {a} vs "
                             f"stepwise {b}; logits {worst:.3f} of "
                             f"atol=rtol={HYBRID_TOL}")
    return a, max(float((x - y).abs().max()) for x, y in zip(la, lb))


def serve_contiguous(card) -> None:
    """Phase 13b: contiguous-cache ``prefill`` / ``decode``: granite_8b
    whole (CONTIG_DENSE) and mixtral_8x7b at MIXTRAL_LAYERS layers (one
    MIXTRAL_PROMPT-token prompt over a 4096-slot ring, MIXTRAL_NEW greedy
    steps), launches counted; then the f32 2-layer checks of each."""
    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.models import Model

    rng = np.random.default_rng(SEED + 12)
    model = Model(get(GRANITE8B), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(SEED + 12))
    B, S, n_new = CONTIG_DENSE
    tokens = torch.from_numpy(
        rng.integers(0, model.cfg.vocab, (B, S))).to("cuda")
    contiguous_run(card, model, tokens, n_new,
                   {"flash_attention_fwd": model.cfg.n_layers})
    del model, tokens
    free_card()
    model = mixtral_model(SEED + 13)
    L = model.cfg.n_layers
    tokens = torch.from_numpy(
        rng.integers(0, model.cfg.vocab, (1, MIXTRAL_PROMPT))).to("cuda")
    if model.init_cache(1, MIXTRAL_PROMPT + MIXTRAL_NEW)["kv"]["k"].shape[2] \
            != model.cfg.window:
        raise AssertionError(f"{MIXTRAL}: the cache is not a ring of "
                             f"{model.cfg.window} slots")
    contiguous_run(card, model, tokens, MIXTRAL_NEW,
                   {"flash_attention_fwd": L,
                    "moe_grouped_ffn": L * (1 + MIXTRAL_NEW)})
    del model, tokens
    free_card()
    for arch in (GRANITE8B, MIXTRAL):
        contiguous_f32_check(arch, rng)


def train_and_serve_contiguous(card, kernel_rows) -> None:
    """Phase 13: stablelm_3b training, then contiguous-cache serving."""
    t0 = time.perf_counter()
    train_stablelm(card, kernel_rows)
    log(f"phase 13 training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_contiguous(card)
    log(f"phase 13 contiguous serving: {time.perf_counter() - t0:.1f} s")


# Phase 14: the last three families at their published widths.
VLM, ENCDEC, XLSTM = "phi3_vision_4_2b", "seamless_m4t_medium", "xlstm_350m"
VLM_SERVE = (2, 448, 16)            # prompts, tokens after the 576 patches,
VLM_TRAIN_TOKENS = 1472             # greedy steps; 576 + 1472 = 2048
VLM_TRAIN_STEPS = 4
ENCDEC_SERVE = (2, 1024, 256, 16)   # prompts, frames, tokens, greedy steps
ENCDEC_TRAIN = (1024, 1024)         # frames, tokens a row
ENCDEC_TRAIN_STEPS = 2
XLSTM_SERVE = (4, 1024, 32)         # prompts, tokens, greedy steps
# The sLSTM's time loop is launch-bound: 2 x 2048 took 13.2-15.5 s a step
# on an H100 (700 W), so xLSTM training runs at 2 x 1024.
XLSTM_TRAIN_SEQ = 1024
XLSTM_TRAIN_STEPS = 2
# The f32 checks' inputs: the VLM's 576 patches and 128 tokens, the
# encoder-decoder's 512 frames and 256 tokens; 4 greedy steps.
FAMILY_CHECK = {VLM: 128, ENCDEC: 256}
FAMILY_CHECK_FRAMES = 512
FAMILY_CHECK_NEW = 4
FAMILY_TOL = 1e-4                   # f32 kernel path vs plain path


def frontend_inputs(cfg, gen, B, n_frames=None) -> dict:
    """The batch's stub-frontend embeddings in ``cfg.dtype``, N(0, 1) from
    ``gen``: the VLM's ``patches`` (B, frontend_tokens, d), the
    encoder-decoder's ``frames`` (B, n_frames, d); nothing for the other
    families."""
    import torch

    if cfg.family == "vlm":
        shape, name = (B, cfg.frontend_tokens, cfg.d_model), "patches"
    elif cfg.family == "encdec":
        shape, name = (B, n_frames, cfg.d_model), "frames"
    else:
        return {}
    return {name: torch.randn(shape, generator=gen, device="cuda").to(
        cfg.dtype)}


def family_batches(cfg, n_tokens, steps, seed, n_frames=None) -> list:
    """``steps`` training batches of TRAIN_BATCH rows: ``SyntheticLM``
    tokens and labels of ``n_tokens`` a row, with the family's frontend
    embeddings from a seeded generator."""
    import torch

    from repro_torch.data import SyntheticLM

    src = SyntheticLM(cfg.vocab, n_tokens, TRAIN_BATCH, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [{**{k: torch.from_numpy(v).to("cuda")
                for k, v in src.batch_np(i).items()},
             **frontend_inputs(cfg, gen, TRAIN_BATCH, n_frames)}
            for i in range(steps)]


def unsaturate(model) -> None:
    """Scales ``model``'s attention projections (``attn``, ``xattn``) to
    N(0, 1/fan_in) over all the dimensions they contract: ``wq``, ``wk``,
    ``wv`` (d, heads, dh) by sqrt(heads / d), ``wo`` (H, dh, d) by
    1/sqrt(H).  The reference's init takes fan_in = shape[-2] (the heads,
    dh), which at published widths gives scores of standard deviation in
    the tens: the softmax saturates, and f32 round-off alone then moves
    some gradients by percents (the encoder-decoder's layer-0 ``wk`` by
    over 100% in norm against float64), in the plain path as in the
    kernel path.  Scaled so, the scores have unit deviation."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            block, leaf = name.split(".")[-2:]
            if block not in ("attn", "xattn"):
                continue
            if leaf in ("wq", "wk", "wv"):
                p.mul_(math.sqrt(p.shape[1] / p.shape[0]))
            elif leaf == "wo":
                p.mul_(1.0 / math.sqrt(p.shape[0]))


def family_f32_check(arch, rng) -> None:
    """``arch`` (the VLM or the encoder-decoder) in f32 at its published
    widths cut to F32_CHECK_LAYERS layers (encoder and decoder), its
    attention projections ``unsaturate``d: the kernel path's loss and
    gradients against the plain path's (``Model`` under
    ``plain_kernels``), the loss to FAMILY_TOL relative, each gradient
    leaf to FAMILY_TOL of that leaf's largest entry (as the CPU parity
    tests hold the port to the JAX package).  Then its prefill logits and
    cache against the plain path's to FAMILY_TOL, and FAMILY_CHECK_NEW
    greedy decode steps after the prefill, each step's logits against the
    full forward pass of the sequence so far at its last position (greedy
    tokens equal, logits within HYBRID_TOL)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.models import Model
    from repro_torch.models.layers import norm, project
    from repro_torch.train import value_and_grad

    base = get(arch)
    cfg = dataclasses.replace(
        base, n_layers=F32_CHECK_LAYERS, dtype=torch.float32,
        enc_layers=F32_CHECK_LAYERS if base.enc_layers else 0)
    model = Model(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(SEED + 14))
    unsaturate(model)
    T, n_new = FAMILY_CHECK[arch], FAMILY_CHECK_NEW
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    front = frontend_inputs(cfg, gen, 1, FAMILY_CHECK_FRAMES)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (1, T))).to("cuda")
    labels = torch.roll(tokens, -1, 1)
    batch = {"tokens": tokens, "labels": labels, **front}
    params = dict(model.named_parameters())
    reset_launches()
    loss, grads = value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    if read_launches() != per_step_launches(cfg, 1) | {
            n: 0 for n in read_launches() if "flash" not in n}:
        raise AssertionError(f"f32 {arch} training: launches "
                             f"{read_launches()}")
    reset_launches()
    with plain_kernels():
        want, want_grads = value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    if any(read_launches().values()):
        raise AssertionError(f"the plain path launched kernels: "
                             f"{read_launches()}")
    rel_loss = abs(float(loss) - float(want)) / abs(float(want))
    worst, worst_name = max(
        (float((grads[n] - w).abs().max() / w.abs().max().clamp_min(1e-30)),
         n) for n, w in want_grads.items())
    if not (rel_loss <= FAMILY_TOL and worst <= FAMILY_TOL):
        raise AssertionError(
            f"f32 {arch} training, kernel vs plain path: loss rel err "
            f"{rel_loss:.3e}, worst gradient {worst_name} {worst:.3e} of its "
            f"largest entry (tol {FAMILY_TOL})")
    del grads, want_grads, want
    S = T + (front["patches"].shape[1] if "patches" in front else 0)
    reset_launches()
    logits, cache = model.prefill(tokens, model.init_cache(1, S + n_new),
                                  **front)
    torch.cuda.synchronize()
    if read_launches()["flash_attention_fwd"] == 0:
        raise AssertionError(f"f32 {arch} prefill: {read_launches()}")
    with plain_kernels():
        want, want_cache = model.prefill(
            tokens, model.init_cache(1, S + n_new), **front)
    err = float((logits - want).abs().max() / want.abs().max())
    kv_err = max(float((cache[k][n] - want_cache[k][n]).norm()
                       / want_cache[k][n].norm())
                 for k in ("kv", "xk", "xv") if k in cache
                 for n in (("k", "v") if k == "kv" else range(cfg.n_layers)))
    if not (err <= FAMILY_TOL and kv_err <= FAMILY_TOL):
        raise AssertionError(f"f32 {arch} prefill, kernel vs plain path: "
                             f"logits {err:.3e}, cache {kv_err:.3e} (tol "
                             f"{FAMILY_TOL})")
    del want, want_cache
    seq, greedy, diff = tokens, [], 0.0
    for pos in range(S, S + n_new):
        nxt = logits.argmax(-1)
        greedy.append(int(nxt))
        seq = torch.cat([seq, nxt[:, None]], 1)
        logits, cache = model.decode(nxt, cache, pos)
        with torch.no_grad():
            h = model(seq, **front)[:, -1]
            full = project(norm(model.final_ln.scale, h),
                           model.head.w).float()
        if int(full.argmax(-1)) != int(logits.argmax(-1)) or not bool(
                ((logits - full).abs()
                 <= HYBRID_TOL + HYBRID_TOL * full.abs()).all()):
            raise AssertionError(f"f32 {arch}: decode at {pos} vs the full "
                                 f"forward: max abs diff "
                                 f"{float((logits - full).abs().max())}")
        diff = max(diff, float((logits - full).abs().max()))
    log(f"f32 {arch} ({F32_CHECK_LAYERS} layers, "
        f"{' + '.join(f'{v.shape[1]} {k}' for k, v in front.items())} + {T} "
        f"tokens): kernel vs plain path loss {float(loss):.6f} rel err "
        f"{rel_loss:.3e}, worst gradient {worst_name} {worst:.3e} of its "
        f"largest entry; prefill kernel vs plain path logits {err:.3e} of max|logit|, "
        f"cache {kv_err:.3e} in norm; prefill-then-decode == the full "
        f"forward, greedy {greedy}, logits max abs diff {diff:.3e} "
        f"(atol=rtol={HYBRID_TOL})")
    del model, cache
    free_card()


def family_model(arch, seed):
    """``arch`` at its published widths in bf16 on the card, random weights
    from a seeded generator; its size logged."""
    import torch

    from repro_torch.configs import get
    from repro_torch.models import Model

    model = Model(get(arch), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(seed))
    cfg = model.cfg
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"model {arch} ({cfg.family}): {cfg.n_layers} layers"
        f"{f' + {cfg.enc_layers} encoder layers' if cfg.enc_layers else ''}"
        f", d_model {cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}; {n} parameters, {nbytes} bytes")
    return model


def family_train(card, arch, batches, profile=False) -> dict:
    """``train_run`` (Trainer, remat, phase 6's AdamW, unguided) of
    ``arch`` at its published widths on ``batches``; with ``profile``, two
    more steps under the profiler.  Returns the run's launches, with the
    non-causal flash launches as ``*_cross``."""
    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as fa

    cfg = get(arch)
    n_front = {k: tuple(v.shape) for k, v in batches[0].items()
               if k in ("patches", "frames")}
    log(f"model {arch} training: batch {tuple(batches[0]['tokens'].shape)} "
        f"tokens{f', {n_front}' if n_front else ''}, {len(batches)} steps, "
        f"remat {cfg.remat}")
    _, launches, trainer = train_run(card, f"{arch} unguided", cfg, batches,
                                     None)
    launches = dict(launches, **{f"{n}_cross": c for n, c in
                                 fa.NONCAUSAL_LAUNCHES.items()})
    if profile:
        profile_training(card, trainer, batches[:2])
    del trainer
    free_card()
    return launches


def serve_and_train_vlm(card, kernel_rows) -> None:
    """Phase 14a: phi3_vision_4_2b whole (dh 96): contiguous serving of
    VLM_SERVE with 576 patches a prompt and a profiled prefill and decode,
    training, then the f32 check."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 16)
    model = family_model(VLM, SEED + 16)
    cfg = model.cfg
    B, T, n_new = VLM_SERVE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    front = frontend_inputs(cfg, gen, B)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (B, T))).to("cuda")
    contiguous_run(card, model, tokens, n_new,
                   {"flash_attention_fwd": cfg.n_layers}, **front)
    served = cfg.n_layers
    profile_contiguous(card, model, tokens, label=VLM,
                       shares=(("flash attention", "flash_"),), **front)
    del model, tokens, front
    free_card()
    batches = family_batches(cfg, VLM_TRAIN_TOKENS, VLM_TRAIN_STEPS,
                             SEED + 18)
    launches = family_train(card, VLM, batches, profile=True)
    del batches
    for way in ("fwd", "bwd"):
        kernel_rows[f"flash_attention_{way}_dh96"]["launches"] = \
            launches[f"flash_attention_{way}"] + (served if way == "fwd"
                                                   else 0)
    family_f32_check(VLM, rng)


def serve_and_train_encdec(card, kernel_rows) -> None:
    """Phase 14b: seamless_m4t_medium whole (dh 64): contiguous serving of
    ENCDEC_SERVE and a profiled prefill and decode, training, then the f32
    check."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(SEED + 19)
    model = family_model(ENCDEC, SEED + 19)
    cfg = model.cfg
    B, Se, T, n_new = ENCDEC_SERVE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    front = frontend_inputs(cfg, gen, B, Se)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (B, T))).to("cuda")
    n_fwd = cfg.enc_layers + 2 * cfg.n_layers
    contiguous_run(card, model, tokens, n_new,
                   {"flash_attention_fwd": n_fwd}, **front)
    if fa.NONCAUSAL_LAUNCHES["flash_attention_fwd"] != cfg.n_layers:
        raise AssertionError(f"{ENCDEC} prefill: non-causal launches "
                             f"{fa.NONCAUSAL_LAUNCHES}, expected "
                             f"{cfg.n_layers} (cross attention)")
    served = {"flash_attention_fwd": n_fwd,
              "flash_attention_fwd_cross": cfg.n_layers}
    profile_contiguous(card, model, tokens, label=ENCDEC,
                       shares=(("flash attention", "flash_"),), **front)
    del model, tokens, front
    free_card()
    frames, n_tok = ENCDEC_TRAIN
    batches = family_batches(cfg, n_tok, ENCDEC_TRAIN_STEPS, SEED + 21,
                             frames)
    launches = family_train(card, ENCDEC, batches)
    del batches
    steps = ENCDEC_TRAIN_STEPS
    want = {"flash_attention_fwd_cross": 2 * cfg.n_layers * steps,
            "flash_attention_bwd_cross": cfg.n_layers * steps}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{ENCDEC} training: {launches[name]} "
                                 f"non-causal launches of {name}, expected "
                                 f"{n}")
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "flash_attention_fwd_cross", "flash_attention_bwd_cross"):
        kernel_rows[name]["launches"] += launches[name] + served.get(name, 0)
    family_f32_check(ENCDEC, rng)


def serve_and_train_xlstm(card) -> None:
    """Phase 14c: xlstm_350m whole (plain torch, no kernel on its path):
    contiguous serving of XLSTM_SERVE and a profiled prefill and decode,
    Trainer steps at XLSTM_TRAIN_SEQ,
    then an f32 copy at the smoke depth (4 layers, one of them sLSTM):
    prefill-then-decode against stepwise decode."""
    import numpy as np
    import torch

    from repro_torch.configs import get, get_smoke
    from repro_torch.models import Model

    rng = np.random.default_rng(SEED + 22)
    model = family_model(XLSTM, SEED + 22)
    cfg = model.cfg
    B, S, n_new = XLSTM_SERVE
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (B, S))).to("cuda")
    contiguous_run(card, model, tokens, n_new, {})
    profile_contiguous(card, model, tokens, label=XLSTM, shares=())
    del model, tokens
    free_card()
    batches = family_batches(cfg, XLSTM_TRAIN_SEQ, XLSTM_TRAIN_STEPS,
                             SEED + 23)
    family_train(card, XLSTM, batches)
    del batches
    smoke = get_smoke(XLSTM)
    cfg = dataclasses.replace(get(XLSTM), n_layers=smoke.n_layers,
                              slstm_every=smoke.slstm_every,
                              dtype=torch.float32)
    model = Model(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(SEED + 24))
    S = CONTIG_CHECK_PROMPT
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (1, S))).to("cuda")
    logits, cache = model.prefill(tokens, model.init_cache(1, S + 4))
    greedy, diff = prefill_then_decode_vs_stepwise(model, tokens, logits,
                                                   cache, 4, XLSTM)
    log(f"f32 {XLSTM} ({cfg.n_layers} layers, one sLSTM, {S}-token "
        f"prompt): prefill-then-decode == stepwise decode, greedy {greedy}, "
        f"logits max abs diff {diff:.3e} (atol=rtol={HYBRID_TOL})")
    del model, cache
    free_card()


def serve_and_train_families(card, kernel_rows) -> None:
    """Phase 14: the VLM, the encoder-decoder and the xLSTM family at
    their published widths."""
    for name, part in (("14a", lambda: serve_and_train_vlm(card,
                                                           kernel_rows)),
                       ("14b", lambda: serve_and_train_encdec(card,
                                                              kernel_rows)),
                       ("14c", lambda: serve_and_train_xlstm(card))):
        t0 = time.perf_counter()
        part()
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


# ----------------------------------------- phase 15: dispatches, simulator
DISPATCH_SHAPES = ((4, 512), (2, 2048))   # serving's and training's (B, S)
CAPACITY_SHAPE = (2, 2048)
CAPACITY_SINGLE = 64                      # single-token rows against dropless
CAPACITY_TRAIN_STEPS = 2
SIM_CAP_FRAC = 0.5
LAYER_WEIGHTS = ("router", "w_gate", "w_up", "w_down")


def moe_layer(seed: int, dtype):
    """One MoE layer of granite at its published widths, weights from
    ``seed`` on the card: (MoEConfig, weights, its f32 router in ``dtype``
    experts)."""
    from types import SimpleNamespace

    import torch

    from repro_torch.configs import get
    from repro_torch.models.moe import MoEConfig

    cfg = get(MOE)
    mcfg = MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                     n_experts=cfg.n_experts, top_k=cfg.top_k,
                     capacity_factor=cfg.capacity_factor,
                     parallelism=cfg.moe_parallelism,
                     ep_axis_size=cfg.moe_ep_axis_size)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    E, d, f = mcfg.padded_experts, mcfg.d_model, mcfg.d_ff

    def w(*shape):
        return torch.randn(shape, generator=gen, device="cuda") / math.sqrt(
            shape[-2])

    p = SimpleNamespace(router=w(d, E), w_gate=w(E, d, f).to(dtype),
                        w_up=w(E, d, f).to(dtype),
                        w_down=w(E, f, d).to(dtype))
    return mcfg, p


def layer_grads(fn, p, x, proj):
    """``fn(p, x)``'s output and the gradients of ``sum(y * proj)`` in x
    and each layer weight ({"x": ..., "router": ..., ...})."""
    from types import SimpleNamespace

    import torch

    leaves = {n: getattr(p, n).detach().requires_grad_(True)
              for n in LAYER_WEIGHTS}
    xt = x.detach().requires_grad_(True)
    y = fn(SimpleNamespace(**leaves), xt)
    grads = torch.autograd.grad((y.float() * proj).sum(),
                                [xt, *leaves.values()])
    return y.detach(), dict(zip(["x", *LAYER_WEIGHTS], grads))


@contextlib.contextmanager
def grouped_calls():
    """Record each grouped-expert kernel call's arguments (its groups,
    their sizes and map, the rows) while inside; the wrappers still count
    their launches."""
    from repro_torch.kernels import moe_gemm as mg

    calls = {"fwd": [], "bwd": []}
    fwd, bwd = mg.moe_grouped_ffn_cuda, mg.moe_grouped_ffn_bwd_cuda

    def keep(args):
        return tuple(None if a is None else a.detach() for a in args)

    def rec_fwd(*args):
        calls["fwd"].append(keep(args))
        return fwd(*args)

    def rec_bwd(*args):
        calls["bwd"].append(keep(args))
        return bwd(*args)

    mg.moe_grouped_ffn_cuda, mg.moe_grouped_ffn_bwd_cuda = rec_fwd, rec_bwd
    try:
        yield calls
    finally:
        mg.moe_grouped_ffn_cuda, mg.moe_grouped_ffn_bwd_cuda = fwd, bwd


def check_per_row(card, kernel_rows) -> None:
    """Phase 15a.  Fills the per-row kernel rows' launches with the bf16
    per-row run's at training's shape."""
    import torch

    from repro_torch.models.moe import _moe_dropless

    weights_bitwise = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        cfg, p = moe_layer(SEED + 21, dtype)
        E = cfg.padded_experts
        for B, S in DISPATCH_SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(SEED + B)
            x = torch.randn((B, S, cfg.d_model), generator=gen,
                            device="cuda").to(dtype)
            proj = torch.randn(x.shape, generator=gen, device="cuda")
            flat_y, flat_g = layer_grads(
                lambda q, h: _moe_dropless(q, h, cfg), p, x, proj)
            torch.cuda.synchronize()
            reset_launches()
            with grouped_calls() as calls:
                y, g = layer_grads(
                    lambda q, h: _moe_dropless(q, h, cfg, per_row=True), p,
                    x, proj)
            torch.cuda.synchronize()
            launches = read_launches()
            groups = {c[4].shape[0] for c in calls["fwd"] + calls["bwd"]}
            if launches["moe_grouped_ffn"] != 1 or \
                    launches["moe_grouped_ffn_bwd"] != 1 or \
                    groups != {B * E}:
                raise AssertionError(
                    f"per-row layout {dtype_name} {B}x{S}: launches "
                    f"{launches}, groups {groups}, expected one forward and "
                    f"one backward launch over {B * E} groups")
            ge = calls["fwd"][0][5]
            if not torch.equal(ge, torch.arange(E, dtype=torch.int32,
                                                device="cuda").repeat(B)):
                raise AssertionError("per-row layout: group_experts is not "
                                     "arange(E) tiled B times")
            for name, a, b in (("output", y, flat_y),
                               ("x gradient", g["x"], flat_g["x"]),
                               ("router gradient", g["router"],
                                flat_g["router"])):
                if not same_bits(a, b):
                    raise AssertionError(
                        f"per-row layout {dtype_name} {B}x{S}: {name} "
                        f"differs from the flat layout's")
            errs = []
            for name in ("w_gate", "w_up", "w_down"):
                a, b = g[name], flat_g[name]
                if not torch.isfinite(a).all():
                    raise AssertionError(f"per-row {name} gradient not "
                                         f"finite")
                err = float((a.float() - b.float()).abs().max())
                scale = float(b.float().abs().max())
                weights_bitwise[(dtype_name, B, name)] = same_bits(a, b)
                if err > GRAD_TOL[dtype_name] * scale:
                    raise AssertionError(
                        f"per-row layout {dtype_name} {B}x{S}: {name} "
                        f"gradient err {err:.3e} > {GRAD_TOL[dtype_name]} x "
                        f"{scale:.3e}")
                errs.append(f"{name} " + ("bitwise" if err == 0 else
                                          f"{err / scale:.2e} of max"))
            log(f"per-row layout {dtype_name} B={B} S={S} ({B * E} groups, "
                f"{B * S * cfg.top_k} routed rows): output, x and router "
                f"gradients == flat bitwise; expert gradients: "
                f"{', '.join(errs)} (GRAD_TOL {GRAD_TOL[dtype_name]}); "
                f"launches {launches['moe_grouped_ffn']} forward, "
                f"{launches['moe_grouped_ffn_bwd']} backward")
            if dtype == torch.bfloat16 and (B, S) == DISPATCH_SHAPES[-1]:
                run_launches = launches
            del x, proj, y, g, flat_y, flat_g
        del p
        free_card()
    every = list(weights_bitwise.values())
    log(f"per-row expert gradients bitwise equal to flat in "
        f"{sum(every)} of {len(every)} (dtype, shape, weight) cases")
    for name, kernel in (("moe_grouped_ffn_per_row", "moe_grouped_ffn"),
                         ("moe_grouped_ffn_bwd_per_row",
                          "moe_grouped_ffn_bwd")):
        kernel_rows[name]["launches"] = run_launches[kernel]


def check_capacity(card) -> None:
    """Phase 15b."""
    from types import SimpleNamespace

    import torch

    from repro_torch.models.moe import (_capacity, _moe_dropless,
                                        dropped_picks, moe)

    cfg, p = moe_layer(SEED + 23, torch.bfloat16)
    B, S = CAPACITY_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    x = torch.randn((B, S, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    proj = torch.randn(x.shape, generator=gen, device="cuda")
    drops = dropped_picks(x, p.router, cfg)
    picks = B * S * cfg.top_k
    log(f"capacity dispatch B={B} S={S} factor {cfg.capacity_factor}: "
        f"capacity {_capacity(S, cfg)} a row and "
        f"expert, {drops} of {picks} picks dropped")
    if drops <= 0:
        raise AssertionError("capacity dispatch dropped no pick")

    def cap_fn(q, h):
        return moe(q, h, cfg, dispatch="capacity")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    runs = [layer_grads(cap_fn, p, x, proj) for _ in range(2)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if any(read_launches().values()):
        raise AssertionError(f"capacity dispatch launched kernels: "
                             f"{read_launches()}")
    (y1, g1), (y2, g2) = runs
    if not same_bits(y1, y2) or not all(same_bits(g1[n], g2[n])
                                        for n in g1):
        raise AssertionError("capacity dispatch: two runs differ")
    for name, t in g1.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"capacity dispatch: {name} gradient not "
                                 f"finite")
    p64 = SimpleNamespace(router=p.router, **{
        n: getattr(p, n).double() for n in ("w_gate", "w_up", "w_down")})
    with torch.no_grad():
        y64 = moe(p64, x.double(), cfg, dispatch="capacity")
    tol = TOL["bfloat16"]
    diff = (y1.double() - y64).abs()
    err = float(diff.max())
    if not bool((diff <= tol + tol * y64.abs()).all()):
        raise AssertionError(f"capacity dispatch bf16 vs float64: max abs "
                             f"err {err:.3e} outside atol=rtol={tol}")
    one = x.reshape(-1, 1, cfg.d_model)[:CAPACITY_SINGLE]
    with torch.no_grad():
        c1 = moe(p, one, cfg, dispatch="capacity").float()
        d1 = moe(p, one, cfg, dispatch="dropless").float()
    single = float((c1 - d1).abs().max())
    if not bool(((c1 - d1).abs() <= tol + tol * d1.abs()).all()):
        raise AssertionError(f"capacity at S=1 vs dropless: max abs err "
                             f"{single:.3e} outside atol=rtol={tol}")
    log(f"capacity dispatch: two forward and backward runs bitwise equal; "
        f"bf16 vs float64 max abs err {err:.3e}, {CAPACITY_SINGLE} "
        f"single-token rows vs dropless {single:.3e} (atol=rtol={tol}); "
        f"forward and backward peak {peak / 2**20:.1f} MiB above the "
        f"inputs {card.tag()}")
    del runs, y1, g1, y2, g2, p64, y64
    with torch.no_grad():
        cap_ms = time_ms(lambda: moe(p, x, cfg, dispatch="capacity"),
                         iters=10, warmup=2)
        drop_ms = time_ms(lambda: _moe_dropless(p, x, cfg), iters=10,
                          warmup=2)
    both = time_ms(lambda: layer_grads(cap_fn, p, x, proj), iters=5,
                   warmup=1)
    log(f"time MoE layer B={B} S={S} bf16: capacity forward {cap_ms:.4f} ms, "
        f"flat dropless forward {drop_ms:.4f} ms (events); capacity forward "
        f"and backward {both:.4f} ms {card.tag()}")
    del p, x, proj
    free_card()


def train_capacity(card) -> None:
    """Phase 15c."""
    import torch

    from repro_torch.configs import get
    from repro_torch.data import SyntheticLM

    cfg = dataclasses.replace(get(MOE), moe_dispatch="capacity")
    src = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to("cuda")
                for k, v in src.batch_np(i).items()}
               for i in range(CAPACITY_TRAIN_STEPS)]
    log(f"model {MOE} training, moe_dispatch capacity (factor "
        f"{cfg.capacity_factor}): {cfg.n_layers} layers, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {CAPACITY_TRAIN_STEPS} steps")
    _, _, trainer = train_run(card, "moe capacity", cfg, batches, None)
    del trainer
    free_card()


def simulator_headline(card) -> None:
    """Phase 15d: the paper's simulator on the host."""
    from repro_torch.core import CLX
    from repro_torch.mem import MemorySimulator
    from repro_torch.mem.workloads import lulesh

    t0 = time.perf_counter()
    wl = lulesh("medium")
    sim = MemorySimulator(CLX, wl)
    cap = int(wl.peak_rss * SIM_CAP_FRAC)
    ft = sim.run_first_touch(cap)
    on = sim.run_online(cap)
    took = time.perf_counter() - t0
    speedup = on.speedup_over(ft)
    log(f"simulator lulesh medium at {SIM_CAP_FRAC} of peak RSS on CLX: "
        f"online {on.total_seconds:.3f} s vs first-touch "
        f"{ft.total_seconds:.3f} s simulated, speedup {speedup:.4f}, "
        f"{on.bytes_migrated} bytes migrated; {took:.2f} s on the host")
    if not speedup > 1.0:
        raise AssertionError(f"simulator: online does not beat first-touch "
                             f"({speedup})")


def dispatches_and_simulator(card, kernel_rows) -> None:
    """Phase 15."""
    t_all = time.perf_counter()
    for name, part in (("15a", lambda: check_per_row(card, kernel_rows)),
                       ("15b", lambda: check_capacity(card)),
                       ("15c", lambda: train_capacity(card)),
                       ("15d", lambda: simulator_headline(card))):
        t0 = time.perf_counter()
        part()
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    log(f"phase 15: {time.perf_counter() - t_all:.1f} s")


# ------------------------------------------------------------ serving A/B
# Phase 16: the cost walk's count of phase 6's step, ShardedLoader, and
# the dry run's argument bytes.
COST_TIMED_STEPS = 3
LOADER_STEPS = 4


def dense_step_parts(cfg, device):
    """(model, params in the JAX leaf order, AdamW state, the step) of a
    fresh ``cfg`` model on ``device`` (seeded unless on ``meta``)."""
    import torch

    from repro_torch.convert import jax_order
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.train.step import make_train_step

    model = Model(cfg, device=device)
    if device != "meta":
        model.init(torch.Generator(device=device).manual_seed(SEED))
    named = dict(model.named_parameters())
    params = {n: named[n] for n in jax_order(named)}
    opt = AdamW(lr=3e-4)
    return model, params, opt.init(params), make_train_step(model, opt)


def step_flops(card, kernel_rows) -> None:
    """16a: one training step counted on the card and on ``meta`` (equal
    flops), then timed steps for the achieved rate."""
    import torch

    from repro_torch.configs import get
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.analysis import cost_of
    from repro_torch.models.common import count_params

    cfg = get(DENSE)
    src = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [src.batch_np(i) for i in range(1 + COST_TIMED_STEPS)]
    model, params, state, step = dense_step_parts(cfg, "cuda")
    on_card = [{k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
               for b in batches]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    card_cost = cost_of(step, params, state, on_card[0])
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    walk_launches = read_launches()
    meta_model, mp, ms, mstep = dense_step_parts(cfg, "meta")
    t0 = time.perf_counter()
    meta_cost = cost_of(mstep, mp, ms, {k: torch.from_numpy(v).to("meta")
                                        for k, v in batches[0].items()})
    meta_s = time.perf_counter() - t0
    if card_cost["flops"] != meta_cost["flops"] or \
            card_cost["matmul_flops"] != meta_cost["matmul_flops"]:
        raise AssertionError(f"cost walk: card {card_cost['flops']} flops "
                             f"({card_cost['matmul_flops']} in products), "
                             f"meta {meta_cost['flops']} "
                             f"({meta_cost['matmul_flops']})")
    n = count_params(model.param_defs())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"cost walk 16a: {DENSE} training step {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: {card_cost['flops']:.6e} flops on the card == "
        f"{meta_cost['flops']:.6e} on meta ({card_cost['matmul_flops']:.6e}"
        f" in products; kernels {card_cost['kernels']}); 8*N*D = "
        f"{8 * n * tokens:.6e} (N {n}), ratio "
        f"{card_cost['flops'] / (8 * n * tokens):.4f}; walk {walk_s:.2f} s "
        f"on the card, {meta_s:.2f} s on meta")
    starts = [torch.cuda.Event(enable_timing=True)
              for _ in range(COST_TIMED_STEPS)]
    ends = [torch.cuda.Event(enable_timing=True)
            for _ in range(COST_TIMED_STEPS)]
    for i in range(COST_TIMED_STEPS):
        starts[i].record()
        step(params, state, on_card[1 + i])
        ends[i].record()
    torch.cuda.synchronize()
    launches = read_launches()
    want = per_step_launches(cfg, 1 + COST_TIMED_STEPS)
    if {k: v for k, v in launches.items() if v} != want or \
            {k: v for k, v in walk_launches.items() if v} != \
            per_step_launches(cfg, 1):
        raise AssertionError(f"cost walk 16a: launches {launches} (the "
                             f"walk's {walk_launches}), expected {want}")
    for name in want:
        kernel_rows[name]["launches"] += launches[name]
    step_ms = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    step_s = sum(step_ms) / len(step_ms) / 1e3
    # The walk charges attention over all Sq x Sk pairs (the plain
    # version's work); every flash call of this step is causal with Sq ==
    # Sk, whose kernel computes (S + 1) / 2S of them.
    flash = sum(f for k, f in card_cost["kernels"].items()
                if k.startswith("flash_attention"))
    skipped = flash * (1 - (TRAIN_SEQ + 1) / (2 * TRAIN_SEQ))
    peak = PEAK_OPS_PER_S["bfloat16"]
    model_rate = card_cost["flops"] / step_s
    done_rate = (card_cost["flops"] - skipped) / step_s
    log(f"cost walk 16a: step ms {', '.join(f'{t:.2f}' for t in step_ms)}; "
        f"model flops over the mean CUDA-event step time (full Sq x Sk "
        f"attention, remat's recompute included) {model_rate / 1e12:.2f} "
        f"TFLOP/s, {100 * model_rate / peak:.1f}% of 989 TF/s; with "
        f"attention's causal half only ({skipped:.6e} flops fewer) "
        f"{done_rate / 1e12:.2f} TFLOP/s, {100 * done_rate / peak:.1f}% "
        f"{card.tag()}")
    del model, params, state, step, on_card
    free_card()


def loader_run(cfg, feed, label):
    """LOADER_STEPS steps of a fresh seeded ``Trainer`` fed by ``feed``:
    (losses, step ms, trainer)."""
    import torch

    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.train import Trainer, TrainerConfig

    trainer = Trainer(Model(cfg, device="cuda"), AdamW(lr=3e-4),
                      TrainerConfig(steps=LOADER_STEPS, log_every=1,
                                    seed=SEED))
    stamps = []

    def timed():
        for b in feed:
            stamps.append(time.perf_counter())
            yield b

    torch.cuda.synchronize()
    trainer.run(timed())
    stamps.append(time.perf_counter())
    losses = [m["loss"] for m in trainer.metrics_log]
    if len(losses) != LOADER_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"loader 16b {label}: losses {losses}")
    return losses, [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])], \
        trainer


def loader_and_bytes(card) -> None:
    """16b: steps fed by ``ShardedLoader`` == steps fed ``batch_np``,
    bitwise; 16c: the dry run's bytes == the trainer's on the card."""
    import itertools

    import torch

    from repro_torch.configs import get
    from repro_torch.data import ShardedLoader, SyntheticLM
    from repro_torch.dist import abstract_mesh
    from repro_torch.launch.dryrun import build_cell

    cfg = get(DENSE)
    src = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    direct = ({k: torch.from_numpy(v).to("cuda")
               for k, v in src.batch_np(i).items()}
              for i in range(LOADER_STEPS))
    want, direct_ms, trainer = loader_run(cfg, direct, "batch_np")
    del trainer
    free_card()
    loader = ShardedLoader(src, prefetch=2, device="cuda")
    try:
        got, loader_ms, trainer = loader_run(
            cfg, itertools.islice(iter(loader), LOADER_STEPS), "loader")
    finally:
        loader.close()
    if got != want:
        raise AssertionError(f"loader 16b: losses {got} != batch_np's "
                             f"{want}")
    log(f"loader 16b: {LOADER_STEPS} steps through ShardedLoader (prefetch "
        f"2, pinned) == batch_np, bitwise: losses "
        f"{', '.join(f'{x:.6f}' for x in got)}; step ms loader "
        f"{', '.join(f'{t:.1f}' for t in loader_ms)}, batch_np "
        f"{', '.join(f'{t:.1f}' for t in direct_ms)} {card.tag()}")

    _, memory, _ = build_cell(DENSE, "train_4k",
                              abstract_mesh((1, 1), ("data", "model")))
    params = sum(p.numel() * p.element_size()
                 for p in trainer.params.values())
    held = (*trainer.opt_state.m.values(), *trainer.opt_state.v.values())
    if any(t.device.type != trainer.device.type for t in held):
        raise AssertionError("dry run 16c: a moment is not on the card")
    moments = sum(t.numel() * t.element_size() for t in held)
    if (memory["params_bytes"], memory["moments_bytes"]) != (params,
                                                             moments):
        raise AssertionError(f"dry run 16c: params {memory['params_bytes']}"
                             f" and moments {memory['moments_bytes']} bytes; "
                             f"the trainer holds {params} and {moments}")
    log(f"dry run 16c: {DENSE} on a 1 x 1 mesh: parameters "
        f"{memory['params_bytes']} B and moments {memory['moments_bytes']} B"
        f" == the trainer's on the card; argument_bytes "
        f"{memory['argument_bytes']} (with the inputs and the step counter)")
    del trainer
    free_card()


def distribution(card, kernel_rows) -> None:
    """Phase 16."""
    step_flops(card, kernel_rows)
    loader_and_bytes(card)


# ------------------------------------------------- phase 17: walkthroughs
EXAMPLES_DIR = os.path.join(HERE, "examples")
WALKTHROUGHS = ("policy_playground_torch", "quickstart_torch",
                "serve_guided_kv_torch", "train_guided_offload_torch")
WALKTHROUGH_TRAIN_STEPS = 40


def walkthrough(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_walkthrough(card, name: str, module, argv: list):
    """A walkthrough's ``main(argv)`` on the card, the launch counters
    zeroed just before and read just after: (its result, its launches,
    wall seconds).  Its own lines are logged indented."""
    import io

    import torch

    out = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        got = module.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for line in out.getvalue().rstrip().splitlines():
        log(f"    {name}: {line}")
    return got, launches, wall


def examples_and_contracts(card, kernel_rows) -> None:
    """Phase 17: 17a the port's linter over ``src/repro_torch`` (its CUDA
    sources included) and the walkthroughs, on the tree this run built:
    0 findings; 17b-d the quickstart, the guided-KV serving walkthrough
    and the guided-offload training walkthrough (its ~100M default widths,
    WALKTHROUGH_TRAIN_STEPS steps) on the card.  The serving runs must
    launch the paged kernels, the training runs the flash kernels; the
    serving walkthrough's three policies must give equal greedy streams
    and each move pages; the training losses must be finite and fall, and
    equal bit for bit those of the same run without tiering."""
    from repro_torch.check import iter_source_files, run_check

    paths = [os.path.join(SRC, "repro_torch")] + [
        os.path.join(EXAMPLES_DIR, f"{n}.py") for n in WALKTHROUGHS]
    t0 = time.perf_counter()
    files = iter_source_files(paths)
    findings = run_check(paths)
    lint_s = time.perf_counter() - t0
    if findings:
        raise AssertionError("linter 17a: " + "; ".join(
            f"{f.location()}: {f.rule} {f.message}" for f in findings))
    cu = [f for f in files if f.endswith(".cu")]
    if len(cu) != 4:
        raise AssertionError(f"linter 17a: read {len(cu)} CUDA sources, "
                             f"expected 4: {cu}")
    log(f"linter 17a: repro_torch.check over {len(files)} files "
        f"({len(cu)} .cu): 0 findings in {lint_s:.2f} s")

    name = "quickstart_torch"
    quickstart = walkthrough(name)
    got, launches, wall = run_walkthrough(card, name, quickstart,
                                          ["--device", "cuda"])
    want = quickstart.config().n_layers * got["steps"]
    if launches["flash_attention_fwd"] != want or \
            launches["flash_attention_bwd"] != want or \
            not launches["paged_attention"] or \
            not launches["paged_prefill"]:
        raise AssertionError(f"quickstart 17b: launches {launches}; "
                             f"expected {want} flash forward and backward "
                             f"(remat off) and paged decode and prefill")
    if not all(map(math.isfinite, got["losses"])) or \
            len(got["token_ids"]) != 8:
        raise AssertionError(f"quickstart 17b: losses {got['losses']}, "
                             f"tokens {got['token_ids']}")
    log(f"quickstart 17b: {wall:.2f} s wall; {got['steps']} steps in "
        f"{got['wall_seconds']:.2f} s, "
        f"{got['steps'] / got['wall_seconds']:.2f} steps/s; losses "
        f"{', '.join(f'{x:.4f}' for x in got['losses'])}; launches "
        f"{ {k: v for k, v in launches.items() if v} } {card.tag()}")

    name = "serve_guided_kv_torch"
    runs, launches, wall = run_walkthrough(card, name, walkthrough(name),
                                           ["--device", "cuda"])
    streams = runs["gdt"]["streams"]
    for policy, run in runs.items():
        s = run["stats"]
        if run["streams"] != streams:
            raise AssertionError(f"serving 17c: {policy}'s streams "
                                 f"{run['streams']} != gdt's {streams}")
        if not (s["swap_ins"] > 0 and s["swap_outs"] > 0):
            raise AssertionError(f"serving 17c: {policy} moved no pages: "
                                 f"{s}")
    if not launches["paged_attention"] or not launches["paged_prefill"]:
        raise AssertionError(f"serving 17c: launches {launches}")
    n_tokens = sum(len(t) for t in streams.values()) * len(runs)
    log(f"serving 17c: {wall:.2f} s wall for {len(runs)} policies; "
        f"{n_tokens} generated tokens, {n_tokens / wall:.2f} tokens/s; "
        f"streams equal; swap-ins "
        f"{ {p: int(r['stats']['swap_ins']) for p, r in runs.items()} }; "
        f"launches { {k: v for k, v in launches.items() if v} } "
        f"{card.tag()}")

    steps = WALKTHROUGH_TRAIN_STEPS
    name = "train_guided_offload_torch"
    training = walkthrough(name)
    got, launches, wall = run_walkthrough(
        card, name, training, ["--device", "cuda", "--steps", str(steps)])
    losses = got["losses"]
    want = training.make_config(False).n_layers * steps
    if launches["flash_attention_fwd"] != want or \
            launches["flash_attention_bwd"] != want:
        raise AssertionError(f"training 17d: launches {launches}; "
                             f"expected {want} flash forward and backward")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training 17d: losses {losses}")
    # The same run without tiering, from the same seed-0 init: tiering is
    # lossless, so its losses are the guided run's bit for bit, and every
    # weight matrix has moved from the init.  (Norm scales are bf16 ones:
    # an update below half a bf16 step there rounds away.)
    import torch

    from repro_torch.models import Model

    cfg = training.make_config(False)
    start = {k: v.detach().clone() for k, v in Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0)).state_dict().items()}
    t0 = time.perf_counter()
    plain, _ = training.train(Model(cfg, device="cuda"), steps,
                              training.seq_len(False), None, params=start)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_losses = [m["loss"] for m in plain.metrics_log]
    if plain_losses != losses:
        raise AssertionError(f"training 17d: untiered losses {plain_losses} "
                             f"!= tiered {losses}")
    still = [k for k, p in plain.params.items() if torch.equal(p, start[k])]
    if any(plain.params[k].dim() > 1 for k in still):
        raise AssertionError(f"training 17d: no update moved {still}")
    n_tensors = len(start)
    del plain, start
    result = got["result"]
    log(f"training 17d: {wall:.2f} s wall; {steps} steps in "
        f"{result['wall_seconds']:.2f} s, "
        f"{steps / result['wall_seconds']:.2f} steps/s; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; migrations "
        f"{result['migrations']}, rental {result['transfer_bytes']} B, "
        f"{len(got['slow_groups'])} host-tier groups; launches "
        f"{ {k: v for k, v in launches.items() if v} } {card.tag()}")
    log(f"training 17d untiered: {plain_wall:.2f} s wall; losses "
        f"{', '.join(f'{x:.4f}' for x in plain_losses)} (equal bit for "
        f"bit); every matrix moved, {len(still)} of "
        f"{n_tensors} tensors unmoved: "
        f"{', '.join(still)} {card.tag()}")
    # Only 17d's flash launches join the kernel rows: they run at the rows'
    # head dim, 64.  17b and 17c run the smoke llama (head dim 16), whose
    # launches stay on their own lines above.
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        kernel_rows[name]["launches"] += launches[name]
    free_card()


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

    t0 = time.perf_counter()
    kernel_rows = check_paged_kernels(card)
    kernel_rows["moe_grouped_ffn"] = check_moe_kernel(card)
    check_moe_mixtral(card)
    check_paged_new_paths(card)
    kernel_rows["moe_grouped_ffn_bwd"] = check_moe_backward(card)
    kernel_rows.update(check_moe_per_row_kernel(card))
    kernel_rows.update(check_flash_kernel(card))
    kernel_rows["ssd_scan"] = check_ssd_kernel(card)
    kernel_rows["ssd_scan_bwd"] = check_ssd_backward(card)
    log(f"phase 3 (kernels): {time.perf_counter() - t0:.1f} s")
    for phase in (serve_dense, serve_moe, serve_shared_tiers, serve_cluster,
                  train_dense, train_moe, serve_hybrid, train_hybrid,
                  serve_new_archs, train_and_serve_contiguous,
                  serve_and_train_families, dispatches_and_simulator,
                  distribution, examples_and_contracts):
        t0 = time.perf_counter()
        phase(card, kernel_rows)
        log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
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
