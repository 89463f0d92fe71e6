"""Serving launcher of the port (``repro/launch/serve.py``, same flags, plus
``--device``; the card unless ``--device cpu``).

Runs a synthetic multi-session workload through the ``LLM`` front door
(``serve.api``) and prints throughput + tiering telemetry
(``launch.analysis.serving_summary``), including per-``finish_reason``
totals.  Policies: gdt (the paper's machinery), lru, fifo.
``--temperature/--top-k/--top-p`` switch the sessions from greedy decode to
seeded sampling.  ``--replicas N`` serves from N engines behind a
``Router``; ``--rolling-restart`` replaces every replica at the run's
midpoint while the sessions keep decoding.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \\
      --smoke --device cpu --replicas 2 --rolling-restart
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \\
      --replicas 2 --rolling-restart --sessions 8 --rounds 8 --prompt-len 512
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from ..configs import ARCHS, get, get_smoke
from ..serve import LLM, SamplingParams, ServeConfig
from .analysis import serving_summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=ARCHS)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--sessions", type=int, default=6)
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--policy", choices=["gdt", "lru", "fifo"], default="gdt")
    p.add_argument("--scheduler", choices=["fifo", "priority", "drr"],
                   default="fifo",
                   help="scheduling policy: admission order, preemption "
                        "victims, and the per-step prefill/decode split")
    p.add_argument("--prefill-chunk-tokens", type=int, default=0,
                   help="interleave long prompt ingests at this many "
                        "tokens per engine step (0 = one-shot prefill)")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--hbm-pages", type=int, default=None,
                   help="HBM pages per replica (default: 24, or enough "
                        "for --max-batch sessions of --prompt-len + "
                        "--max-new tokens if that is more)")
    p.add_argument("--host-pages", type=int, default=256)
    p.add_argument("--max-batch", type=int, default=2)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prefix-cache", action="store_true",
                   help="enable the cross-request radix prefix cache")
    p.add_argument("--min-prefix-pages", type=int, default=1,
                   help="pages a prefix must span to enter the cache")
    p.add_argument("--shared-prefix-len", type=int, default=0,
                   help="give every session this many identical leading "
                        "prompt tokens (a synthetic shared system prompt)")
    p.add_argument("--offchip-experts", action="store_true",
                   help="MoE only: keep expert FFN weights in host memory "
                        "and dispatch through a bounded expert cache on "
                        "the device under the guided controller")
    p.add_argument("--expert-cache-size", type=int, default=0,
                   help="expert-cache capacity in blocks, shared across "
                        "layers (0 = every block fits)")
    p.add_argument("--no-expert-double-buffer", action="store_true",
                   help="disable the double-buffered expert prefetch: "
                        "every cache miss becomes a blocking demand fetch")
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas behind the router (least-loaded "
                        "dispatch; failures/drains migrate in-flight "
                        "requests bitwise)")
    p.add_argument("--rolling-restart", action="store_true",
                   help="restart every replica in sequence at the run's "
                        "midpoint (requires --replicas >= 2); in-flight "
                        "requests warm-migrate to survivors")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.rolling_restart and args.replicas < 2:
        raise SystemExit("--rolling-restart needs --replicas >= 2 "
                         "(a lone replica has no migration target)")

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if cfg.family not in ("dense", "moe"):
        raise SystemExit("paged engine serves decoder LMs (dense/moe)")
    # A session's whole lifetime must fit one sequence's page table, and
    # one decode batch of sessions the HBM tier.
    seq_pages = -(-(args.prompt_len + args.max_new) // args.page_size)
    hbm_pages = (args.hbm_pages if args.hbm_pages is not None
                 else max(24, args.max_batch * seq_pages + 1))
    # --seed governs BOTH param init and the per-session sampling streams
    # (sessions fold their id in below): one flag reproduces a run.
    llm = LLM.from_arch(args.arch, smoke=args.smoke, cfg=ServeConfig(
        max_batch=args.max_batch, page_size=args.page_size,
        hbm_pages=hbm_pages, host_pages=args.host_pages,
        policy=args.policy, scheduler=args.scheduler,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        enable_prefix_cache=args.prefix_cache,
        min_prefix_pages=args.min_prefix_pages,
        max_pages_per_seq=max(32, seq_pages),
        expert_offchip=args.offchip_experts,
        expert_cache_size=args.expert_cache_size,
        expert_double_buffer=not args.no_expert_double_buffer),
        seed=args.seed, replicas=args.replicas, device=device)

    rng = np.random.default_rng(0)
    shared = [int(t) for t in
              rng.integers(1, cfg.vocab, args.shared_prefix_len)]
    handles = {}
    for rid in range(args.sessions):
        tail_len = max(args.prompt_len - args.shared_prefix_len, 1)
        prompt = shared + [int(t)
                           for t in rng.integers(1, cfg.vocab, tail_len)]
        handles[rid] = llm.submit(prompt, SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=args.seed + rid,
            max_tokens=args.max_new), request_id=rid)
        # Chunked submits park in 'prefilling' (no schedulable position to
        # pause yet); they join the pause/resume dance once active.
        if llm.engine.requests[rid].state == "active":
            llm.pause(rid)

    hot = list(range(min(2, args.sessions)))
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    tokens = 0
    # Rolling restart at the midpoint: replace every original replica one
    # at a time while the workload keeps stepping — in-flight requests
    # migrate (warm where pages fit) and no stream drops or changes.
    restart_round = args.rounds // 2 if args.rolling_restart else -1
    for r in range(args.rounds):
        if r == restart_round:
            for rep_id in [rep.replica_id for rep in llm.cluster.replicas]:
                llm.cluster.restart_replica(rep_id)
        for rid in hot:
            if llm.is_live(rid):
                llm.resume(rid)
        extra = (r // 3) % args.sessions
        if r % 3 == 2 and llm.is_live(extra):
            llm.resume(extra)
        for _ in range(4):
            tokens += len(llm.step())
        for rid in list(llm.engine.requests):
            if llm.engine.requests[rid].state == "active":
                llm.pause(rid)
    sync()
    wall = time.perf_counter() - t0
    stats = serving_summary(llm.engine)
    stats.update({
        "device": str(device),
        "policy": args.policy,
        "temperature": args.temperature,
        "tokens": tokens,
        "tokens_per_second": round(tokens / wall, 2),
        "wall_seconds": round(wall, 2),
        "finished_streams": {
            rid: h.finish_reason for rid, h in handles.items() if h.finished},
    })
    print(json.dumps(stats, indent=1))
    return stats


if __name__ == "__main__":
    main()
