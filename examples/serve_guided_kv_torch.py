"""Serving with guided KV-page tiering over the PyTorch port: multi-turn
sessions plus one-shot "scan" requests compete for a small HBM page pool;
the paper's machinery (thermos + age fragmentation + ski-rental + decay)
places pages across HBM/host and is compared against LRU and FIFO
eviction.  The workload of ``serve_guided_kv.py``.

Everything goes through the ``LLM`` front door.  The decode is greedy, so
every policy must produce the same token streams: the policies decide
where pages live, never what the model computes.

    PYTHONPATH=src python examples/serve_guided_kv_torch.py --device cpu
    PYTHONPATH=src python examples/serve_guided_kv_torch.py   # on the card
"""

import argparse
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_smoke
from repro_torch.models import Model
from repro_torch.serve import LLM, SamplingParams, ServeConfig

POLICIES = ("gdt", "lru", "fifo")


def drive(llm) -> Dict[int, List[int]]:
    """The session/scan workload of ``serve_guided_kv.py`` through
    ``llm``'s front door: four paused sessions, two of them hot, and a
    one-shot scan request every other round.  The token stream of every
    request, by request id."""
    rng = np.random.default_rng(0)
    prompt = [2, 7, 1, 8, 2, 8]
    handles = {}
    for rid in range(4):
        handles[rid] = llm.submit(prompt, SamplingParams(max_tokens=64),
                                  request_id=rid)
        llm.pause(rid)
    hot, scan_id = [0, 1], 1000
    for r in range(10):
        for rid in hot:
            if llm.is_live(rid):
                llm.resume(rid)
        extra = 2 + (r // 5) % 2
        if r % 5 == 4 and llm.is_live(extra):
            llm.resume(extra)
        llm.step(); llm.step()
        if r % 2 == 1:   # one-shot scan session (cache pollution attempt)
            handles[scan_id] = llm.submit(
                [int(t) for t in rng.integers(1, 400, 16)],
                SamplingParams(max_tokens=2), request_id=scan_id)
            llm.step(); llm.step()
            scan_id += 1
        for rid in list(llm.engine.requests):
            if llm.engine.requests[rid].state == "active":
                llm.pause(rid)
    return {rid: list(h.token_ids) for rid, h in sorted(handles.items())}


def run_policy(model: Model, policy: str) -> Dict[str, Any]:
    """The workload under ``policy`` with 12 HBM pages, too few for it:
    its stats and its streams."""
    llm = LLM(model, ServeConfig(
        max_batch=2, page_size=4, hbm_pages=12, host_pages=160,
        policy=policy, interval_steps=4))
    streams = drive(llm)
    return {"stats": llm.stats(), "streams": streams}


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, Any]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = dataclasses.replace(get_smoke("llama3_2_1b"), remat=False)
    model = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    print(f"{'policy':8s} {'swap-ins':>8s} {'swap-outs':>9s} "
          f"{'bytes moved':>12s}")
    runs: Dict[str, Dict[str, Any]] = {}
    for policy in POLICIES:
        runs[policy] = run_policy(model, policy)
        s = runs[policy]["stats"]
        base = runs["gdt"]["stats"]["bytes_moved"]
        rel = f"({s['bytes_moved']/max(base,1):.2f}x gdt)"
        print(f"{policy:8s} {int(s['swap_ins']):8d} "
              f"{int(s['swap_outs']):9d} "
              f"{s['bytes_moved']/1024:9.0f} KiB {rel}")
    same = all(runs[p]["streams"] == runs["gdt"]["streams"]
               for p in POLICIES)
    n_tokens = sum(len(t) for t in runs["gdt"]["streams"].values())
    print(f"\ngreedy streams equal across {', '.join(POLICIES)}: {same} "
          f"({len(runs['gdt']['streams'])} requests, {n_tokens} tokens)")
    print("gdt resists scan pollution: one-shot pages never build access "
          "density, so thermos leaves them on the host tier while hot "
          "sessions keep their pages resident.")
    return runs


if __name__ == "__main__":
    main()
