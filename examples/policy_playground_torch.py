"""Policy playground over the PyTorch port: the paper's decision machinery
on a synthetic workload — watch knapsack / hotset / thermos disagree and
the ski-rental break-even rule decide when migration pays.  The same
walkthrough as ``policy_playground.py``, over ``repro_torch.core``; it
prints the same lines.

    PYTHONPATH=src python examples/policy_playground_torch.py --device cpu
    PYTHONPATH=src python examples/policy_playground_torch.py   # on the card

The walkthrough runs on the host; ``--device`` is resolved as every entry
point of the port resolves it (the card unless the CPU is asked for), so
it refuses to start without a card rather than fall back.
"""

import argparse
from typing import List, Optional

from repro_torch._device import resolve_device
from repro_torch.core import (
    ArenaBackend,
    ArenaManager,
    CLX,
    GuidanceConfig,
    GuidanceRuntime,
    SiteKind,
    SiteRegistry,
    recommend,
)

MB = 2**20


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    reg = SiteRegistry()
    mgr = ArenaManager(reg, promotion_threshold=1 * MB,
                       fast_capacity_bytes=100 * MB)
    # A workload: hot small site, warm big site, cold big site; the big
    # ones arrive first (first-touch grabs the fast tier).
    cold = reg.register(["big_cold_array"], SiteKind.OTHER)
    warm = reg.register(["big_warm_array"], SiteKind.OTHER)
    hot = reg.register(["hot_workset"], SiteKind.OTHER)
    mgr.allocate(cold, 60 * MB)
    mgr.allocate(warm, 50 * MB)
    mgr.allocate(hot, 30 * MB)
    print("first-touch placement (fast fraction):")
    for a in mgr:
        print(f"  {a.site.label:16s} {a.resident_bytes/MB:5.0f} MiB  "
              f"fast={a.fast_fraction:.2f}")

    backend = ArenaBackend(mgr, CLX)
    gdt = GuidanceRuntime(backend, CLX,
                          GuidanceConfig(strategy="thermos",
                                         fast_capacity_bytes=100 * MB,
                                         interval_steps=1))
    print("\nintervals (10k accesses/interval to hot, 3k to warm, 10 cold):")
    for i in range(8):
        mgr.touch(hot, 200_000)
        mgr.touch(warm, 60_000)
        mgr.touch(cold, 10)
        rec = gdt.on_step()
        d = rec.decision
        print(f"  t={i}: rental {d.rental_cost_ns/1e6:8.2f} ms vs purchase "
              f"{d.purchase_cost_ns/1e6:8.2f} ms -> "
              f"{'MIGRATE' if rec.migrated else 'wait'}"
              + (f" ({rec.bytes_moved/MB:.0f} MiB)" if rec.migrated else ""))
    print("\nfinal placement:")
    for a in mgr:
        print(f"  {a.site.label:16s} fast={a.fast_fraction:.2f}")

    # Compare the three MemBrain engines on the same profile.
    prof = backend.profiler.snapshot()
    print("\nrecommendation engines at 100 MiB capacity:")
    for strat in ("knapsack", "hotset", "thermos"):
        recs = recommend(prof, 100 * MB, strat)
        desc = ", ".join(
            f"{r.label}={recs.fractions.get(r.arena_id, 0.0):.2f}"
            for r in prof.rows)
        print(f"  {strat:8s}: {desc}")


if __name__ == "__main__":
    main()
