"""Find a serving cell's knee: the highest rate of its open-loop streams
that the program sustains without a growing backlog.

    python3 portbench/tools/knee.py --workload <cell> --seed <n> \\
        --seconds <s> --rates 0.3,0.5,0.7

One process draws the weights once; each rate gets a fresh engine, the
cell's traffic at that rate, and a window of ``--seconds``.  Prints one
JSON line a rate: requests due and answered in the window, the backlog
(due but unanswered) at its end and at its middle, and the time to first
token.  Used once, when a cell is defined; the chosen rate goes into the
cell file's ``stream_params``."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench.harness import catalog, serve, traffic, weights as W
    from portbench.harness.trace import clock
    from portbench.metrics._common import percentile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.serve.api import LLM
    from repro_torch.serve.engine import ServeConfig

    cell = catalog.cell(args.workload)
    m = cell["model"]
    model, _ = W.build_model(m, args.seed, torch.device("cuda"))
    for rate in (float(r) for r in args.rates.split(",")):
        for st in cell["mix"]["streams"]:
            st["rate_per_s"] = rate
        cfg = ServeConfig(**cell["serve"])
        llm = LLM(model, cfg)
        sched = traffic.make(cell["mix"], args.seed, m["vocab_size"],
                             args.seconds)
        drv = serve.Driver(llm, sched)
        serve.warm(llm, cell["mix"], args.seed, m["vocab_size"],
                   cfg.page_size, first_rid=10 ** 9)
        w0 = clock()
        drv.start(w0)
        drv.run_until(w0 + args.seconds / 2)
        mid = sum(1 for r in drv.records if not r.tokens)
        drv.run_until(w0 + args.seconds)
        w1 = clock()
        due = [r for r in drv.records if r.due < w1]
        waiting = [r for r in due if not r.tokens]
        ttft = [1e3 * (r.tokens[0] - r.due) for r in due if r.tokens]
        print(json.dumps({
            "rate_per_s": rate, "due": len(due),
            "answered": len(due) - len(waiting),
            "backlog_mid": mid, "backlog_end": len(waiting),
            "ttft_p50_ms": percentile(ttft, 50),
            "ttft_p90_ms": percentile(ttft, 90),
            "steps": len(drv.step_walls)}), flush=True)
        del llm, drv
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path[:0] = [root, os.path.join(root, "src")]
    sys.exit(main(sys.argv[1:]))
