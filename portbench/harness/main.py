"""One run of one cell: the steps of ``run.py``.

Exit codes: 0 with the result line; 2 for bad arguments or an unknown
cell; 3 without the CUDA devices the cell asks for; 4 when a module of JAX
or of the JAX package was loaded (no result line in either case)."""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict, List, Optional

# Top-level module names that must not be loaded in a run's process: JAX
# and the JAX package the port was made from (compared whole: the port's
# own ``repro_torch`` is allowed).
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names) -> List[str]:
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def devices_ok(chips: int) -> Optional[str]:
    """None when the devices are there, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} CUDA devices, "
                f"{torch.cuda.device_count()} are visible")
    return None


def read_metrics(rec, entries: List[Dict]) -> Dict[str, Dict]:
    from . import catalog

    out = {}
    for e in entries:
        v = catalog.metric_module(e["name"]).read(rec)
        if v is None:
            log(f"{e['name']}: nothing to read")
            continue
        out[e["name"]] = {"value": float(v), "unit": e["unit"]}
    return out


def check_serve(cell, seed, drv, weights) -> Dict[str, float]:
    from . import correct

    c = cell["correct"]
    rids = correct.serve_sample(drv.served, drv.greedy, seed,
                                int(c["sample_tokens"]),
                                int(c["sample_requests"]))
    n = sum(len(drv.served[r]) for r in rids)
    log(f"check: {len(rids)} greedy requests, {n} served tokens "
        f"against the float32 reference")
    gaps = correct.serve_gaps(weights, cell["model"], drv.prompts,
                              drv.served, rids) if rids else []
    return correct.gap_numbers(gaps)


def check_train(cell, seed, readings, device) -> Dict[str, float]:
    from portbench.reference import training

    from . import correct, train, weights as W

    m, tc, mix = cell["model"], cell["train"], cell["mix"]
    start = W.draw(m, seed, device)
    batches = []
    for i in range(int(tc["check_steps"])):
        b = train.batch(seed, i, m["vocab_size"], int(mix["batch"]),
                        int(mix["seq"]), device)
        batches.append((b["tokens"], b["labels"]))
    ref = training.run(start, m, batches, tc["optimizer"])
    log(f"check: losses {readings['losses']} reference {ref['losses']}")
    return correct.train_numbers(readings, ref)


def main(argv: List[str], t_process: float) -> int:
    args = parse(argv)
    from . import catalog

    try:
        cell = catalog.cell(args.workload)
    except FileNotFoundError as e:
        log(f"unknown cell {args.workload!r}: {e}")
        return 2
    why = devices_ok(int(cell["chips"]))
    if why is not None:
        log(why)
        return 3
    import torch

    from portbench.reference import strict_f32

    from . import correct, serve, trace, train

    device = torch.device("cuda")
    traced = bool(args.trace)
    if cell["driver"] == "serve":
        rec, drv, weights, program = serve.run_cell(
            cell, args.seed, args.seconds, traced, device, t_process)
        log(f"window {rec.window[1] - rec.window[0]:.3f} s: "
            f"{rec.attempted} requests or turns due, {rec.failed} without a "
            f"first token; drain ended "
            f"{rec.drain_end - rec.window[1]:.3f} s after the window")
        d = {k: rec.stats1[k] - rec.stats0[k] for k in (
            "steps", "decode_dispatches", "prefill_tokens", "admissions",
            "preemptions", "bytes_moved", "starved_steps")}
        log(f"in the window: {d}")
        from portbench.metrics import _common as C

        for what, v in (("ttft_ms", C.ttft_ms(rec)), ("itl_ms", C.itl_ms(rec))):
            log(f"{what}: {len(v)} samples; p50 {C.percentile(v, 50)} "
                f"p90 {C.percentile(v, 90)} p95 {C.percentile(v, 95)} "
                f"p98 {C.percentile(v, 98)} p99 {C.percentile(v, 99)}")
    else:
        rec, readings, program, weights = train.run_cell(
            cell, args.seed, args.seconds, traced, device, t_process)
        log(f"window {rec.window[1] - rec.window[0]:.3f} s: "
            f"{len(rec.steps)} steps")
    bench = catalog.benchmark()
    metrics = read_metrics(rec, catalog.metrics_for(bench, cell["name"],
                                                    traced))
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(rec.memory_peak_bytes)}
    result = {"correct": False, "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics, "device": dev}
    if traced:
        d = rec.device
        dev["busy_s"] = d.busy_s if d is not None else 0.0
        dev["window_s"] = d.window_s if d is not None else 0.0
        if d is not None:
            result["breakdown"] = trace.breakdown(d)
    # Free the program's state before the reference runs.
    if cell["driver"] == "serve":
        drv.llm = None
    del program
    rec.device = None
    gc.collect()
    torch.cuda.empty_cache()
    strict_f32()
    if cell["driver"] == "serve":
        numbers = check_serve(cell, args.seed, drv, weights)
    else:
        del weights
        gc.collect()
        torch.cuda.empty_cache()
        numbers = check_train(cell, args.seed, readings, device)
    log(f"check numbers: {numbers}")
    limits = {k: float(v) for k, v in cell["correct"]["limits"].items()}
    result["correct"] = correct.verdict(numbers, limits)
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in limits}
    found = forbidden_modules(list(sys.modules))
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 4
    print(json.dumps(result), flush=True)
    for line in correct.lines(numbers, limits):
        print(line, file=sys.stderr, flush=True)
    return 0
