"""Readings that set a cell's correctness limits: the program's and the
control's, and for a training cell also a fault's.

    python3 portbench/tools/control.py --workload <cell> --seconds <s> \\
        --seeds 11,12,13

Serving, for each seed: one run of the cell as the benchmark runs it
(set-up, a window of ``--seconds``, the drain), then over the sample the
benchmark's check draws, the float32 reference's gap of each served token
(the program's reading) and of the token that the reference computed in
the control precision (float8 e4m3 products, the step below the
configured bfloat16) puts first (the control's reading).

Training, for each seed: the set-up of a run (its first steps through the
trainer, no window), then the numbers of the benchmark's check for the
program, for the reference computed in float8 products (the control), for
the reference that leaves out half of each batch and takes the mean over
the rest (a fault) and for the reference that leaves its parameters
unchanged (a fault: its losses; its gradients and changes read 1 by the
check's definition), each against the float32 reference, with the leaves
that read widest.

One JSON line a seed.  The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench.harness import catalog, correct, serve
    from portbench.reference import strict_f32
    from portbench.reference.decoder import FP8

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = catalog.cell(args.workload)
    if cell["driver"] == "train":
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(train_readings(cell, seed,
                                            torch.device("cuda"))),
                  flush=True)
        return 0
    c = cell["correct"]
    for seed in (int(s) for s in args.seeds.split(",")):
        rec, drv, weights, program = serve.run_cell(
            cell, seed, args.seconds, False, torch.device("cuda"),
            time.perf_counter())
        drv.llm = None
        del program
        gc.collect()
        torch.cuda.empty_cache()
        strict_f32()
        rids = correct.serve_sample(drv.served, drv.greedy, seed,
                                    int(c["sample_tokens"]),
                                    int(c["sample_requests"]))
        args_ = (weights, cell["model"], drv.prompts, drv.served, rids)
        prog = correct.serve_gaps(*args_)
        ctrl = correct.serve_gaps(*args_, control=FP8())
        print(json.dumps({
            "seed": seed, "requests": len(rids), "tokens": len(prog),
            "program": correct.gap_numbers(prog),
            "control": correct.gap_numbers(ctrl)}), flush=True)
        del weights, drv, rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def worst_leaves(got, ref, n: int = 4):
    """The look: the leaves with the widest gaps of first gradients and of
    changes, with their gaps and their reference norms."""
    from portbench.harness import correct

    out = {}
    for key in ("grad_norms", "change_norms"):
        gaps = correct.leaf_gaps(got[key], ref[key], list(ref[key]))
        top = sorted(gaps, key=gaps.get, reverse=True)[:n]
        out[key] = [[name, gaps[name], ref[key][name]] for name in top]
    return out


def train_readings(cell, seed: int, device):
    import torch

    from portbench.harness import correct, train, weights as W
    from portbench.reference import strict_f32, training
    from portbench.reference.decoder import FP8

    rec, readings, program, weights = train.run_cell(
        cell, seed, 0.0, False, device, time.perf_counter())
    del program, weights, rec
    gc.collect()
    torch.cuda.empty_cache()
    strict_f32()
    m, mix, opt = cell["model"], cell["mix"], cell["train"]["optimizer"]
    batches = []
    for i in range(int(cell["train"]["check_steps"])):
        b = train.batch(seed, i, m["vocab_size"], int(mix["batch"]),
                        int(mix["seq"]), device)
        batches.append((b["tokens"], b["labels"]))
    start = W.draw(m, seed, device)
    out = {"seed": seed}
    t = time.perf_counter()
    ref = training.run(start, m, batches, opt)
    out["reference_s"] = time.perf_counter() - t
    out["program"] = correct.train_numbers(readings, ref)
    out["program_worst"] = worst_leaves(readings, ref)
    half = slice(0, int(mix["batch"]) // 2)
    for name, o, kw in (("control", opt, {"prec": FP8()}),
                        ("half_batch", opt, {"rows": half}),
                        ("unchanged", dict(opt, lr=0.0), {})):
        t = time.perf_counter()
        got = training.run(start, m, batches, o, **kw)
        out[name] = correct.train_numbers(got, ref)
        out[name + "_worst"] = worst_leaves(got, ref)
        out[name + "_s"] = time.perf_counter() - t
        del got
        gc.collect()
        torch.cuda.empty_cache()
    out["losses"] = readings["losses"]
    return out


if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path[:0] = [root, os.path.join(root, "src")]
    sys.exit(main(sys.argv[1:]))
