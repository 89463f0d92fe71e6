"""The port's dry run (``repro/launch/dryrun.py``): every (architecture x
input shape) cell on the production meshes, traced on the ``meta`` device
at the published widths, with no card and no weights.

For each cell it records

* ``global_cost``: ``launch.analysis.cost_of`` over the cell's step (train:
  the loss, its backward and the AdamW update; prefill; one decode step):
  exact, loop-aware FLOPs and the two byte estimates, for the whole
  program;
* ``memory.argument_bytes``: the bytes one device holds of the step's
  arguments (parameters, AdamW moments, cache and inputs) under the specs
  the cell's rules resolve on the abstract production mesh, and each
  part's bytes beside it;
* ``collectives``: what ``dist.collectives.count_collectives`` saw while
  the step ran.  It is empty on the dense paths: the JAX package's
  tensor-parallel collectives come from GSPMD, which the port does not
  have yet (ROADMAP.md A20);
* ``memory.temp_bytes``: null, with the reason.  The reference reads it
  from XLA's compiled memory analysis; the port has no compiled program
  for a mesh until A20.

One cell that fails is recorded with its traceback and the sweep goes on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_1b \\
      --shape decode_32k --mesh single --outdir /tmp/dr
Results land in <outdir>/<mesh>/<arch>__<shape>.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs import ARCHS, get as get_config, shapes_for
from ..convert import jax_order
from ..dist.collectives import count_collectives
from ..dist.sharding import (DEFAULT_RULES, FSDP_RULES, Rules,
                             logical_to_pspec, mesh_sizes, spec_shards,
                             use_mesh, use_rules)
from ..models import SHAPES, Model
from ..models.common import sharded_bytes
from ..optim.adamw import AdamW
from ..train.step import StepConfig, make_train_step
from .analysis import cost_of
from .mesh import make_production_mesh

TEMP_BYTES_REASON = ("the port has no compiled program for a mesh to read "
                     "temporaries from; it comes with DTensor tensor "
                     "parallelism (ROADMAP.md A20)")

_INPUT_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
               "frames": ("batch", "seq", None),
               "patches": ("batch", "seq", None), "pos": ()}


def input_bytes(inputs: Dict[str, torch.Tensor], mesh, rules: Rules) -> int:
    """Per-device bytes of the step's inputs (the reference's
    ``_input_pspec`` axes; the cache is counted by its defs)."""
    total = 0
    for name, t in inputs.items():
        axes = _INPUT_AXES.get(name, (None,) * t.dim())[:t.dim()]
        spec = logical_to_pspec(axes, tuple(t.shape), mesh, rules)
        total += t.numel() * t.element_size() // spec_shards(spec, mesh)
    return total


def cell_rules(shape_name: str, profile: str = "tp") -> Rules:
    """The rules of a cell, as the reference's ``build_cell`` picks them:
    ``long_500k`` shards the KV sequence over data; decode over model, with
    the head dims replicated."""
    base = FSDP_RULES if profile == "fsdp" else DEFAULT_RULES
    shape = SHAPES[shape_name]
    if shape_name == "long_500k":
        return dict(base, kv_seq="data")
    if shape.kind == "decode":
        return dict(base, kv_seq="model", head_dim=None, qdh=None)
    return base


def build_cell(arch: str, shape_name: str, mesh, quick_layers: int = 0,
               profile: str = "tp", moments: str = "zero1",
               remat: bool = True) -> Tuple[Callable, Dict, Rules]:
    """(step, memory, rules): the cell's step on ``meta`` tensors at the
    published widths, and the per-device bytes of its arguments."""
    cfg = get_config(arch)
    if quick_layers:
        cfg = dataclasses.replace(cfg,
                                  n_layers=min(cfg.n_layers, quick_layers))
    if not remat:
        cfg = dataclasses.replace(cfg, remat=False)
    model = Model(cfg, device="meta")
    shape = SHAPES[shape_name]
    rules = cell_rules(shape_name, profile)
    defs = model.param_defs()
    inputs = model.input_specs(shape)
    memory: Dict[str, Any] = {
        "params_bytes": sharded_bytes(defs, mesh, rules)}

    if shape.kind == "train":
        named = dict(model.named_parameters())
        params = {n: named[n] for n in jax_order(named)}
        opt = AdamW(lr=1e-4)
        opt_state = opt.init(params)
        step = make_train_step(model, opt, StepConfig())
        m_rules = dict(rules, layers="data") if moments == "zero1" else rules
        # m and v in f32; the step counter is an int32 scalar.
        memory["moments_bytes"] = 2 * sharded_bytes(
            defs, mesh, m_rules, dtype=torch.float32)
        memory["opt_step_bytes"] = 4
        memory["input_bytes"] = input_bytes(inputs, mesh, rules)

        def fn():
            step(params, opt_state, inputs)
    elif shape.kind == "prefill":
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        cdefs = model.cache_defs(shape.global_batch, shape.seq_len)
        memory["cache_bytes"] = sharded_bytes(cdefs, mesh, rules)
        memory["input_bytes"] = input_bytes(inputs, mesh, rules)

        def fn():
            model.prefill(inputs["tokens"], cache,
                          patches=inputs.get("patches"),
                          frames=inputs.get("frames"))
    else:
        cdefs = model.cache_defs(shape.global_batch, shape.seq_len)
        memory["cache_bytes"] = sharded_bytes(cdefs, mesh, rules)
        batch = {"tokens": inputs["tokens"], "pos": inputs["pos"]}
        memory["input_bytes"] = input_bytes(batch, mesh, rules)
        cache = inputs["cache"]

        def fn():
            model.decode(inputs["tokens"], cache, shape.seq_len - 1)
    memory["argument_bytes"] = sum(v for k, v in memory.items()
                                   if k.endswith("_bytes"))
    memory["temp_bytes"] = None
    memory["temp_bytes_reason"] = TEMP_BYTES_REASON
    return fn, memory, rules


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str, outdir: str,
             quick_layers: int = 0, profile: str = "tp",
             moments: str = "zero1", remat: bool = True,
             trace_only: bool = False) -> Dict[str, Any]:
    """Trace one cell and write its JSON record.  ``trace_only`` keeps the
    cost alone (it does not depend on the mesh, so a 1 x 1 mesh gives the
    production numbers)."""
    os.makedirs(outdir, exist_ok=True)
    out_path = os.path.join(outdir, f"{arch}__{shape_name}.json")
    sizes = mesh_sizes(mesh)
    devices = 1
    for s in sizes.values():
        devices *= s
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "devices": devices,
                           "status": "running"}
    t0 = time.time()
    try:
        fn, memory, rules = build_cell(arch, shape_name, mesh, quick_layers,
                                       profile=profile, moments=moments,
                                       remat=remat)
        with use_rules(rules), use_mesh(mesh), count_collectives() as coll:
            global_cost = cost_of(fn)
        rec.update({"status": "ok", "global_cost": global_cost})
        if trace_only:
            rec["trace_only"] = True
        else:
            rec.update({"memory": memory, "collectives": coll})
    # check: disable=EXC01 -- the sweep: one cell failing to trace must
    # not stop the others; the failure is recorded (type, message,
    # traceback) in the cell's JSON.
    except Exception as e:  # noqa: BLE001
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    rec["wall_seconds"] = round(time.time() - t0, 2)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default=None, help="comma list; default all")
    p.add_argument("--shape", default=None, help="comma list; default all")
    p.add_argument("--mesh", default="both",
                   choices=["single", "multi", "both"])
    p.add_argument("--outdir", default="results/dryrun_torch")
    p.add_argument("--quick-layers", type=int, default=0,
                   help="truncate the layer count (smoke runs only)")
    p.add_argument("--profile", default="tp", choices=["tp", "fsdp"],
                   help="sharding profile (see dist/sharding.py)")
    p.add_argument("--moments", default="zero1", choices=["zero1", "tp"],
                   help="optimizer-moment sharding")
    p.add_argument("--no-remat", action="store_true",
                   help="disable activation rematerialisation")
    args = p.parse_args(argv)

    archs = args.arch.split(",") if args.arch else ARCHS
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("pod256", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("pod512", make_production_mesh(multi_pod=True)))

    failures = []
    for mesh_name, mesh in meshes:
        for arch in archs:
            cells = shapes_for(arch)
            names = args.shape.split(",") if args.shape else list(cells)
            for shape_name in names:
                if shape_name not in cells:
                    print(f"SKIP {mesh_name} {arch} {shape_name} "
                          f"(documented inapplicability)", flush=True)
                    continue
                rec = run_cell(arch, shape_name, mesh, mesh_name,
                               os.path.join(args.outdir, mesh_name),
                               quick_layers=args.quick_layers,
                               profile=args.profile, moments=args.moments,
                               remat=not args.no_remat)
                flops = rec.get("global_cost", {}).get("flops", float("nan"))
                arg = rec.get("memory", {}).get("argument_bytes", 0)
                print(f"{rec['status']:4s} {mesh_name} {arch:22s} "
                      f"{shape_name:12s} {rec['wall_seconds']:8.1f}s "
                      f"gflops={flops / 1e9:.3e} argGB={arg / 1e9:.3f}",
                      flush=True)
                if rec["status"] != "ok":
                    failures.append((mesh_name, arch, shape_name,
                                     rec.get("error")))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("dry run complete: all cells traced")


if __name__ == "__main__":
    main()
