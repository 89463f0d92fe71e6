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
* ``collectives`` and ``memory.temp_bytes``: a second walk, per device,
  on ``meta`` under the cell's ``AbstractMesh`` and rules.  The model
  holds rank 0's blocks (``Model.shard_``), the inputs and the cache are
  its blocks (``Model.init_cache`` of the global batch), the moments
  ``AdamW.init``'s (zero1's: the rank's layers only), and the step runs
  tensor- and data-parallel as it runs on a mesh of live ranks (a decode
  cell one ``Model.decode`` step on the rank's cache block, its positions
  split over ``kv_seq``'s axis), but every collective on the abstract
  mesh's groups only records its kind, bytes and group size
  (``dist.collectives.count_collectives``).  ``temp_bytes`` is the peak
  of the bytes that the step's ops allocate and hold at once beyond its
  arguments, counted by ``TempBytes`` (a dispatch mode over the storages
  the ops make and free), the port's counterpart of XLA's compiled
  ``temp_size_in_bytes``.  Every cell gets both, under either
  ``--profile`` and ``--moments``.

One cell that fails, the per-device walk included, is recorded with its
traceback and the sweep goes on.

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
import weakref
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import ARCHS, get as get_config, shapes_for
from ..convert import jax_order
from ..dist.collectives import count_collectives
from ..dist.sharding import (DEFAULT_RULES, FSDP_RULES, Rules,
                             logical_to_pspec, mesh_sizes, spec_block,
                             spec_shards, use_mesh, use_rules)
from ..models import SHAPES, Model
from ..models.common import sharded_bytes
from ..optim.adamw import AdamW
from ..train.step import StepConfig, make_train_step, zero1_layout
from .analysis import cost_of
from .mesh import make_production_mesh


class TempBytes(TorchDispatchMode):
    """The peak bytes of the storages that the ops inside the block
    allocate and that are alive at once: an op's output whose storage is
    neither one of its inputs' (views, in-place ops) nor already counted
    adds its bytes, and they leave the count when the storage is freed.
    What existed before the block (the step's arguments) never counts.
    Works on ``meta`` tensors, whose storages have sizes and no data."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}

    def _freed(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage()._cdata
               for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in ins or key in self._held:
                continue
            self._held[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._freed, key)
            self.peak = max(self.peak, self.live)
        return out

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
               remat: bool = True) -> Tuple[Callable, Dict, Rules, Any]:
    """(step, memory, rules, cfg): the cell's step on ``meta`` tensors at
    the published widths, the per-device bytes of its arguments, and the
    model config it built."""
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
    return fn, memory, rules, cfg


def _local(shape, axes, mesh, rules) -> Tuple[int, ...]:
    """Rank 0's block shape of a tensor of ``shape`` under its logical
    ``axes``."""
    spec = logical_to_pspec(axes, shape, mesh, rules)
    coord = {a: 0 for a in mesh_sizes(mesh)}
    return tuple(sl.stop - sl.start for sl in spec_block(
        spec, shape, mesh_sizes(mesh), coord))


def walk_device(cfg, shape, mesh, rules: Rules,
                moments: str = "tp") -> Tuple[Dict, int]:
    """(collectives, temp_bytes) of rank 0's train, prefill or decode step
    of a ``cfg`` model at ``shape`` (a ``ShapeConfig``) on ``meta`` under
    ``mesh`` and ``rules``: its parameter, moment (``moments="zero1"``:
    ``zero1_layout``'s), input and cache blocks made first, then the step
    run once under ``count_collectives`` and ``TempBytes``."""
    model = Model(cfg, device="meta")
    inputs = {}
    for name, t in model.input_specs(shape).items():
        if name in ("cache", "pos"):
            continue
        axes = _INPUT_AXES.get(name, (None,) * t.dim())[:t.dim()]
        inputs[name] = torch.empty(_local(tuple(t.shape), axes, mesh, rules),
                                   dtype=t.dtype, device="meta")
    with use_rules(rules), use_mesh(mesh):
        model.shard_(mesh)
        if shape.kind == "train":
            named = dict(model.named_parameters())
            params = {n: named[n] for n in jax_order(named)}
            opt = AdamW(lr=1e-4)
            opt_state = opt.init(params, zero1_layout(model, mesh)
                                 if moments == "zero1" else None)
            step = make_train_step(model, opt, StepConfig())

            def fn():
                step(params, opt_state, inputs)
        else:
            cache = model.init_cache(inputs["tokens"].shape[0],
                                     shape.seq_len,
                                     whole_batch=shape.global_batch)
            if shape.kind == "prefill":
                def fn():
                    model.prefill(inputs["tokens"], cache,
                                  patches=inputs.get("patches"),
                                  frames=inputs.get("frames"))
            else:
                def fn():
                    model.decode(inputs["tokens"], cache, shape.seq_len - 1)
        with count_collectives() as coll, TempBytes() as temp:
            fn()
    return coll, temp.peak


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
        fn, memory, rules, cfg = build_cell(arch, shape_name, mesh,
                                            quick_layers, profile=profile,
                                            moments=moments, remat=remat)
        global_cost = cost_of(fn)            # the whole program, no mesh
        rec.update({"status": "ok", "global_cost": global_cost})
        if trace_only:
            rec["trace_only"] = True
        else:
            coll, memory["temp_bytes"] = walk_device(
                cfg, SHAPES[shape_name], mesh, rules, moments)
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
