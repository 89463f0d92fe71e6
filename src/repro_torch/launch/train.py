"""Training launcher of the port (``repro/launch/train.py``, same flags,
plus ``--device``; the card unless ``--device cpu``).

Includes the fault-tolerance drill: heartbeat monitoring, checkpoint
cadence, and restart from the latest checkpoint on a failure injected with
``--simulate-failure``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
      --smoke --device cpu --steps 6 --batch 2 --seq 32 --gdt-budget-mb 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
      --steps 8 --batch 2 --seq 2048 --lr 3e-4
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2_7b \\
      --smoke --device cpu --steps 4 --batch 2 --seq 256 --gdt-budget-mb 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_350m \\
      --smoke --device cpu --steps 4 --batch 2 --seq 128 --gdt-budget-mb 1

Under a mesh (``--mesh DATAxMODEL``: one process a rank, the group named
by the environment of a multi-process launcher such as ``torchrun``; a
1x1 mesh starts its own group of one) each rank trains its blocks on its
data block of every batch, with the JAX dry run's ``--profile`` (``fsdp``:
every leaf's ``embed`` dim over the data axis) and ``--moments``
(``zero1``: a layer's moments on the data rank that owns it):

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \
      --smoke --device cpu --steps 4 --batch 2 --seq 32 --mesh 1x1 \
      --profile fsdp --moments zero1

The hybrid and xLSTM families' sequence must be at most their chunk (128)
or a multiple of it.  The VLM and encoder-decoder families are refused:
their batches need ``patches`` or ``frames``, which ``SyntheticLM`` does
not make (the JAX launcher fails on the missing key).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import time

import torch

from .._device import resolve_device
from ..configs import ARCHS, get, get_smoke
from ..core import GuidanceConfig
from ..data import SyntheticLM
from ..dist.sharding import mesh_coordinate, use_mesh
from ..ft import HeartbeatMonitor
from .mesh import make_test_mesh
from ..models import Model
from ..optim import AdamW, cosine_schedule
from ..train import StepConfig, Trainer, TrainerConfig


# The families whose batches carry a stub frontend's embeddings beside the
# tokens: the VLM's patches, the encoder-decoder's frames.
FRONTEND_INPUTS = {"vlm": "patches", "encdec": "frames"}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=ARCHS)
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0,
                   help="param-init seed (threaded to the Trainer)")
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--compression", choices=["int8"], default=None)
    p.add_argument("--gdt-budget-mb", type=float, default=0,
                   help="enable online guided tiering with this HBM budget")
    p.add_argument("--gdt-interval", type=int, default=10)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--restore", action="store_true")
    p.add_argument("--simulate-failure", type=int, default=0,
                   help="inject a failure at this step and restart")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="train under a (data, model) mesh of that many "
                        "ranks (module docstring)")
    p.add_argument("--profile", default="tp", choices=["tp", "fsdp"],
                   help="parameter layout under --mesh")
    p.add_argument("--moments", default="tp", choices=["tp", "zero1"],
                   help="optimizer-moment layout under --mesh")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if cfg.family in FRONTEND_INPUTS:
        raise SystemExit(
            f"--arch {args.arch}: the {cfg.family} family's batches need "
            f"{FRONTEND_INPUTS[cfg.family]!r}, which SyntheticLM does not "
            f"make (it makes tokens and labels only)")
    cfg = dataclasses.replace(cfg, remat=not args.smoke)
    model = Model(cfg, device=device)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=max(args.steps // 20, 1),
                                   total=args.steps))
    gdt = None
    if args.gdt_budget_mb:
        gdt = GuidanceConfig(enabled=True, strategy="thermos",
                             fast_capacity_bytes=int(
                                 args.gdt_budget_mb * 2**20),
                             interval_steps=args.gdt_interval,
                             promotion_threshold=64 * 1024)
    tcfg = TrainerConfig(
        steps=args.steps, log_every=max(args.steps // 20, 1),
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, gdt=gdt,
        step=StepConfig(accum=args.accum, compression=args.compression),
        seed=args.seed, profile=args.profile, moments=args.moments)
    mesh = None if args.mesh is None else start_mesh(args.mesh, device)
    if mesh is not None and (args.ckpt_dir or args.simulate_failure):
        raise SystemExit("--mesh: checkpoints are not written from a "
                         "rank's blocks")
    with contextlib.nullcontext() if mesh is None else use_mesh(mesh):
        trainer = Trainer(model, opt, tcfg)
    if args.restore and args.ckpt_dir:
        meta = trainer.restore_checkpoint()
        print(f"restored checkpoint at step {meta['step']}")

    src = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)
    monitor = HeartbeatMonitor(n_nodes=1, timeout_s=600.0)
    rows = slice(None)
    if mesh is not None:
        n = int(args.mesh.split("x")[0])
        c = mesh_coordinate(mesh)["data"]
        rows = slice(c * args.batch // n, (c + 1) * args.batch // n)

    def on_device(b):
        return {k: torch.from_numpy(v[rows]).to(device)
                for k, v in b.items()}

    def batches():
        i = 0
        for b in src.iter_host():
            if args.simulate_failure and i == args.simulate_failure:
                raise RuntimeError("injected node failure")
            monitor.beat(0, 0.0)
            i += 1
            yield on_device(b)

    t0 = time.time()
    try:
        result = trainer.run(batches())
    except RuntimeError as e:
        if "injected node failure" not in str(e) or not args.ckpt_dir:
            raise
        print(f"failure detected ({e}); restarting from checkpoint")
        trainer = Trainer(model, opt, dataclasses.replace(
            tcfg, steps=args.steps - args.simulate_failure))
        trainer.restore_checkpoint()
        src2 = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)
        result = trainer.run(on_device(b) for b in src2.iter_host())
    result["total_wall_seconds"] = round(time.time() - t0, 2)
    print(json.dumps(result, indent=1))
    for m in trainer.metrics_log[-5:]:
        print(f"  step {int(m['step']):5d}  loss {m['loss']:.4f}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


def start_mesh(spec: str, device):
    """The (data, model) ``DeviceMesh`` of ``--mesh DATAxMODEL``: over the
    group the environment names (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``), or, for 1x1 without one, a group of
    this process alone on a free local port."""
    import torch.distributed as dist

    data, model = (int(n) for n in spec.split("x"))
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    elif data * model == 1:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group(backend, rank=0, world_size=1,
                                init_method=f"tcp://localhost:{port}")
    else:
        raise SystemExit(f"--mesh {spec}: start one process a rank with "
                         f"a launcher that sets WORLD_SIZE and RANK")
    return make_test_mesh(data, model, device)


if __name__ == "__main__":
    main()
