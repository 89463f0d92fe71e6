"""End-to-end training over the PyTorch port: train a ~100M-parameter
decoder LM with the paper's online guidance managing HBM-vs-host
placement of the training state under a budget.  The walkthrough of
``train_guided_offload.py``.

    PYTHONPATH=src python examples/train_guided_offload_torch.py   # card, ~100M, 300 steps
    PYTHONPATH=src python examples/train_guided_offload_torch.py \\
        --tiny --device cpu                                       # CI-sized

The run prints: loss curve, the controller's migration decisions
(ski-rental rental vs purchase), what ended up on the host tier, and the
per-step rental (PCIe) traffic.  On the card the placer moves the slow
groups to pinned host memory; on the CPU its tiers are labels only.
"""

import argparse
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core import GuidanceConfig
from repro_torch.data import SyntheticLM
from repro_torch.models import Model
from repro_torch.models.common import count_params
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import Trainer, TrainerConfig


def make_config(tiny: bool) -> ModelConfig:
    if tiny:
        return ModelConfig(arch="lm-12m", family="dense", n_layers=4,
                           d_model=128, n_heads=4, kv_heads=4, d_ff=512,
                           vocab=8192, remat=False)
    # ~101M params: 2*32000*512 embeddings + 12 layers of d=512/ff=2048.
    return ModelConfig(arch="lm-100m", family="dense", n_layers=12,
                       d_model=512, n_heads=8, kv_heads=8, d_ff=2048,
                       vocab=32000, remat=False)


def seq_len(tiny: bool) -> int:
    return 64 if tiny else 256


def guidance(budget: int) -> GuidanceConfig:
    """The walkthrough's guidance: thermos, with ``budget`` bytes of HBM."""
    return GuidanceConfig(enabled=True, strategy="thermos",
                          fast_capacity_bytes=budget, interval_steps=10,
                          promotion_threshold=256 * 1024)


def train(model: Model, steps: int, seq_len: int,
          gdt: Optional[GuidanceConfig],
          params: Optional[Mapping[str, torch.Tensor]] = None
          ) -> Tuple[Trainer, Dict[str, Any]]:
    """``steps`` of AdamW (cosine from 3e-3, a tenth of them warm-up) on
    ``SyntheticLM`` (batch 8 x ``seq_len``, seed 0) under ``gdt`` (None:
    no tiering), from ``params`` or a seed-0 init."""
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=steps // 10, total=steps))
    trainer = Trainer(model, opt,
                      TrainerConfig(steps=steps,
                                    log_every=max(steps // 10, 1), gdt=gdt,
                                    seed=0),
                      params=params)
    src = SyntheticLM(model.cfg.vocab, seq_len=seq_len, global_batch=8,
                      seed=0)

    def batches():
        for b in src.iter_host():
            yield {k: torch.from_numpy(v).to(model.device)
                   for k, v in b.items()}

    return trainer, trainer.run(batches())


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--budget-frac", type=float, default=0.6,
                    help="HBM budget as a fraction of training state")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = make_config(args.tiny)
    steps = args.steps or (40 if args.tiny else 300)
    model = Model(cfg, device=device)
    n = count_params(model.param_defs())
    print(f"model: {cfg.arch}  params={n/1e6:.1f}M  steps={steps}")

    state_bytes = int(n * 2 + 2 * n * 4)     # bf16 params + f32 m,v
    budget = int(state_bytes * args.budget_frac)
    print(f"training state ~{state_bytes/2**20:.0f} MiB, "
          f"HBM budget {budget/2**20:.0f} MiB "
          f"({args.budget_frac:.0%}) -> guidance must offload the rest")

    trainer, result = train(model, steps, seq_len(args.tiny),
                            guidance(budget))
    print("\nloss curve:")
    for m in trainer.metrics_log:
        print(f"  step {int(m['step']):4d}  loss {m['loss']:.4f}")

    placer = trainer.placer
    print("\ntiering outcome:")
    print(f"  migrations:            {result['migrations']}")
    print(f"  bytes migrated:        {result['bytes_migrated']/2**20:.1f} MiB")
    print(f"  rental transfers:      {result['transfer_bytes']/2**20:.1f} MiB")
    print(f"  resident on host tier: {placer.slow_bytes()/2**20:.1f} MiB")
    print(f"  resident in HBM:       {placer.fast_bytes()/2**20:.1f} MiB")
    for rec in trainer.gdt.history:
        if rec.migrated:
            d = rec.decision
            print(f"  interval {rec.interval_index}: migrated "
                  f"{rec.bytes_moved/2**20:.1f} MiB "
                  f"(rental {d.rental_cost_ns/1e6:.1f} ms > purchase "
                  f"{d.purchase_cost_ns/1e6:.1f} ms)")
    # Groups on the slow tier, by site label:
    slow = [
        (key, sum(e.nbytes for e in placer.entries(arena.arena_id)
                  if e.kind == placer.slow_kind))
        for key, (site, arena, names) in trainer._site_groups.items()
    ]
    slow = [(k, b) for k, b in slow if b]
    if slow:
        print("\nhost-tier site groups (coldest first):")
        for k, b in sorted(slow, key=lambda kb: -kb[1])[:10]:
            print(f"  {k:40s} {b/2**20:8.1f} MiB")
    return {"losses": [m["loss"] for m in trainer.metrics_log],
            "result": result, "slow_groups": slow}


if __name__ == "__main__":
    main()
