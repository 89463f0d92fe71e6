"""Quickstart over the PyTorch port: build an architecture from the
registry, train a few steps on synthetic data, then generate from it
through the ``LLM`` front door.  The same walkthrough as ``quickstart.py``:
``Trainer`` 20 steps on ``SyntheticLM`` at the smoke ``llama3_2_1b``, then
``LLM.generate``.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py   # on the card

On the card the training steps run the flash-attention kernels and the
generation the paged-attention kernels.
"""

import argparse
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, get_smoke
from repro_torch.data import SyntheticLM
from repro_torch.models import Model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamW
from repro_torch.serve import LLM, SamplingParams
from repro_torch.train import Trainer, TrainerConfig

PROMPT = [5, 42, 17]


def config() -> ModelConfig:
    return dataclasses.replace(get_smoke("llama3_2_1b"), remat=False)


def train(model: Model, steps: int = 20, log_every: int = 5,
          params: Optional[Mapping[str, torch.Tensor]] = None
          ) -> Tuple[Trainer, Dict[str, Any]]:
    """``steps`` of AdamW (lr 1e-2, no weight decay) on ``SyntheticLM``
    (seq 64, batch 8, seed 0), from ``params`` or a seed-0 init."""
    opt = AdamW(lr=1e-2, weight_decay=0.0)
    trainer = Trainer(model, opt,
                      TrainerConfig(steps=steps, log_every=log_every,
                                    seed=0),
                      params=params)
    src = SyntheticLM(model.cfg.vocab, seq_len=64, global_batch=8, seed=0)

    def batches():
        for b in src.iter_host():
            yield {k: torch.from_numpy(v).to(model.device)
                   for k, v in b.items()}

    return trainer, trainer.run(batches())


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"registered architectures: {', '.join(ARCHS)}")
    model = Model(config(), device=device)

    # --- train a few steps -------------------------------------------------
    trainer, result = train(model)
    print(f"trained {result['steps']} steps, "
          f"final loss {result['final_loss']:.3f}")

    # --- generate ----------------------------------------------------------
    # The whole serving stack — paged KV cache, continuous batching, guided
    # tiering — sits invisibly behind three lines:
    llm = LLM(model)
    out = llm.generate(PROMPT, SamplingParams(max_tokens=8))[0]
    print("prompt:", out.prompt_token_ids, "->", out.token_ids,
          f"({out.finish_reason})")
    return {"losses": [m["loss"] for m in trainer.metrics_log],
            "final_loss": result["final_loss"],
            "wall_seconds": result["wall_seconds"], "steps": result["steps"],
            "token_ids": out.token_ids}


if __name__ == "__main__":
    main()
