"""Train-step factory (``repro/train/step.py``).

``make_train_step(model, opt)`` builds
``step(params, opt_state, batch) -> (params, opt_state, metrics)`` with:

* optional gradient accumulation over microbatches (the batch split along
  its first axis; the loss and the gradients averaged, the gradients
  summed in the parameters' dtype as JAX sums them),
* optional int8 quantize-dequantize on the gradients (``dist.compress``),
* remat inside the model (``cfg.remat``: each layer under
  ``torch.utils.checkpoint``).

``params`` maps the model's state-dict names to tensors; the gradient is
taken against leaves made from them (``value_and_grad``), and ``opt``
updates them in place, with each tensor's rank in the JAX tree for the
weight-decay rule (``jax_ndim``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..convert import jax_path
from ..dist.compress import quantize_roundtrip
from ..models.transformer import Model
from ..optim.adamw import AdamW, AdamWState


@dataclasses.dataclass(frozen=True)
class StepConfig:
    accum: int = 1                     # gradient accumulation microbatches
    compression: Optional[str] = None  # None | "int8"


def value_and_grad(model: Model, params: Mapping[str, torch.Tensor],
                   batch: Mapping[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, name -> gradient) of ``model.loss`` at ``params``: each
    tensor becomes a leaf that requires grad (sharing its storage), so the
    model's own parameters need not."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    loss = model.loss(batch, leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def jax_ndim(name: str, t: torch.Tensor) -> int:
    """The rank of ``t``'s leaf in the JAX tree: a per-layer tensor
    (``layers.<i>.<...>``) belongs to a leaf stacked over the layers."""
    return t.dim() + (jax_path(name)[1] is not None)


def _split_batch(batch: Mapping[str, torch.Tensor], n: int):
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"global batch {b} not divisible by accum {n}")
    return [{k: x[i * (b // n):(i + 1) * (b // n)] for k, x in batch.items()}
            for i in range(n)]


def make_train_step(model: Model, opt: AdamW,
                    cfg: StepConfig = StepConfig()) -> Callable:
    def step(params: Dict[str, torch.Tensor], opt_state: AdamWState,
             batch: Mapping[str, torch.Tensor]):
        ndim = {n: jax_ndim(n, p) for n, p in params.items()}
        if cfg.accum == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            grads = {n: torch.zeros_like(p) for n, p in params.items()}
            for mb in _split_batch(batch, cfg.accum):
                l, g = value_and_grad(model, params, mb)
                loss = loss + l
                grads = {n: grads[n] + g[n] for n in grads}
            loss = loss / cfg.accum
            grads = {n: g / cfg.accum for n, g in grads.items()}

        if cfg.compression == "int8":
            grads = {n: quantize_roundtrip(g) for n, g in grads.items()}

        params, opt_state, gnorm = opt.update(grads, opt_state, params,
                                              ndim)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": opt_state.step}
        return params, opt_state, metrics

    return step
