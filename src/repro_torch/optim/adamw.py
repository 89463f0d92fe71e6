"""AdamW with decoupled weight decay — the JAX package's math
(``repro/optim/adamw.py``), not ``torch.optim.AdamW`` (whose update puts
the decay on the parameter before the step and ``eps`` elsewhere).

Moments are f32 whatever the parameter dtype; the update runs in f32 and
is cast back.  The gradient is clipped by its global norm, summed over the
leaves in the order the caller's mapping gives them (the trainer passes
JAX's leaf order).  Bias correction divides each moment; ``eps`` is added
outside the square root; weight decay applies to leaves of rank > 1 and
is added to the step direction.  The rank is the leaf's rank in the JAX
tree when the caller gives it (``ndim``): there a layer-stacked leaf is
one rank higher than the port's per-layer tensor, so the per-layer norm
scales (rank 2 stacked) are decayed and ``final_ln`` is not.

Parameters, gradients and moments are mappings of name -> tensor.  Unlike
JAX, ``update`` works in place: it overwrites the moment tensors and the
parameter tensors it is given (one leaf's f32 temporaries at a time,
instead of a second copy of the whole state) and returns them.  The step
count and the learning rate live on the host, as f32 numpy scalars.

Under tensor parallelism the leaves are a rank's blocks: ``update``'s
``split`` names the tensor-parallel group and the leaves split over it,
whose sums of squares are summed over the group; the leaves whole on
every rank count once.

Moments are first-class allocation sites for the tiering runtime: the
trainer registers them in groups keyed like the parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Collection, Dict, Mapping, NamedTuple,
                    Optional, Tuple, Union)

import numpy as np
import torch

from ..dist.collectives import all_reduce

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor                 # () int32 on the host
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[int], float], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)

        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m={n: zeros(p) for n, p in params.items()},
                          v={n: zeros(p) for n, p in params.items()})

    def _lr(self, step: int) -> np.float32:
        return np.float32(self.lr(step) if callable(self.lr) else self.lr)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor],
               ndim: Optional[Mapping[str, int]] = None,
               split: Optional[Tuple[Any, Collection[str]]] = None):
        """One step.  Returns (params, state, grad_norm); params and the
        state's moments are the tensors given, updated in place.
        ``ndim``: each leaf's rank for the decay rule (default its own).
        ``split``: (tensor-parallel group, the names of the leaves split
        over it) when the leaves are a rank's blocks."""
        step = state.step + 1
        t = np.float32(int(step))
        if self.grad_clip is not None:
            group, names = split if split is not None else (None, ())
            sq = {n: torch.sum(torch.square(g.to(F32)))
                  for n, g in grads.items()}
            total = sum(v for n, v in sq.items() if n not in names)
            local = [v for n, v in sq.items() if n in names]
            if local:
                total = all_reduce(sum(local), group) + total
            gnorm = torch.sqrt(total)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        else:
            first = next(iter(grads.values()))
            gnorm = torch.zeros((), dtype=F32, device=first.device)
            scale = torch.ones((), dtype=F32, device=first.device)
        lr = float(self._lr(int(step)))
        b1, b2 = self.b1, self.b2
        # f32 on the host, as JAX computes 1 - b ** step in f32.
        c1 = float(np.float32(1) - np.float32(b1) ** t)
        c2 = float(np.float32(1) - np.float32(b2) ** t)
        for name, p in params.items():
            g = grads[name].to(F32) * scale
            m, v = state.m[name], state.v[name]
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            delta = (m / c1).div_((v / c2).sqrt_().add_(self.eps))
            rank = p.dim() if ndim is None else ndim[name]
            if self.weight_decay and rank > 1:
                delta.add_(p.to(F32) * self.weight_decay)
            p.copy_(p.to(F32) - delta.mul_(lr))
        return params, AdamWState(step, state.m, state.v), gnorm


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], np.float32]:
    """Linear warmup to ``peak``, then a cosine down to ``floor * peak`` at
    ``total``; f32 arithmetic as the JAX schedule's, the cosine rounded
    from double (the correctly rounded f32 cosine, where numpy's f32 cos
    is off by an ulp and XLA's is not)."""
    f = np.float32

    def lr(step) -> np.float32:
        s = f(int(step))
        warm = f(peak) * s / f(max(warmup, 1))
        progress = np.clip((s - f(warmup)) / f(max(total - warmup, 1)),
                           f(0), f(1))
        # (1 - floor) * 0.5 is one Python constant in the JAX schedule.
        cos = f(floor) + f((1 - floor) * 0.5) * (
            f(1) + f(math.cos(float(f(np.pi) * progress))))
        return warm if s < f(warmup) else f(peak) * cos

    return lr
