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

Under a mesh the leaves are a rank's blocks: ``update``'s ``split`` names,
for each set of groups (the model group, the fsdp profile's data group, or
both), the leaves split over them, whose sums of squares are summed over
those groups; the leaves whole on every rank count once.  zero1
(``MomentLayout``, the JAX dry run's moments with ``layers`` over
``data``): ``init`` allocates only the moments of the rank's layers, a
layer's parameters are updated by the data rank that owns its moments
(gathered whole over the data group first where the fsdp profile splits
them) and broadcast from it to the group; the other leaves keep their
moments on every rank.

Moments are first-class allocation sites for the tiering runtime: the
trainer registers them in groups keyed like the parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Collection, Dict, Mapping, NamedTuple,
                    Optional, Sequence, Tuple, Union)

import numpy as np
import torch

from ..dist.collectives import (all_gather_dim, all_reduce, broadcast,
                                group_size)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MomentLayout:
    """zero1's moments on a data group: ``owner`` maps each parameter
    whose moments one data rank holds (its layer's) to that rank on
    ``group``; ``gather`` a parameter whose block splits over the group
    along a dim its moments do not (the fsdp profile) to that dim.  This
    rank is ``rank`` on ``group``; a parameter absent from ``owner`` has
    its moments on every rank, as its block."""

    group: Any
    rank: int
    owner: Mapping[str, int]
    gather: Mapping[str, int]

    def holds(self, name: str) -> bool:
        return self.owner.get(name, self.rank) == self.rank


class AdamWState(NamedTuple):
    step: torch.Tensor                 # () int32 on the host
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    layout: Optional[MomentLayout] = None


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[int], float], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def init(self, params: Mapping[str, torch.Tensor],
             layout: Optional[MomentLayout] = None) -> AdamWState:
        """Zero moments in f32 for ``params``; under zero1 (``layout``)
        only for the leaves this rank holds moments of, each the shape of
        its moments' block."""
        def zeros(name, p):
            shape = list(p.shape)
            if layout is not None and name in layout.gather:
                shape[layout.gather[name]] *= group_size(layout.group)
            return torch.zeros(shape, dtype=F32, device=p.device)

        held = [n for n in params if layout is None or layout.holds(n)]
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m={n: zeros(n, params[n]) for n in held},
                          v={n: zeros(n, params[n]) for n in held},
                          layout=layout)

    def _lr(self, step: int) -> np.float32:
        return np.float32(self.lr(step) if callable(self.lr) else self.lr)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor],
               ndim: Optional[Mapping[str, int]] = None,
               split: Sequence[Tuple[Sequence[Any], Collection[str]]] = ()):
        """One step.  Returns (params, state, grad_norm); params and the
        state's moments are the tensors given, updated in place.
        ``ndim``: each leaf's rank for the decay rule (default its own).
        ``split``: (groups, the names of the leaves split over them) pairs
        when the leaves are a rank's blocks: their sums of squares are
        summed over each of the groups in turn."""
        step = state.step + 1
        t = np.float32(int(step))
        if self.grad_clip is not None:
            sq = {n: torch.sum(torch.square(g.to(F32)))
                  for n, g in grads.items()}
            names = set().union(*(n for _, n in split))
            total = sum(v for n, v in sq.items() if n not in names)
            for groups, part in split:
                local = [v for n, v in sq.items() if n in part]
                if local:
                    local = sum(local)
                    for group in groups:
                        local = all_reduce(local, group)
                    total = local + total
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
        lay = state.layout
        for name, p in params.items():
            rank = p.dim() if ndim is None else ndim[name]
            owner = None if lay is None else lay.owner.get(name)
            if owner is None:
                self._apply(p, grads[name], state.m[name], state.v[name],
                            scale, lr, c1, c2, rank)
                continue
            dim = lay.gather.get(name)
            w, g = p, grads[name]
            if dim is not None:
                w = all_gather_dim(p, dim, lay.group).contiguous()
                g = all_gather_dim(g, dim, lay.group)
            if owner == lay.rank:
                self._apply(w, g, state.m[name], state.v[name], scale, lr,
                            c1, c2, rank)
            broadcast(w, owner, lay.group)
            if dim is not None:
                n = p.shape[dim]
                p.copy_(w.narrow(dim, lay.rank * n, n))
        return params, AdamWState(step, state.m, state.v, lay), gnorm

    def _apply(self, p: torch.Tensor, grad: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, scale, lr: float, c1: float, c2: float,
               rank: int) -> None:
        """One leaf's step, in place: its clipped gradient into the
        moments, the bias-corrected direction plus decay times ``lr`` off
        the parameter."""
        g = grad.to(F32) * scale
        m.mul_(self.b1).add_(g * (1 - self.b1))
        v.mul_(self.b2).add_(torch.square(g).mul_(1 - self.b2))
        delta = (m / c1).div_((v / c2).sqrt_().add_(self.eps))
        if self.weight_decay and rank > 1:
            delta.add_(p.to(F32) * self.weight_decay)
        p.copy_(p.to(F32) - delta.mul_(lr))


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
