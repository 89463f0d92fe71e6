"""Plain float32 training of the benchmark's decoders: the mean next-token
cross entropy of a batch, its gradient by autograd, and AdamW, for the
first steps of a run.  Between steps each parameter is held in the type
the configuration stores it in (bfloat16; the router float32): the step
is worked out in float32 and the new value rounded to nearest, as a
bfloat16 training state without float32 master copies holds it.

The loss is the mean over every position of -log softmax(logits)[label],
logits from ``decoder.layer`` (each layer under checkpointing, so that a
step at the timed batch fits beside nothing else).  AdamW, as the cell
file states it: the global gradient norm clipped to ``grad_clip``;
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2; the step
lr ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p), the decay on
every matrix and every leaf of the layer stack (the program keeps a layer
stack's leaves as one tensor with a leading layer axis, and decays by that
tensor's rank), not on the final norm's scale."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import decoder
from .decoder import F32, F32_PRECISION, Precision


def loss(params: Dict[str, torch.Tensor], m: Dict, tokens: torch.Tensor,
         labels: torch.Tensor, prec: Precision = F32_PRECISION,
         rows: slice = slice(None)) -> torch.Tensor:
    """Mean cross entropy of rows ``rows`` of the batch."""
    tokens, labels = tokens[rows], labels[rows]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    eps = float(m["rms_norm_eps"])
    total = 0.0
    for b in range(B):
        x = params["embed.tok"][tokens[b]]
        for i in range(m["num_hidden_layers"]):
            lw = decoder.layer_weights(params, i)
            x = checkpoint(lambda x, lw=lw: decoder.layer(lw, x, pos, m,
                                                          prec),
                           x, use_reentrant=False)
        h = decoder.rms(x, params["final_ln.scale"], eps)
        logits = decoder.mm(h, params["head.w"], prec)
        total = total + F.cross_entropy(logits, labels[b].long(),
                                        reduction="sum")
    return total / (B * S)


def decays(name: str, t: torch.Tensor) -> bool:
    return t.dim() >= 2 or name.startswith("layers.")


def run(weights: Dict[str, torch.Tensor], m: Dict,
        batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], opt: Dict,
        prec: Precision = F32_PRECISION, rows: slice = slice(None)
        ) -> Dict:
    """The steps of ``batches`` from ``weights``: each step's loss, the
    first step's clipped gradient's norm per leaf, and each leaf's change
    over all the steps."""
    params = {n: w.detach().to(F32).clone().requires_grad_(True)
              for n, w in weights.items()}
    stored = {n: w.dtype for n, w in weights.items()}
    mom = {n: torch.zeros_like(p) for n, p in params.items()}
    vel = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = float(opt["b1"]), float(opt["b2"])
    losses: List[float] = []
    first: Dict[str, float] = {}
    names = list(params)
    for t, (tokens, labels) in enumerate(batches, start=1):
        value = loss(params, m, tokens, labels, prec, rows)
        grads = torch.autograd.grad(value, [params[n] for n in names])
        losses.append(float(value.detach()))
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(float(opt["grad_clip"]) / (norm + 1e-9), max=1.0)
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            for n, g in zip(names, grads):
                g = g * scale
                if t == 1:
                    first[n] = float(g.norm())
                mom[n].mul_(b1).add_(g * (1 - b1))
                vel[n].mul_(b2).add_(g * g * (1 - b2))
                step = (mom[n] / c1) / ((vel[n] / c2).sqrt() + float(
                    opt["eps"]))
                p = params[n]
                if decays(n, p):
                    step = step + float(opt["weight_decay"]) * p
                p.sub_(float(opt["lr"]) * step)
                if stored[n] != F32:
                    p.copy_(p.to(stored[n]).to(F32))
        del grads
    change = {n: float((params[n].detach() - weights[n].to(F32)).norm())
              for n in names}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
