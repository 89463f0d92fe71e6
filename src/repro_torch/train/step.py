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

Under a mesh (``dist.sharding.use_mesh``) ``params`` are the rank's blocks
(``Model.shard_``) and the batch its data block.  The data-parallel
reduction: the count of the batch's non-ignored labels is summed over the
data ranks first, each rank's loss is its NLL sum over that global count,
and after the backward its loss and every gradient, in the parameters'
order, are summed over the data ranks (``dist.collectives.sum_over_data``:
one all-reduce a data axis, ``pod`` then ``data``).  So the loss is the
global mean over the tokens, however unevenly the ignored labels fall, and
every rank holds its blocks of that mean's gradient.  The clip's global
norm sums the leaves split over the model axis over its group, and those
the fsdp profile splits over the data axis over that one (``AdamW.update``'s
``split``).

The ``fsdp`` profile (``FSDP_RULES``: ``embed`` over ``data``): a leaf's
block is 1/|data| of its ``embed`` dim, gathered before each use and its
gradient reduce-scattered (``Model.fsdp``, ``dist.collectives.gather_shards``),
so the data all-reduce skips it: the reduce-scatter has summed it over the
data ranks.  zero1 (``zero1_layout``): the moments of a layer's leaves lie
on the data rank that owns the layer (``AdamW.init``, ``MomentLayout``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from ..convert import jax_path
from ..dist.collectives import sum_over_data
from ..dist.compress import quantize_roundtrip
from ..dist.sharding import (Rules, active_mesh, active_rules, axis_group,
                             axis_rank, data_groups, entry_axes, mesh_sizes,
                             model_group)
from ..models.transformer import Model
from ..optim.adamw import AdamW, AdamWState, MomentLayout


@dataclasses.dataclass(frozen=True)
class StepConfig:
    accum: int = 1                     # gradient accumulation microbatches
    compression: Optional[str] = None  # None | "int8"


def value_and_grad(model: Model, params: Mapping[str, torch.Tensor],
                   batch: Mapping[str, torch.Tensor],
                   count: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, name -> gradient) of ``model.loss`` at ``params`` (its NLL
    over ``count`` tokens when given): each tensor becomes a leaf that
    requires grad (sharing its storage), so the model's own parameters
    need not.  A tensor the model declares unread
    (``Model.unread_leaves``) gets a zero gradient, as ``jax.grad`` gives
    it; any other tensor the loss does not reach raises."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    loss = model.loss(batch, leaves, count=count)
    unread = model.unread_leaves
    read = [n for n in leaves if n not in unread]
    grads = dict(zip(read, torch.autograd.grad(
        loss, [leaves[n] for n in read])))
    return loss.detach(), {
        n: grads[n] if n in grads else torch.zeros_like(p)
        for n, p in leaves.items()}


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


def _global_count(batch: Mapping[str, torch.Tensor], groups):
    """The data ranks' count of non-ignored labels (None: no data
    reduction)."""
    if not groups:
        return None
    return sum_over_data((batch["labels"] != -1).sum(), groups)


def _split_leaves(model: Model, mesh, seen: Dict) -> List[Tuple]:
    """(groups, names of the parameters split over each of them) on
    ``mesh``: the model group's leaves, the fsdp profile's data group's,
    and those split over both; empty without either."""
    key = (id(mesh), id(active_rules()))
    if key not in seen:
        groups = {"model": model_group(mesh),
                  "data": model._fsdp_group}
        parts: Dict[Tuple[str, ...], List[str]] = {}
        for n, s in model.shardings(mesh).items():
            over = tuple(
                a for a in ("model", "data") if groups[a] is not None and (
                    a == "data" and n in model.fsdp or a == "model" and any(
                        "model" in entry_axes(e) for e in s.spec)))
            if over:
                parts.setdefault(over, []).append(n)
        seen[key] = [(tuple(groups[a] for a in over), frozenset(names))
                     for over, names in sorted(parts.items())]
    return seen[key]


def zero1_layout(model: Model, mesh, rules: Optional[Rules] = None
                 ) -> Optional[MomentLayout]:
    """zero1's moment layout on ``mesh`` (the JAX dry run's moments:
    ``rules``, default the ambient ones, with ``layers`` over ``data``):
    each leaf of a layer stack that splits over the data axis is owned by
    the data rank holding its layer, and gathered along the dim its
    parameter block splits over ``data`` and its moments do not; None
    without a data axis of more than one rank."""
    group = axis_group(mesh, "data")
    if group is None:
        return None
    rules = active_rules() if rules is None else rules
    moments = model.shardings(mesh, dict(rules, layers="data"))
    blocks = model.shardings(mesh, rules)
    ways = mesh_sizes(mesh)["data"]
    owner, gather = {}, {}
    for name, sh in moments.items():
        if not sh.layer_split:
            continue
        if sh.layer_axes != ("data",):
            raise ValueError(f"{name}: zero1 splits the layer stack over "
                             f"'data' alone, not {sh.layer_axes}")
        owner[name] = sh.layer // (sh.n_layers // ways)
        for dim, (pe, me) in enumerate(zip(blocks[name].spec, sh.spec)):
            if "data" in entry_axes(pe) and "data" not in entry_axes(me):
                gather[name] = dim
    return MomentLayout(group, axis_rank(mesh, "data"), owner, gather)


def reduced_value_and_grad(model: Model, params: Mapping[str, torch.Tensor],
                           batch: Mapping[str, torch.Tensor],
                           accum: int = 1
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``value_and_grad`` of a step, over ``accum`` microbatches (the loss
    and the gradients averaged), then the data-parallel reduction under
    the ambient mesh (module docstring): the global mean loss and the
    rank's blocks of its gradient."""
    groups = data_groups(active_mesh())
    if accum == 1:
        loss, grads = value_and_grad(model, params, batch,
                                     _global_count(batch, groups))
    else:
        loss = torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        for mb in _split_batch(batch, accum):
            l, g = value_and_grad(model, params, mb,
                                  _global_count(mb, groups))
            loss = loss + l
            grads = {n: grads[n] + g[n] for n in grads}
        loss = loss / accum
        grads = {n: g / accum for n, g in grads.items()}
    if groups:
        # A leaf the fsdp profile splits over ``data`` was summed over it
        # by its reduce-scatter.
        rest = [g for g in groups if g != model._fsdp_group]
        loss = sum_over_data(loss.clone(), groups)
        grads = {n: sum_over_data(g.contiguous(),
                                  rest if n in model.fsdp else groups)
                 for n, g in grads.items()}
    return loss, grads


def make_train_step(model: Model, opt: AdamW,
                    cfg: StepConfig = StepConfig()) -> Callable:
    split_names: Dict = {}

    def step(params: Dict[str, torch.Tensor], opt_state: AdamWState,
             batch: Mapping[str, torch.Tensor]):
        ndim = {n: jax_ndim(n, p) for n, p in params.items()}
        loss, grads = reduced_value_and_grad(model, params, batch, cfg.accum)

        if cfg.compression == "int8":
            grads = {n: quantize_roundtrip(g) for n, g in grads.items()}

        mesh = active_mesh()
        params, opt_state, gnorm = opt.update(
            grads, opt_state, params, ndim,
            split=() if mesh is None else _split_leaves(model, mesh,
                                                        split_names))
        metrics = {"loss": loss, "grad_norm": gnorm, "step": opt_state.step}
        return params, opt_state, metrics

    return step
