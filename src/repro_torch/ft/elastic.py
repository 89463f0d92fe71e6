"""Elastic rescale planning of the port (``repro/ft/elastic.py``): choose a
new mesh for the surviving devices and place the training state on it.

Policy: keep the model axis intact whenever possible and shrink the data
axis; if fewer than one model group survives, shrink the model axis to the
largest power of two that fits the device count.  The global batch is
preserved by raising gradient accumulation.  ``RescalePlan`` and
``plan_rescale`` are framework-free copies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from ..models.common import param_shardings


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    accum_factor: int           # multiply grad-accumulation by this

    @property
    def new_device_count(self) -> int:
        n = 1
        for s in self.new_shape:
            n *= s
        return n


def plan_rescale(n_alive: int, old_shape: Tuple[int, ...],
                 axis_names: Tuple[str, ...] = ("data", "model")
                 ) -> RescalePlan:
    """Shrink the data axis first; keep the model axis if any full group
    fits."""
    *lead, data, model = old_shape
    lead_n = 1
    for s in lead:
        lead_n *= s
    groups = n_alive // (model * lead_n)
    if groups >= 1:
        new_shape = tuple(lead) + (groups, model)
    else:
        m = 1
        while m * 2 <= n_alive:
            m *= 2
        new_shape = tuple(1 for _ in lead) + (1, m)
    accum = -(-data // new_shape[-2])
    return RescalePlan(old_shape=old_shape, new_shape=new_shape,
                       axis_names=axis_names, accum_factor=max(1, accum))


def reshard_state(tree: Mapping[str, torch.Tensor], defs, new_mesh,
                  rules=None) -> Dict:
    """Place a full host state dict (port tensor names -> tensors) on
    ``new_mesh`` by the same logical-axis declarations as at init
    (``models.common.param_shardings``): each tensor this rank holds
    becomes a ``DTensor`` of its block; a tensor of a layer outside this
    rank's layer range (``layers -> data``) is left out, and one inside it
    is a plain tensor of the block (``LeafSharding.place``)."""
    shardings = param_shardings(defs, new_mesh, rules, names=list(tree))
    out = {}
    for name, t in tree.items():
        placed = shardings[name].place(t)
        if placed is not None:
            out[name] = placed
    return out
