"""Mixture-of-Experts layer of the port (``repro/models/moe.py``), single
device, dropless dispatch over the flat layout.

Routing (``route_tokens``) looks at one token at a time: f32 router
logits, softmax over the experts, top-k as k iterative argmaxes (ties to
the lowest index), renormalised.  The flat dropless dispatch
(``apply_dropless_flat``) sorts the B*S*k picks stably by expert into
contiguous ragged segments, runs the grouped SwiGLU
(``kernels.ops.moe_grouped_ffn``: the CUDA kernel on the card, the plain
version on the CPU) and combines each token's k results gate-weighted.

The combine is a fixed-order reduction, not a scatter-add: ``index_add_``
and scatter-adds are not deterministic on CUDA, and the serving invariants
(one-shot prefill == chunked == decode) need each token's bits to depend
on that token alone.  The sort is inverted, a token's k results are
brought together in ascending-expert order (the order in which the JAX
package's ``.at[tok_idx].add`` adds them), and they are summed in f32 by
a loop over k starting from zero.  Group sizes come from the sorted picks
by ``searchsorted``, on the device: nothing here waits for the card.

Not ported yet, each raising ``NotImplementedError``: the per-row layout
and ep over a multi-device mesh (ROADMAP.md queue A item 11), and
``dispatch="capacity"`` (item 11 as well).  One card with
``parallelism="ep"`` computes the flat padded-expert function, as the JAX
package does without a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels import ops
from ..tiles import linear

F32 = torch.float32

CAPACITY_NOT_PORTED = ("moe_dispatch='capacity' (capacity-bounded MoE "
                       "dispatch) is not ported yet: ROADMAP.md queue A "
                       "item 11 brings it")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.0
    dispatch: str = "dropless"       # "dropless" | "capacity"
    parallelism: str = "tp"          # "tp" | "ep"
    ep_axis_size: int = 16           # ep pad target

    @property
    def padded_experts(self) -> int:
        if self.parallelism != "ep":
            return self.n_experts
        m = self.ep_axis_size
        return ((self.n_experts + m - 1) // m) * m


def route_tokens(router: torch.Tensor, x2d: torch.Tensor, cfg: MoEConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token top-k routing: x2d (T, d) and the f32 router (d, E) give
    (gates (T, k) f32, experts (T, k) int32).  The logits go through
    ``linear``'s fixed row tiles; softmax, argmax and the renormalisation
    are per row, so a token's picks and gates do not depend on how the
    stream is cut into calls."""
    E = cfg.padded_experts
    logits = linear(x2d.to(F32), router)
    if E != cfg.n_experts:              # dead ep padding experts
        dead = torch.arange(E, device=logits.device) >= cfg.n_experts
        logits = torch.where(dead[None, :], -1e30, logits)
    remaining = torch.softmax(logits, dim=-1)
    cols = torch.arange(E, device=logits.device)[None, :]
    gate_cols, expert_cols = [], []
    for _ in range(cfg.top_k):
        e = torch.argmax(remaining, dim=-1)          # first max: lowest id
        gate_cols.append(remaining.gather(-1, e[:, None])[:, 0])
        expert_cols.append(e.to(torch.int32))
        remaining = torch.where(cols == e[:, None], -torch.inf, remaining)
    total = gate_cols[0]
    for g in gate_cols[1:]:
        total = total + g
    gates = torch.stack(gate_cols, dim=-1) / torch.clamp(total, min=1e-9)[
        :, None]
    return gates, torch.stack(expert_cols, dim=-1)


def _sort_picks_by_expert(experts: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable argsort of the flat (n*k,) picks: (order, tok_idx), where
    ``order`` puts the picks into ascending-expert segments (stream order
    within a segment) and ``tok_idx`` is each sorted pick's token."""
    order = torch.argsort(experts, stable=True)
    return order, order // k


def apply_dropless_flat(gates, experts, x, w_gate, w_up, w_down,
                        cfg: MoEConfig,
                        expert_slots: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Flat dropless dispatch after routing.  gates/experts: (B, S, k) or
    (B*S, k); x: (B, S, d).  Sort the picks into per-expert segments, run
    the grouped SwiGLU, combine gate-weighted in ascending-expert order.

    ``expert_slots`` is an (E,) int32 map from expert id to the weight row
    holding its block; it rides the grouped FFN's ``group_experts``, so the
    weight arrays may hold more (or differently ordered) rows than ``cfg``
    has experts (the expert cache of the tiering slice).  None keeps row i
    == expert i."""
    B, S, d = x.shape
    E, k = cfg.padded_experts, cfg.top_k
    T = B * S
    flat_e = experts.reshape(T * k).to(torch.int64)
    order, tok_idx = _sort_picks_by_expert(flat_e, k)
    xs = x.reshape(T, d)[tok_idx]                                # (T*k, d)
    bounds = torch.searchsorted(
        flat_e[order], torch.arange(E + 1, device=x.device))
    group_sizes = (bounds[1:] - bounds[:-1]).to(torch.int32)
    slots = None if expert_slots is None else expert_slots.to(torch.int32)
    ys = ops.moe_grouped_ffn(xs, w_gate, w_up, w_down, group_sizes, slots)
    # ys is in x's dtype (as in the JAX package) before the gates scale it.
    contrib = ys.to(F32) * gates.reshape(T * k)[order][:, None]
    # Sorted position of each pick; per token, ascending = ascending expert.
    where = torch.sort(torch.argsort(order).reshape(T, k), dim=-1).values
    y = torch.zeros((T, d), dtype=F32, device=x.device)
    for j in range(k):
        y = y + contrib[where[:, j]]
    return y.to(x.dtype).reshape(B, S, d)


def _moe_dropless(p, x, cfg: MoEConfig, per_row: bool = False
                  ) -> torch.Tensor:
    """Route, then the flat dropless dispatch.  ``p`` holds ``router`` (d,
    E) f32 and ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d)."""
    if per_row:
        raise NotImplementedError(
            "the per-row dropless layout (one ragged segment per batch row "
            "and expert, for a data-sharded mesh) is not ported yet: "
            "ROADMAP.md queue A item 11 brings it")
    B, S, d = x.shape
    gates, experts = route_tokens(p.router, x.reshape(B * S, d), cfg)
    return apply_dropless_flat(gates, experts, x, p.w_gate, p.w_up,
                               p.w_down, cfg)


def _multi_device() -> bool:
    dist = torch.distributed
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def moe(p, x: torch.Tensor, cfg: MoEConfig,
        dispatch: Optional[str] = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``dispatch`` overrides ``cfg.dispatch``;
    only ``"dropless"`` is ported."""
    mode = dispatch if dispatch is not None else cfg.dispatch
    if mode == "capacity":
        raise NotImplementedError(CAPACITY_NOT_PORTED)
    if mode != "dropless":
        raise ValueError(f"unknown MoE dispatch {mode!r}")
    if cfg.parallelism == "ep" and _multi_device():
        raise NotImplementedError(
            "expert parallelism over several devices (ragged all-to-alls) "
            "is not ported yet: ROADMAP.md queue A item 11 brings it")
    return _moe_dropless(p, x, cfg)


def moe_decode(p, x: torch.Tensor, cfg: MoEConfig,
               dispatch: Optional[str] = None) -> torch.Tensor:
    """Decode-time MoE: the same function as ``moe`` (routing and the
    grouped FFN are per token), so decode logits match prefill logits."""
    return moe(p, x, cfg, dispatch=dispatch)
