"""Mixture-of-Experts layer of the port (``repro/models/moe.py``).

Routing (``route_tokens``) looks at one token at a time: f32 router
logits, softmax over the experts, top-k as k iterative argmaxes (ties to
the lowest index), renormalised.

Dropless dispatch, in three layouts that compute the same per-token
function (expert FFNs are row-independent, and each token's k results
combine in ascending-expert order under all three):

* **flat** (``apply_dropless_flat``, the default): the B*S*k picks sorted
  stably by expert into E contiguous ragged segments, the grouped SwiGLU
  (``kernels.ops.moe_grouped_ffn``: the CUDA kernel on the card, the plain
  version on the CPU) over them, the k results combined gate-weighted.
* **per-row** (``_moe_dropless(per_row=True)``): each batch row sorts its
  own S*k picks, so the grouped FFN runs over B*E segments with
  ``group_experts`` = ``arange(E)`` tiled B times.  It is picked, as in
  the JAX package, when the ambient mesh (``dist.sharding.use_mesh``)
  splits the batch over a data axis (``_data_sharded``), where it keeps
  every dispatch structure row-local.
* **tp over the mesh's model axis**: with ``parallelism="tp"`` under a
  model layout (``dist.sharding.TPLayout``, the model's after
  ``Model.shard_``) whose ``model`` axis splits ``mlp``, each rank holds the columns
  of ``w_gate``/``w_up`` and the rows of ``w_down`` of its block of the
  FFN width (``models.common.moe_axes("tp")``).  x enters the group
  (``copy_to_group``), every rank routes every token with the whole router
  (which enters the group too, so its gradient sums the ranks' partial
  ones), the grouped FFN runs on the local width in either layout above,
  the fixed-order combine gives the rank's partial sum in f32, and one
  ``reduce_from_group`` sums the group's.
* **ep over the mesh's model axis** (``_moe_dropless_ep``): with
  ``parallelism="ep"`` under a mesh whose ``model`` axis has more than one
  rank (``_ep_mesh``), each rank holds its data block of the batch and
  owns ``padded_experts / model`` experts.  Each rank routes a static
  slice of its block's tokens, the rows travel to their experts' ranks of
  the model group and back by ``dist.ragged_all_to_all`` (NCCL on the
  card, gloo on the CPU), and the token slices are all-gathered over the
  model group.

The combines are fixed-order reductions, not scatter-adds: ``index_add_``
and scatter-adds are not deterministic on CUDA, and the serving invariants
(one-shot prefill == chunked == decode) need each token's bits to depend
on that token alone.  The sort is inverted, a token's k results are
brought together in ascending-expert order (the order in which the JAX
package's ``.at[tok_idx].add`` adds them), and they are summed in f32 by
a loop over k starting from zero.  Group sizes come from the sorted picks
by ``searchsorted``, on the device: apart from ep's count exchange,
nothing here waits for the card.

Capacity dispatch (``dispatch="capacity"``, ``_moe_capacity``): GShard's
per-row capacity, picks over an expert's capacity dropped.  The (row,
expert, slot) buffer is built by gathers only: the in-capacity picks and
the occupied (expert, slot) pairs are a bijection, so the buffer gathers
its rows from the tokens and the combine gathers its rows from the buffer,
and each backward is the gather the other way.  The expert SwiGLU runs as
batched products over (row, expert), as the JAX package computes it
outside any Pallas kernel.

Training differentiates every path: the router through ``linear`` and the
softmax, the experts through the grouped FFN's backward kernel (or the
batched products' own gradients).  The dispatch gathers and the combines
are ``autograd.Function``s whose backwards are each other's forwards, so
no backward accumulates by index either, and two backward passes give the
same bits.  Under ep, x's and the router's gradients are those of the
rank's data block, whole on every rank of its model group; the data ranks'
gradients differ, and the trainer's data-parallel reduction
(``train.step``) sums them into the batch's.  Capacity dispatch under a
mesh runs per row on the rank's data block and, on the model axis, on the
rank's block of the expert weights (``_moe_capacity``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..dist import collectives as coll
from ..dist.collectives import (copy_to_group, ragged_all_to_all,
                                reduce_from_group)
from ..dist.sharding import (NO_TP, TPLayout, active_mesh, batch_data_axes,
                             mesh_sizes)
from ..kernels import ops
from ..tiles import linear

F32 = torch.float32


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

    def validate_ep_axis(self, axis_size: int) -> None:
        """``ep_axis_size`` fixes the parameter shapes, apart from the
        group the layer runs on: the group's size must divide the padded
        expert count, or some ranks would own more experts than others."""
        if self.parallelism != "ep":
            return
        if axis_size <= 0 or self.padded_experts % axis_size != 0:
            raise ValueError(
                f"ep mesh mismatch: padded_experts={self.padded_experts} "
                f"(n_experts={self.n_experts} padded to ep_axis_size="
                f"{self.ep_axis_size}) does not divide evenly over a "
                f"{axis_size}-way model axis; set ep_axis_size to a "
                f"multiple of the mesh's model-axis size")


def route_tokens(router: torch.Tensor, x2d: torch.Tensor, cfg: MoEConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token top-k routing: x2d (T, d) and the f32 router (d, E) give
    (gates (T, k) f32, experts (T, k) int32).  The logits go through
    ``linear``'s fixed row tiles; softmax, argmax and the renormalisation
    are per row, so a token's picks and gates do not depend on how the
    stream is cut into calls.  The gates are differentiable in x2d and
    the router (through ``linear``, the softmax and the picks' gathers)."""
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


def _sum_picks(rows: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
    """(T, d) f32: row t is the sum of ``rows[where[t, j]]`` over j, taken
    in f32 from zero in the order of j (ascending expert)."""
    y = torch.zeros((where.shape[0], rows.shape[1]), dtype=F32,
                    device=rows.device)
    for j in range(where.shape[1]):
        y = y + rows[where[:, j]].to(F32)
    return y


class _Dispatch(torch.autograd.Function):
    """xs = x[tok_idx]: each token's row once per pick, in sorted order.
    Its gradient sums a token's k pick gradients by ``_sum_picks``."""

    @staticmethod
    def forward(ctx, x, tok_idx, where):
        ctx.save_for_backward(where)
        ctx.dtype = x.dtype
        return x[tok_idx]

    @staticmethod
    def backward(ctx, dxs):
        (where,) = ctx.saved_tensors
        return _sum_picks(dxs, where).to(ctx.dtype), None, None


class _Combine(torch.autograd.Function):
    """y (T, d) f32 = the sum over a token's k picks, in ascending-expert
    order, of ``ys * gate``: the sorted picks' FFN rows ys (T*k, d) in f32
    times their gates, ``gates[order]`` of the (T*k,) f32 gates in token
    order.  The gates' gradient comes back through the inverse
    permutation."""

    @staticmethod
    def forward(ctx, ys, gates, order, inverse, where):
        gs = gates[order]
        ctx.save_for_backward(ys, gs, order, inverse)
        ctx.k = where.shape[1]
        return _sum_picks(ys.to(F32) * gs[:, None], where)

    @staticmethod
    def backward(ctx, dy):
        ys, gs, order, inverse = ctx.saved_tensors
        dcontrib = dy[order // ctx.k]          # each pick's token row
        dys = (dcontrib * gs[:, None]).to(ys.dtype)
        dgs = (dcontrib * ys.to(F32)).sum(-1)
        return dys, dgs[inverse], None, None, None


def _sorted_ffn(x2d: torch.Tensor, gates: torch.Tensor,
                order: torch.Tensor, k: int,
                ffn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The dropless dispatch around ``ffn``: x2d (T, d) and its (T*k,) f32
    gates in token order; ``order`` puts the T*k picks into the segments
    ``ffn`` takes (ascending expert within each segment run, stream order
    within a segment).  Gathers each pick's token row into that order, runs
    ``ffn`` on the rows, combines gate-weighted per token in
    ascending-expert order.  Returns (T, d) f32."""
    T = x2d.shape[0]
    # Sorted position of each pick; per token, ascending = ascending expert.
    inverse = torch.argsort(order)
    where = torch.sort(inverse.reshape(T, k), dim=-1).values
    xs = _Dispatch.apply(x2d, order // k, where)                 # (T*k, d)
    # ys is in x's dtype (as in the JAX package) before the gates scale it.
    return _Combine.apply(ffn(xs), gates, order, inverse, where)


def _segment_sizes(sorted_e: torch.Tensor, E: int) -> torch.Tensor:
    """Per-expert counts of ascending picks (..., n), by ``searchsorted``
    on the device: (..., E) int64."""
    ids = torch.arange(E + 1, device=sorted_e.device).expand(
        sorted_e.shape[:-1] + (E + 1,)).contiguous()
    bounds = torch.searchsorted(sorted_e.contiguous(), ids)
    return bounds[..., 1:] - bounds[..., :-1]


def apply_dropless_flat(gates, experts, x, w_gate, w_up, w_down,
                        cfg: MoEConfig,
                        expert_slots: Optional[torch.Tensor] = None,
                        group=None) -> torch.Tensor:
    """Flat dropless dispatch after routing.  gates/experts: (B, S, k) or
    (B*S, k); x: (B, S, d).  Sort the picks into per-expert segments, run
    the grouped SwiGLU, combine gate-weighted in ascending-expert order.

    ``expert_slots`` is an (E,) int32 map from expert id to the weight row
    holding its block; it rides the grouped FFN's ``group_experts``, so the
    weight arrays may hold more (or differently ordered) rows than ``cfg``
    has experts (the expert cache of the tiering slice).  None keeps row i
    == expert i.  ``group``: the tensor-parallel group whose partial sums
    (weights on the rank's block of the FFN width) the f32 combine is
    reduced over."""
    B, S, d = x.shape
    E, k = cfg.padded_experts, cfg.top_k
    T = B * S
    flat_e = experts.reshape(T * k).to(torch.int64)
    order, _ = _sort_picks_by_expert(flat_e, k)
    group_sizes = _segment_sizes(flat_e[order], E).to(torch.int32)
    slots = None if expert_slots is None else expert_slots.to(torch.int32)
    y = _sorted_ffn(x.reshape(T, d), gates.reshape(T * k), order, k,
                    lambda xs: ops.moe_grouped_ffn(
                        xs, w_gate, w_up, w_down, group_sizes, slots))
    return reduce_from_group(y, group).to(x.dtype).reshape(B, S, d)


def _apply_dropless_per_row(gates, experts, x, w_gate, w_up, w_down,
                            cfg: MoEConfig, group=None) -> torch.Tensor:
    """The per-row layout after routing: each row's S*k picks sorted
    stably by expert on their own, one ragged segment per (row, expert),
    the grouped FFN over the B*E segments with ``group_experts`` mapping
    segment (b, e) to expert e.  A token's k results combine in the same
    order as in the flat layout, so the two give the same bits wherever
    the grouped FFN's rows do."""
    B, S, d = x.shape
    E, k = cfg.padded_experts, cfg.top_k
    Sk = S * k
    rows_e = experts.reshape(B, Sk).to(torch.int64)
    in_row = torch.argsort(rows_e, dim=1, stable=True)           # (B, Sk)
    group_sizes = _segment_sizes(rows_e.gather(1, in_row), E)
    order = (in_row + Sk * torch.arange(B, device=x.device)[:, None])
    group_experts = torch.arange(E, dtype=torch.int32,
                                 device=x.device).repeat(B)
    sizes = group_sizes.reshape(B * E).to(torch.int32)
    y = _sorted_ffn(x.reshape(B * S, d), gates.reshape(B * Sk),
                    order.reshape(B * Sk), k,
                    lambda xs: ops.moe_grouped_ffn(
                        xs, w_gate, w_up, w_down, sizes, group_experts))
    return reduce_from_group(y, group).to(x.dtype).reshape(B, S, d)


def _data_sharded() -> bool:
    """True when the ambient mesh splits the batch over a data axis: the
    regime where the per-row layout keeps every dispatch structure
    row-local."""
    mesh = active_mesh()
    if mesh is None:
        return False
    sizes = mesh_sizes(mesh)
    return any(sizes[a] > 1 for a in batch_data_axes(mesh))


def _moe_dropless(p, x, cfg: MoEConfig, per_row: Optional[bool] = None,
                  tp: TPLayout = NO_TP) -> torch.Tensor:
    """Route, then the flat dropless dispatch, or the per-row layout with
    ``per_row`` (None: ``_data_sharded()``, as in the JAX package).  ``p``
    holds ``router`` (d, E) f32 and ``w_gate``/``w_up`` (E, d, f),
    ``w_down`` (E, f, d); with ``parallelism="tp"`` on a layout ``tp`` that
    splits ``mlp`` f is the rank's block of the width."""
    B, S, d = x.shape
    group = tp.over("mlp", cfg.d_ff) if cfg.parallelism == "tp" else None
    x = copy_to_group(x, group)
    router = copy_to_group(p.router, group)
    gates, experts = route_tokens(router, x.reshape(B * S, d), cfg)
    if per_row is None:
        per_row = _data_sharded()
    apply = _apply_dropless_per_row if per_row else apply_dropless_flat
    return apply(gates, experts, x, p.w_gate, p.w_up, p.w_down, cfg,
                 group=group)


# ======================================================== ep dropless
class _TakeSlice(torch.autograd.Function):
    """This rank's Tm rows of the (m*Tm, d) tokens that every rank of the
    model group holds whole.  Its gradient is the group's slice gradients
    all-gathered in rank order, so x's gradient is whole on every rank of
    the group (JAX's shard_map transpose sums a replicated input's
    cotangent over the model axis)."""

    @staticmethod
    def forward(ctx, xt, rank, rows, group):
        ctx.group = group
        return xt[rank * rows:(rank + 1) * rows].clone()

    @staticmethod
    def backward(ctx, dmy):
        return coll.all_gather_cat(dmy, ctx.group), None, None, None


class _SumGradOverRanks(torch.autograd.Function):
    """Identity whose gradient is summed over the model group: the router
    each rank holds whole routes only that rank's token slice."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, dt):
        return coll.all_reduce(dt.clone(), ctx.group), None


class _GatherSlices(torch.autograd.Function):
    """The model group's (Tm, d) slices all-gathered in rank order,
    (m*Tm, d).  Every rank of the group holds the whole output and
    computes the same loss from it, so a rank's slice takes its own rows
    of the output's gradient."""

    @staticmethod
    def forward(ctx, y_my, group):
        ctx.rank, ctx.rows = dist.get_rank(group), y_my.shape[0]
        return coll.all_gather_cat(y_my, group)

    @staticmethod
    def backward(ctx, dy):
        lo = ctx.rank * ctx.rows
        return dy[lo:lo + ctx.rows], None


def _ep_mesh(cfg: MoEConfig):
    """The ambient mesh when the ep path applies (ep parallelism on a
    mesh whose ``model`` axis has more than one rank), else None."""
    if cfg.parallelism != "ep":
        return None
    mesh = active_mesh()
    if mesh_sizes(mesh).get("model", 1) <= 1:
        return None
    return mesh


def _moe_dropless_ep(p, x, cfg: MoEConfig, mesh) -> torch.Tensor:
    """Ragged (dropless) expert-parallel dispatch over the mesh's ``model``
    group (the JAX package's ``_moe_dropless_ep``).  Under a mesh the port's
    model sees local tensors: x (B_loc, S, d) is this rank's data block of
    the batch (``data.ShardedLoader`` places batches by
    ``batch_pspec(mesh)``; on a mesh without a data axis larger than one
    every rank holds the whole batch), and every rank of a model group
    holds the same block.  Model rank r owns experts [r*E_loc,
    (r+1)*E_loc).  Each rank

      1. routes its static slice of Tm = ceil(B_loc*S/m) tokens through
         ``route_tokens`` (slice-padding rows get gate 0),
      2. sorts its picks by expert (contiguous per destination rank, since
         each rank owns a contiguous expert range) and counts them,
      3. all-gathers the (E,) counts, from which both directions of every
         transfer are sized (one host synchronisation: the split sizes
         of ``ragged_all_to_all`` are host integers),
      4. sends its rows to their experts' ranks, runs the grouped FFN over
         its (source rank, local expert) segments through
         ``group_experts``, and sends the results back by the same
         exchange with the sizes swapped,
      5. combines gate-weighted in ascending-expert order, as every other
         layout does, and all-gathers the token slices.

    Every collective runs on the model group.  The expert stacks are the
    rank's ``E_loc`` experts (its local blocks) or whole (then sliced
    here).  The output is this rank's (B_loc, S, d) block.  Per-token
    math is that of ``_moe_dropless``.
    Gradients, on every rank of a model group that computes the same loss
    from the whole block: x's and the router's are whole for the block
    (the slice's backward all-gathers, the router's all-reduces over the
    model group), as they are for the layers around it; a rank's own
    experts' weights get the block's gradient and the other experts' rows,
    which the rank never reads, get zeros."""
    B, S, d = x.shape
    E, k = cfg.padded_experts, cfg.top_k
    cfg.validate_ep_axis(mesh_sizes(mesh)["model"])
    if not hasattr(mesh, "get_group"):
        raise ValueError("the ep dispatch needs a DeviceMesh of live ranks; "
                         "an AbstractMesh has no process groups")
    group = mesh.get_group("model")
    m, r = dist.get_world_size(group), dist.get_rank(group)
    E_loc = E // m
    T = B * S
    Tm = -(-T // m)
    xt = x.reshape(T, d)
    if m * Tm > T:
        xt = torch.cat([xt, xt.new_zeros((m * Tm - T, d))])
    my = _TakeSlice.apply(xt, r, Tm, group)
    live = (r * Tm + torch.arange(Tm, device=x.device)) < T
    gates, experts = route_tokens(_SumGradOverRanks.apply(p.router, group),
                                  my, cfg)
    gates = gates * live[:, None].to(gates.dtype)

    flat_e = experts.reshape(Tm * k).to(torch.int64)
    order, _ = _sort_picks_by_expert(flat_e, k)
    counts = _segment_sizes(flat_e[order], E)
    all_counts = coll.all_gather_cat(counts[None], group)       # (m, E)
    mine = all_counts[:, r * E_loc:(r + 1) * E_loc]             # (m, E_loc)
    host = all_counts.tolist()
    send = [sum(host[r][j * E_loc:(j + 1) * E_loc]) for j in range(m)]
    recv = [sum(row[r * E_loc:(r + 1) * E_loc]) for row in host]
    sizes = mine.reshape(m * E_loc).to(torch.int32)
    group_experts = torch.arange(E_loc, dtype=torch.int32,
                                 device=x.device).repeat(m)
    # This rank's experts: its local block, or a view of a whole stack.
    w = [t if t.shape[0] == E_loc else t[r * E_loc:(r + 1) * E_loc]
         for t in (p.w_gate, p.w_up, p.w_down)]

    def ffn(xs):
        rows = ragged_all_to_all(xs, send, recv, group)
        ys = ops.moe_grouped_ffn(rows, *w, sizes, group_experts)
        return ragged_all_to_all(ys, recv, send, group)

    y_my = _sorted_ffn(my, gates.reshape(Tm * k), order, k, ffn)
    y = _GatherSlices.apply(y_my, group)
    return y[:T].to(x.dtype).reshape(B, S, d)


# ================================================== capacity dispatch
def _capacity(tokens: int, cfg: MoEConfig) -> int:
    """Per-row expert capacity: ceil(S*k/E_live * capacity_factor), floored
    at ``top_k``.  The divisor is the live expert count (ep padding experts
    get no picks), and above the floor ``capacity_factor`` holds exactly;
    the buffer's padding is layout only (``_padded_capacity``)."""
    if not cfg.capacity_factor > 0:
        raise ValueError(f"capacity_factor must be > 0, got "
                         f"{cfg.capacity_factor}")
    cap = math.ceil(tokens * cfg.top_k / cfg.n_experts
                    * cfg.capacity_factor)
    return max(cap, cfg.top_k)


def _padded_capacity(cap: int) -> int:
    """The buffer's slots: ``cap`` rounded up to a multiple of 8.  Padding
    slots are dead: the drop rule (``slot < cap``) reads the true
    capacity."""
    return -(-cap // 8) * 8


@dataclasses.dataclass
class _Slots:
    """A row-wise capacity assignment of B rows of Tk = S*k picks to E
    experts of C slots.  Pick side (B, Tk): ``expert``, ``slot`` (clamped
    to 0 where dropped) and ``kept`` (slot < cap).  Buffer side (B, E, C):
    ``token`` (in the row; 0 where empty), ``pick`` (in the row; 0 where
    empty) and ``full`` (the slot holds a kept pick).  The two sides are
    inverse maps between the kept picks and the full slots."""

    expert: torch.Tensor
    slot: torch.Tensor
    kept: torch.Tensor
    token: torch.Tensor
    pick: torch.Tensor
    full: torch.Tensor


def _assign_slots(experts: torch.Tensor, cap: int, C: int, E: int,
                  k: int) -> _Slots:
    """``experts`` (B, Tk): a pick's slot is the running count of earlier
    picks of its expert in its row (the JAX package's one-hot cumsum); it
    is kept when that count is below ``cap``.  The c-th slot of expert e
    holds the c-th pick of e in stream order, which a stable sort of the
    row's picks puts at the segment start of e plus c."""
    e = experts.to(torch.int64)
    onehot = (e[..., None] == torch.arange(E, device=e.device)).to(
        torch.int64)                                          # (B, Tk, E)
    slot = (onehot.cumsum(1) - onehot).gather(2, e[..., None])[..., 0]
    kept = slot < cap
    counts = onehot.sum(1)                                    # (B, E)
    start = counts.cumsum(1) - counts
    c = torch.arange(C, device=e.device)
    full = c < torch.clamp(counts, max=cap)[..., None]        # (B, E, C)
    pos = torch.where(full, start[..., None] + c, 0)
    order = torch.argsort(e, dim=1, stable=True)
    pick = torch.where(full, order.gather(1, pos.reshape(e.shape[0], -1))
                       .reshape(pos.shape), 0)
    return _Slots(expert=e, slot=torch.where(kept, slot, 0), kept=kept,
                  token=pick // k, pick=pick, full=full)


class _CapacityDispatch(torch.autograd.Function):
    """buf (B, E, C, d): slot (e, c) of row b holds the token of the pick
    assigned there, or zeros.  Its gradient gathers each kept pick's slot
    gradient and sums a token's k of them in f32 from zero, in pick
    order."""

    @staticmethod
    def forward(ctx, x, slots: _Slots, k: int):
        B = x.shape[0]
        ctx.slots, ctx.k, ctx.dtype = slots, k, x.dtype
        b = torch.arange(B, device=x.device)[:, None, None]
        buf = x[b, slots.token]
        return torch.where(slots.full[..., None], buf, 0)

    @staticmethod
    def backward(ctx, dbuf):
        s, k = ctx.slots, ctx.k
        B, Tk = s.expert.shape
        b = torch.arange(B, device=dbuf.device)[:, None]
        g = torch.where(s.kept[..., None], dbuf[b, s.expert, s.slot], 0)
        g = g.reshape(B, Tk // k, k, -1)
        dx = torch.zeros(g.shape[:2] + g.shape[3:], dtype=F32,
                         device=g.device)
        for j in range(k):
            dx = dx + g[:, :, j].to(F32)
        return dx.to(ctx.dtype), None, None


class _CapacityCombine(torch.autograd.Function):
    """y (B, S, d) f32 = the sum over a token's k picks, in pick order
    from zero, of its kept picks' buffer rows times their gates.  The
    buffer's gradient gathers each full slot's token gradient times its
    gate; the gates' is each kept pick's row against its token's."""

    @staticmethod
    def forward(ctx, out_buf, gates, slots: _Slots):
        B, S, k = gates.shape
        b = torch.arange(B, device=out_buf.device)[:, None]
        rows = torch.where(slots.kept[..., None],
                           out_buf[b, slots.expert, slots.slot],
                           0).reshape(B, S, k, -1)
        ctx.save_for_backward(rows, gates)
        ctx.slots, ctx.dtype = slots, out_buf.dtype
        y = torch.zeros((B, S, rows.shape[-1]), dtype=F32,
                        device=rows.device)
        for j in range(k):
            y = y + rows[:, :, j].to(F32) * gates[:, :, j, None]
        return y

    @staticmethod
    def backward(ctx, dy):
        rows, gates = ctx.saved_tensors
        s = ctx.slots
        B, S, k = gates.shape
        dgates = (dy[:, :, None] * rows.to(F32)).sum(-1)
        b = torch.arange(B, device=dy.device)[:, None, None]
        gate = gates.reshape(B, S * k)[b[..., 0], s.pick.reshape(B, -1)]
        dbuf = dy[b, s.token] * gate.reshape(s.pick.shape)[..., None]
        dbuf = torch.where(s.full[..., None], dbuf, 0)
        return dbuf.to(ctx.dtype), dgates, None


def _capacity_slots(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig
                    ) -> Tuple[torch.Tensor, _Slots]:
    """Route x (B, S, d) and assign each row's picks to capacity slots:
    the gates (B*S, k) f32 and the ``_Slots`` of ``_capacity(S)`` live
    slots in a buffer of ``_padded_capacity`` slots an expert."""
    B, S, d = x.shape
    cap = _capacity(S, cfg)
    gates, experts = route_tokens(router, x.reshape(B * S, d), cfg)
    return gates, _assign_slots(experts.reshape(B, S * cfg.top_k), cap,
                                _padded_capacity(cap), cfg.padded_experts,
                                cfg.top_k)


def _moe_capacity(p, x, cfg: MoEConfig, tp: TPLayout = NO_TP
                  ) -> torch.Tensor:
    """GShard-style capacity-bounded dispatch, per batch row: each row
    gives every expert ``_capacity(S)`` slots, a pick past its expert's
    capacity is dropped (its token keeps only its other picks; the
    residual carries it), the expert SwiGLU runs as batched products over
    (row, expert) on the (B, E, C, d) buffer, and each token sums its kept
    picks' rows gate-weighted in f32.

    Under a mesh the rows are the rank's data block (the dispatch is per
    row: no collective).  Where the layout ``tp`` splits the expert
    weights over the model axis (``mlp`` under tp, ``experts`` under ep)
    x and the router enter the group, the products run on the rank's
    block of the weights (under ep its experts' rows of the buffer, the
    others' zeros), the combine gives the rank's partial sum, and one
    ``reduce_from_group`` sums the group's on the (B, S, d) output, not on
    the (B, E, C, d) buffer (the combine is linear)."""
    B, S, d = x.shape
    E = cfg.padded_experts
    group = (tp.over("experts", E) if cfg.parallelism == "ep"
             else tp.over("mlp", cfg.d_ff))
    x = copy_to_group(x, group)
    gates, slots = _capacity_slots(copy_to_group(p.router, group), x, cfg)
    buf = _CapacityDispatch.apply(x, slots, cfg.top_k)
    E_loc = p.w_gate.shape[0]
    lo = tp.rank * E_loc if E_loc != E else 0
    mine = buf if E_loc == E else buf[:, lo:lo + E_loc]
    g = torch.einsum("becd,edf->becf", mine, p.w_gate)
    u = torch.einsum("becd,edf->becf", mine, p.w_up)
    h = F.silu(g.to(F32)).to(x.dtype) * u
    out_buf = torch.einsum("becf,efd->becd", h, p.w_down)
    if E_loc != E:
        out_buf = F.pad(out_buf, (0, 0, 0, 0, lo, E - lo - E_loc))
    y = _CapacityCombine.apply(out_buf, gates.reshape(B, S, cfg.top_k), slots)
    return reduce_from_group(y, group).to(x.dtype)


def dropped_picks(x: torch.Tensor, router: torch.Tensor,
                  cfg: MoEConfig) -> int:
    """The picks the capacity dispatch drops on x (B, S, d): a count read
    on the host, for tests and reports."""
    return int((~_capacity_slots(router, x, cfg)[1].kept).sum())


# ============================================================== facade
def moe(p, x: torch.Tensor, cfg: MoEConfig,
        dispatch: Optional[str] = None,
        tp: TPLayout = NO_TP) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``dispatch`` overrides ``cfg.dispatch``.
    Dropless with ``parallelism="ep"`` under a mesh whose ``model`` axis
    has more than one rank (``_ep_mesh``) takes ``_moe_dropless_ep`` over
    the model group; otherwise this rank computes the padded-expert
    function of its tensors (dead experts get no rows) in the flat layout,
    or per row under a data-sharded mesh, as the JAX package does;
    ``tp``: the model's layout (tp over the FFN width)."""
    mode = dispatch if dispatch is not None else cfg.dispatch
    if mode == "capacity":
        return _moe_capacity(p, x, cfg, tp)
    if mode != "dropless":
        raise ValueError(f"unknown MoE dispatch {mode!r}")
    mesh = _ep_mesh(cfg)
    if mesh is not None:
        return _moe_dropless_ep(p, x, cfg, mesh)
    return _moe_dropless(p, x, cfg, tp=tp)


def moe_decode(p, x: torch.Tensor, cfg: MoEConfig,
               dispatch: Optional[str] = None,
               tp: TPLayout = NO_TP) -> torch.Tensor:
    """Decode-time MoE: the same function as ``moe`` (routing and the
    grouped FFN are per token), so decode logits match prefill logits;
    ``tp`` as there."""
    return moe(p, x, cfg, dispatch=dispatch, tp=tp)
