"""Collectives of the port (``repro/dist/collectives.py``): the ragged
all-to-all of the MoE layer's expert-parallel dispatch, the ring matmuls
and the overlapped tensor-parallel MLP, and the collective counter.

``ragged_all_to_all`` is the counterpart of ``ring_ragged_all_to_all``
(``repro/dist/collectives.py:127``).  The JAX version rotates one static
chunk buffer around the ring with ``ppermute`` inside ``shard_map``; the
port hands the ragged exchange to ``torch.distributed.all_to_all_single``
with split sizes, which is NCCL on the card and gloo on the CPU.  The
contract is the same: each rank's rows go in grouped by destination rank
in ascending order, and the rows it receives come out packed, grouped by
source rank in ascending order.  The port returns exactly the received
rows (no static capacity, no zero tail).  The split sizes are host
integers: the MoE layer gets them from an all-gather of per-expert counts,
one host synchronisation per layer.  It is differentiable: the gradient of
the received rows goes back by the same exchange with the sizes swapped.
``ragged_all_to_all_reference`` is the all-gather oracle
(``repro/dist/collectives.py:173``).

The ring matmuls (``repro/dist/collectives.py:34-93``) decompose an
all-gather or a reduce-scatter into ``n - 1`` point-to-point hops
(``dist.batch_isend_irecv``, the counterpart of ``ppermute``), each hop's
receive posted before the block product it can overlap.
``make_overlapped_mlp`` is the tensor-parallel ``relu(x @ w1) @ w2`` over
a mesh's ``model`` group, on the rings or on the fused references.  The
products are ``torch.matmul``: the reference computes them outside any
Pallas kernel.

The tensor-parallel regions of the model (``repro/models/layers.py``'s
``constrain`` annotations, which GSPMD turns into collectives) are two
autograd functions here, as in Megatron-LM: ``copy_to_group`` (identity
forward, all-reduce of the gradient backward) where a region starts, so
x's gradient sums the group's partial gradients, and
``reduce_from_group`` (all-reduce forward, identity backward) where it
ends, summing the group's partial outputs.  ``all_reduce_max`` is the
vocab-parallel loss's maximum (no gradient), ``gather_from_group`` the
prefill's whole logits from the vocab blocks, and ``sum_over_data``
the trainer's data-parallel reduction: one all-reduce a data axis, in mesh
order.  Decode under a split cache gathers heads (``all_gather_dim``)
and the ranks' partial attentions (``gather_partials``), which
``merge_partials`` merges in rank order on plain tensors.  Megatron's
``split_to_group`` enters a whole tensor into a column-parallel stretch
(its gradient gathered); the fsdp profile's ``gather_shards`` all-gathers
a parameter's shards before use and reduce-scatters its gradient; zero1
broadcasts a layer's new parameters from its owner (``broadcast``).  On a
group of one rank each is the identity and issues nothing.
On an ``AbstractGroup`` (an ``AbstractMesh``'s, ``dist.sharding``) each
records its kind, bytes and group size and moves no data: the dry run's
per-device walk needs no process group of 256 ranks.

Every collective the port issues goes through one helper here that adds
its kind, bytes and group size to every record that ``count_collectives``
has open: the port's counterpart of the reference's HLO
``collective_bytes``.  The port has no HLO: it counts each collective
when it is issued, so a collective in a loop counts once a trip.  Bytes
are the result's per-device bytes, as the reference counts them; a ring
hop (``send_recv``) counts the bytes it sends.
"""

from __future__ import annotations

import contextlib
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

from .sharding import AbstractGroup

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "send_recv", "broadcast")
# The open records of count_collectives, outermost first.  Not
# thread-local: the card's autograd runs backward collectives on its own
# thread.
_RECORDS: List[Dict[str, Dict[str, float]]] = []


@contextlib.contextmanager
def count_collectives() -> Iterator[Dict[str, Dict[str, float]]]:
    """A record, per kind of ``KINDS``, of the ``bytes``, the ``count`` and
    the largest group (``max_group``) of every collective issued inside
    the block."""
    rec = {k: {"bytes": 0.0, "count": 0.0, "max_group": 0} for k in KINDS}
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


def group_size(group) -> int:
    if isinstance(group, AbstractGroup):
        return group.size
    return dist.get_world_size(group)


def _issued(kind: str, nbytes: int, group) -> None:
    size = group_size(group)
    for rec in _RECORDS:
        r = rec[kind]
        r["bytes"] += float(nbytes)
        r["count"] += 1.0
        r["max_group"] = max(r["max_group"], size)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (same shapes) concatenated along dim 0 in rank
    order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    out = torch.cat(parts)
    _issued("all_gather", _nbytes(out), group)
    return out


def all_gather_into(out: torch.Tensor, t: torch.Tensor, group=None
                    ) -> torch.Tensor:
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    _issued("all_gather", _nbytes(out), group)
    return out


def all_reduce(t: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """Sum ``t`` over the group (or reduce it by ``op``), in place; on an
    ``AbstractGroup`` only recorded."""
    if isinstance(group, AbstractGroup):
        pass
    elif op is None:
        dist.all_reduce(t, group=group)
    else:
        dist.all_reduce(t, op=op, group=group)
    _issued("all_reduce", _nbytes(t), group)
    return t


def _single(group) -> bool:
    return group is None or group_size(group) == 1


class _CopyToGroup(torch.autograd.Function):
    """Identity; the gradient is summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return all_reduce(dx.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Where a tensor-parallel region starts: x (whole on every rank of
    ``group``) unchanged; its gradient, partial on each rank inside the
    region, summed over the group.  A replicated parameter read inside a
    region goes through it too.  The identity for ``group`` None or of
    one rank."""
    if _single(group):
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Where a tensor-parallel region ends: the sum of the group's partial
    ``x``, whole on every rank; the gradient passes unchanged.  The
    identity for ``group`` None or of one rank."""
    if _single(group):
        return x
    return _ReduceFromGroup.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over the group, detached (the
    vocab-parallel loss's shift, whose gradient is zero)."""
    x = x.detach().clone()
    if _single(group):
        return x
    return all_reduce(x, group, op=dist.ReduceOp.MAX)


def gather_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along the last dim in rank
    order (no gradient: the prefill's whole logits from the vocab
    blocks)."""
    if _single(group):
        return x
    front = x.detach().movedim(-1, 0).contiguous()
    if isinstance(group, AbstractGroup):
        out = front.new_empty((group.size * front.shape[0],)
                              + tuple(front.shape[1:]))
        _issued("all_gather", _nbytes(out), group)
    else:
        out = all_gather_cat(front, group)
    return out.movedim(0, -1)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank
    order, no gradient (decode's q, k and v heads).  The identity for a
    group of one rank; on an ``AbstractGroup`` only recorded."""
    if _single(group):
        return x
    front = x.detach().movedim(dim, 0).contiguous()
    if isinstance(group, AbstractGroup):
        out = front.new_empty((group.size * front.shape[0],)
                              + tuple(front.shape[1:]))
        _issued("all_gather", _nbytes(out), group)
    else:
        out = all_gather_cat(front, group)
    return out.movedim(0, dim)


def gather_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                    group) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every rank's partial attention of one decode step, stacked in rank
    order by one all-gather: o (..., dh), its row maxima m (...) and sums
    of exponentials l (...) in, (n, ..., dh), (n, ...), (n, ...) out
    (``merge_partials`` merges them)."""
    packed = torch.cat([o, m[..., None], l[..., None]], dim=-1)
    n = group_size(group)
    if isinstance(group, AbstractGroup):
        out = packed.new_empty((n,) + tuple(packed.shape))
        _issued("all_gather", _nbytes(out), group)
    else:
        out = all_gather_cat(packed[None], group)
    return out[..., :-2], out[..., -2], out[..., -1]


def merge_partials(o: torch.Tensor, m: torch.Tensor,
                   l: torch.Tensor) -> torch.Tensor:
    """The softmax-weighted output over all of the parts' keys from each
    part's own: o (n, ..., dh), each part's output normalised by its own
    sum of exponentials l (n, ...) taken after its row maximum m (n, ...).
    The parts are merged in order, one at a time, from zero (no atomics,
    no all-reduce of floats), so a merge of the same parts gives the same
    bits.  A part whose keys are all masked carries weight exp(m - max)
    of 0."""
    top = m[0]
    for r in range(1, m.shape[0]):
        top = torch.maximum(top, m[r])
    num = torch.zeros_like(o[0])
    den = torch.zeros_like(l[0])
    for r in range(o.shape[0]):
        w = l[r] * torch.exp(m[r] - top)
        num = num + o[r] * w[..., None]
        den = den + w
    return num / den[..., None]


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of group rank ``src`` on every rank of ``group``, in place;
    on an ``AbstractGroup`` only recorded (zero1's new parameters from a
    layer's owner)."""
    if _single(group):
        return t
    if not isinstance(group, AbstractGroup):
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    _issued("broadcast", _nbytes(t), group)
    return t


class _SplitToGroup(torch.autograd.Function):
    """This rank's block of the last dim of a tensor whole on every rank;
    the gradient is the group's block gradients gathered in rank order."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.group = group
        n = x.shape[-1] // group_size(group)
        return x[..., rank * n:(rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, dy):
        return all_gather_dim(dy.contiguous(), dy.dim() - 1, ctx.group), \
            None, None


def split_to_group(x: torch.Tensor, group, rank: int) -> torch.Tensor:
    """Where a whole tensor enters a column-parallel stretch: this rank's
    block of its last dim; its gradient, each rank's block, gathered whole
    (Megatron-LM's scatter to the model-parallel region).  The identity
    for ``group`` None or of one rank."""
    if _single(group):
        return x
    return _SplitToGroup.apply(x, group, rank)


def _reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // group_size(group),)
                          + tuple(front.shape[1:]))
    if isinstance(group, AbstractGroup):
        _issued("reduce_scatter", _nbytes(out), group)
    else:
        reduce_scatter(out, front, group)
    return out.movedim(0, dim)


class _GatherShards(torch.autograd.Function):
    """A parameter's shards gathered along ``dim``; the gradient summed
    over the group and scattered back, each rank its shard's."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter_dim(dy, ctx.dim, ctx.group), None, None


def gather_shards(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The fsdp profile's parameter all-gather: the group's shards of a
    leaf concatenated along ``dim`` in rank order, before use; in the
    backward the gradient is reduce-scattered, so each rank's shard gets
    the sum over the group of its rows.  The identity for ``group`` None
    or of one rank."""
    if _single(group):
        return x
    return _GatherShards.apply(x, dim, group)


def sum_over_data(t: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``t`` summed over every data rank in place: one all-reduce a data
    group, in the order given (``dist.sharding.data_groups``: mesh
    order), so every run sums in the same order."""
    for g in groups:
        if not _single(g):
            all_reduce(t, g)
    return t


def reduce_scatter(out: torch.Tensor, t: torch.Tensor, group=None
                   ) -> torch.Tensor:
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    _issued("reduce_scatter", _nbytes(out), group)
    return out


def _hop(send: torch.Tensor, to: int, recv: torch.Tensor, frm: int,
         group) -> List:
    """One ring hop: send ``send`` to group rank ``to`` and receive into
    ``recv`` from group rank ``frm``, both posted at once.  Returns the
    requests to wait on."""
    g = lambda r: r if group is None else dist.get_global_rank(group, r)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.irecv, recv, g(frm), group),
        dist.P2POp(dist.isend, send.contiguous(), g(to), group)])
    _issued("send_recv", _nbytes(send), group)
    return reqs


def _sizes(sizes: Sequence[int], n: int, what: str) -> List[int]:
    out = [int(s) for s in sizes]
    if len(out) != n or min(out, default=0) < 0:
        raise ValueError(f"ragged all-to-all: {what} {out} must hold {n} "
                         f"non-negative sizes, one per rank")
    return out


def _exchange(rows: torch.Tensor, send: List[int], recv: List[int],
              group) -> torch.Tensor:
    out = rows.new_empty((sum(recv),) + tuple(rows.shape[1:]))
    dist.all_to_all_single(out, rows[:sum(send)].contiguous(),
                           output_split_sizes=recv, input_split_sizes=send,
                           group=group)
    _issued("all_to_all", _nbytes(out), group)
    return out


class _RaggedAllToAll(torch.autograd.Function):
    """The exchange, and for its gradient the exchange back."""

    @staticmethod
    def forward(ctx, rows, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        ctx.n_rows = rows.shape[0]
        return _exchange(rows, send, recv, group)

    @staticmethod
    def backward(ctx, dout):
        back = _exchange(dout.contiguous(), ctx.recv, ctx.send, ctx.group)
        if back.shape[0] < ctx.n_rows:      # rows past sum(send): no grad
            back = torch.cat([back, back.new_zeros(
                (ctx.n_rows - back.shape[0],) + tuple(back.shape[1:]))])
        return back, None, None, None


def ragged_all_to_all(rows: torch.Tensor, send_sizes: Sequence[int],
                      recv_sizes: Sequence[int],
                      group: Optional[dist.ProcessGroup] = None
                      ) -> torch.Tensor:
    """Dropless (ragged) all-to-all over ``group`` (default: the world).

    ``rows``: (R, ...) rows grouped by destination rank in ascending order;
    ``send_sizes[j]``: the rows this rank sends to rank j (their sum at
    most R; rows past it are not sent); ``recv_sizes[j]``: the rows rank j
    sends here.  Both are host integers, one per rank.  Returns
    (sum(recv_sizes), ...) rows grouped by source rank in ascending order.
    """
    n = dist.get_world_size(group)
    send = _sizes(send_sizes, n, "send_sizes")
    recv = _sizes(recv_sizes, n, "recv_sizes")
    if sum(send) > rows.shape[0]:
        raise ValueError(f"ragged all-to-all: send_sizes {send} add up to "
                         f"more than the {rows.shape[0]} rows given")
    return _RaggedAllToAll.apply(rows, send, recv, group)


def ragged_all_to_all_reference(rows: torch.Tensor,
                                send_sizes: Sequence[int],
                                recv_sizes: Sequence[int],
                                group: Optional[dist.ProcessGroup] = None
                                ) -> torch.Tensor:
    """All-gather oracle of ``ragged_all_to_all``, same contract: every
    rank's rows (padded to the longest) and size table are gathered, and
    this rank's block of each source is cut out of them."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    send = _sizes(send_sizes, n, "send_sizes")
    recv = _sizes(recv_sizes, n, "recv_sizes")
    dev = rows.device
    table = torch.tensor(send + [rows.shape[0]], dtype=torch.int64,
                         device=dev)
    tables = all_gather_cat(table[None], group).tolist()
    longest = max(t[n] for t in tables)
    padded = torch.cat([rows, rows.new_zeros(
        (longest - rows.shape[0],) + tuple(rows.shape[1:]))])
    gathered = all_gather_cat(padded[None], group)
    blocks = []
    for j, (t, src) in enumerate(zip(tables, gathered)):
        start = sum(t[:me])
        if t[me] != recv[j]:
            raise ValueError(f"ragged all-to-all: rank {j} sends {t[me]} "
                             f"rows here, recv_sizes says {recv[j]}")
        blocks.append(src[start:start + t[me]])
    return torch.cat(blocks)


# ------------------------------------------------------- allgather-matmul
def allgather_matmul_reference(x_shard: torch.Tensor, w_col: torch.Tensor,
                               group=None) -> torch.Tensor:
    """allgather(x) @ w_col, the unfused baseline.  ``x_shard``: (m, K)
    row shard of x; ``w_col``: (K, n_col) column shard.  Returns the
    full-row (n*m, n_col) product for this rank's columns."""
    n = dist.get_world_size(group)
    x = x_shard.new_empty((n * x_shard.shape[0],) + tuple(x_shard.shape[1:]))
    return torch.matmul(all_gather_into(x, x_shard, group), w_col)


def ring_allgather_matmul(x_shard: torch.Tensor, w_col: torch.Tensor,
                          group=None) -> torch.Tensor:
    """Ring-overlapped allgather + matmul: each of n steps multiplies the
    chunk held into the rows of its origin and passes it one hop, received
    from the right (the reference's ``perm``), the receive posted before
    the product."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    m = x_shard.shape[0]
    dtype = torch.result_type(x_shard, w_col)
    out = x_shard.new_empty((n * m, w_col.shape[1]), dtype=dtype)
    blk = x_shard.contiguous()
    for i in range(n):
        src = (idx + i) % n               # origin of the chunk held
        if i != n - 1:
            nxt = torch.empty_like(blk)
            reqs = _hop(blk, (idx - 1) % n, nxt, (idx + 1) % n, group)
        out[src * m:(src + 1) * m] = torch.matmul(blk, w_col).to(dtype)
        if i != n - 1:
            for r in reqs:
                r.wait()
            blk = nxt
    return out


# --------------------------------------------------- matmul-reducescatter
def matmul_reducescatter_reference(h: torch.Tensor, w_row: torch.Tensor,
                                   group=None) -> torch.Tensor:
    """scatter(sum over ranks(h @ w_row)), the unfused baseline.  ``h``:
    (M, k) column shard of activations; ``w_row``: (k, N) row shard.
    Returns this rank's (M/n, N) row block of the summed product."""
    partial = torch.matmul(h, w_row)
    n = dist.get_world_size(group)
    out = partial.new_empty((partial.shape[0] // n,) + tuple(
        partial.shape[1:]))
    return reduce_scatter(out, partial, group)


def ring_matmul_reducescatter(h: torch.Tensor, w_row: torch.Tensor,
                              group=None) -> torch.Tensor:
    """Ring-overlapped matmul + reduce-scatter: the partial sum bound for
    each rank gathers the others' block products as it travels the ring,
    sent to the right (``repro/dist/collectives.py:75-93``); each hop's
    receive is posted before the block product it overlaps."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    m = h.shape[0] // n

    def contrib(dest):
        return torch.matmul(h[dest * m:(dest + 1) * m], w_row)

    acc = contrib((idx - 1) % n)
    for i in range(1, n):
        nxt = torch.empty_like(acc)
        reqs = _hop(acc, (idx + 1) % n, nxt, (idx - 1) % n, group)
        c = contrib((idx - i - 1) % n)
        for r in reqs:
            r.wait()
        acc = nxt + c
    return acc


# ------------------------------------------------------------ fused MLP
def make_overlapped_mlp(mesh, overlap: bool = True) -> Callable:
    """The tensor-parallel MLP ``relu(x @ w1) @ w2`` over the mesh's
    ``model`` group, on this rank's shards: x (M/n, K) row-sharded, w1
    (K, F/n) column-sharded, w2 (F/n, N) row-sharded; the output (M/n, N)
    row-sharded (the reference's specs).  ``overlap=True`` runs the rings
    (``send_recv`` hops), ``overlap=False`` the fused references
    (``all_gather`` and ``reduce_scatter``)."""
    group = mesh.get_group("model")

    def mlp(x, w1, w2):
        if overlap:
            h = torch.relu(ring_allgather_matmul(x, w1, group))
            return ring_matmul_reducescatter(h, w2, group)
        h = torch.relu(allgather_matmul_reference(x, w1, group))
        return matmul_reducescatter_reference(h, w2, group)

    return mlp
