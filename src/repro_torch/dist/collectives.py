"""Collectives of the port (``repro/dist/collectives.py``): the ragged
all-to-all that carries the MoE layer's expert-parallel dispatch.

``ragged_all_to_all`` is the counterpart of ``ring_ragged_all_to_all``
(``repro/dist/collectives.py:127``).  The JAX version rotates one static
chunk buffer around the ring with ``ppermute`` inside ``shard_map``; the
port hands the ragged exchange to ``torch.distributed.all_to_all_single``
with split sizes, which is NCCL on the card and gloo on the CPU.  The
contract is the same: each rank's rows go in grouped by destination rank
in ascending order, and the rows it receives come out packed, grouped by
source rank in ascending order.  The port returns exactly the received
rows (no static capacity, no zero tail).

The split sizes must be Python integers on the host.  The MoE layer gets
them from an all-gather of per-expert counts, so the exchange costs one
host synchronisation per layer (the JAX version keeps the sizes on the
device and pays for it with a static chunk of the worst-case size).
Keeping the counts on the device is perf work for later.

``ragged_all_to_all`` is differentiable: the gradient of the received
rows goes back by the same exchange with the sizes swapped, so no
gradient is summed by index.  ``ragged_all_to_all_reference`` is the
all-gather oracle of ``ragged_all_to_all_reference``
(``repro/dist/collectives.py:173``): every rank's rows and size table
gathered, then this rank's blocks selected, a different data path for
the tests to hold the exchange against.

The ring matmuls and ``make_overlapped_mlp`` are not ported yet (ROADMAP.md
queue A item 11).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


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
    tables = [torch.empty_like(table) for _ in range(n)]
    dist.all_gather(tables, table, group=group)
    tables = [t.tolist() for t in tables]
    longest = max(t[n] for t in tables)
    padded = torch.cat([rows, rows.new_zeros(
        (longest - rows.shape[0],) + tuple(rows.shape[1:]))])
    gathered = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(gathered, padded, group=group)
    blocks = []
    for j, (t, src) in enumerate(zip(tables, gathered)):
        start = sum(t[:me])
        if t[me] != recv[j]:
            raise ValueError(f"ragged all-to-all: rank {j} sends {t[me]} "
                             f"rows here, recv_sizes says {recv[j]}")
        blocks.append(src[start:start + t[me]])
    return torch.cat(blocks)
