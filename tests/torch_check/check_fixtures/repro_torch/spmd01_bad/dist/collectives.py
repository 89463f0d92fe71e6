"""SPMD01 fixture: inside dist/collectives.py, a collective with no group,
a ring peer without '% n', and a perm with a duplicate source."""

import torch.distributed as dist


def all_reduce(t, group=None):
    dist.all_reduce(t)
    return t


def _hop(send, to, recv, frm, group):
    return dist.batch_isend_irecv([
        dist.P2POp(dist.irecv, recv, frm, group),
        dist.P2POp(dist.isend, send, to, group)])


def ring_step(blk, nxt, group):
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    return _hop(blk, idx + 1, nxt, (idx - 1) % n, group)


def shuffle(t, exchange):
    return exchange(t, perm=[(0, 1), (0, 2)])
