"""SPMD01 clean fixture: every raw op in dist/collectives.py names its
group, ring peers are rotations, perms are permutations."""

import torch.distributed as dist


def all_reduce(t, group=None):
    dist.all_reduce(t, group=group)
    return t


def _hop(send, to, recv, frm, group):
    g = lambda r: r if group is None else dist.get_global_rank(group, r)
    return dist.batch_isend_irecv([
        dist.P2POp(dist.irecv, recv, g(frm), group),
        dist.P2POp(dist.isend, send, g(to), group)])


def ring_step(blk, nxt, group):
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    return _hop(blk, (idx + 1) % n, nxt, (idx - 1) % n, group)


def shuffle(t, exchange, n):
    a = exchange(t, perm=[(0, 1), (1, 2), (2, 0)])
    return exchange(a, perm=[(j, (j + 1) % n) for j in range(n)])
