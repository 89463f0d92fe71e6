"""SPMD01 clean fixture: collectives through the counted wrappers; group
plumbing is not a collective."""

import torch.distributed as dist

from .dist import collectives


def grad_sync(t, group):
    if dist.get_world_size(group) > 1:
        collectives.all_reduce(t, group)
    return t
