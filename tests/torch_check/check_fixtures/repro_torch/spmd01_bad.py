"""SPMD01 fixture: raw collectives outside dist/collectives.py, which
count_collectives never sees."""

import torch.distributed as dist
from torch.distributed import all_gather_into_tensor


def grad_sync(t, group):
    dist.all_reduce(t, group=group)
    return t


def gather(out, t, group):
    all_gather_into_tensor(out, t, group=group)
    return out, dist.get_world_size(group)
