"""DET01 clean fixture: fixed-order reductions, a seeded generator, sorted
iteration; a string naming a scatter is not a call, and index_put
without accumulate only writes."""

import random

import torch

SCATTERS = {"index_add", "scatter_add"}


def combine(out, idx, rows):
    order = torch.argsort(idx, stable=True)
    out.index_put_((idx[order],), rows[order])
    return out


class Seeded(torch.nn.Module):
    def forward(self, x, generator):
        for axis in sorted({0, 1}):
            x = x + torch.rand(x.shape, generator=generator).sum(axis)
        return x


def host_only(n):
    return random.Random(n).random()
