"""DET01 fixture: nondeterminism reaching the device."""

import random

import numpy as np
import torch


def combine(out, idx, rows):
    out.index_add_(0, idx, rows)
    out.scatter_add_(0, idx[:, None].expand_as(rows), rows)
    out.index_put_((idx,), rows, accumulate=True)
    return torch.index_put(out, (idx,), rows, True)


class Noisy(torch.nn.Module):
    def forward(self, x):
        return x * random.random() + helper(x)


def helper(x):
    total = x
    for axis in {0, 1}:
        total = total + x.sum(axis)
    return total


class Jitter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x + float(np.random.rand())

    @staticmethod
    def backward(ctx, g):
        return g
