"""DET02 clean fixture: one seeded generator threaded through every draw,
a per-iteration seed, the seed required."""

import torch


def init(w, shape, generator):
    torch.nn.init.normal_(w, std=0.02, generator=generator)
    w.uniform_(-1.0, 1.0, generator=generator)
    return torch.randn(shape, generator=generator)


def sample(probs, seed):
    if seed is None:
        raise ValueError("an explicit seed is required")
    gen = torch.Generator().manual_seed(seed)
    return torch.multinomial(probs, 1, generator=gen)


def per_step(shape, seed, n):
    return [torch.rand(shape, generator=torch.Generator().manual_seed(
        seed + i)) for i in range(n)]


def fill(w, generator):
    return torch.Tensor.normal_(w, generator=generator)
