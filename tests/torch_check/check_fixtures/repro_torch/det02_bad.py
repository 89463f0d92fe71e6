"""DET02 fixture: global-generator draws, hardcoded fallbacks, reseeding
inside a loop."""

import torch


def init(w, shape):
    torch.nn.init.normal_(w, std=0.02)
    w.uniform_(-1.0, 1.0)
    torch.manual_seed(1)
    return torch.randn(shape)


def sample(probs, gen=torch.Generator().manual_seed(0)):
    return torch.multinomial(probs, 1, generator=gen)


def fallback(probs, gen=None):
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    return torch.multinomial(probs, 1, generator=gen)


def redraw(shape, seed, n):
    out = []
    for _ in range(n):
        g = torch.Generator()
        g.manual_seed(seed)
        out.append(torch.rand(shape, generator=g))
    return out


def fill(w):
    return torch.Tensor.normal_(w)
