"""SCHED01 clean fixture: every draw flows from one explicitly seeded
generator, so the synthesized arrival sequence is a pure function of the
seed — the replay-determinism contract."""
import numpy as np
import torch


def synthesize_arrivals(n_steps, rate, seed=0):
    rng = np.random.default_rng(seed)
    return [int(rng.poisson(rate)) for _ in range(n_steps)]


def sample_tokens(probs, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.multinomial(probs, n, generator=gen)
