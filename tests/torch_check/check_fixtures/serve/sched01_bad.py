"""SCHED01 bad fixture: unseeded / global-state randomness in a
serve/-scoped module.

Every draw here either reads OS entropy or mutates process-global RNG
state, so a replayed trace would generate different arrivals each run."""
import random

import numpy as np
import torch


def synthesize_arrivals(n_steps, rate):
    rng = np.random.default_rng()
    burst = np.random.poisson(rate)
    jitter = random.random()
    coin = random.Random()
    return rng, burst, jitter, coin.getrandbits(8 * n_steps)


def sample_tokens(probs, n):
    torch.manual_seed(0)
    picks = torch.multinomial(probs, n)
    noise = torch.rand(n, generator=None)
    return picks, noise, torch.randn_like(probs)
