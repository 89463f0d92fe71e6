"""Batched token sampling over logits rows — the decode epilogue.

Port of ``repro/kernels/sampling.py``.  The JAX package leaves this epilogue
to XLA (it has no Pallas kernel), and it stays plain PyTorch here.

Determinism contract (what serving correctness rests on):

* Per-row randomness is ``fold_in(PRNGKey(seed), position)`` where
  ``position`` is the token's absolute index in the request's stream, so a
  request that is preempted and recomputed, or prefilled one-shot instead
  of chunked, re-samples every position with the same key.
* ``temperature <= 0`` rows take the plain ``argmax(logits)``.

PyTorch has no threefry, so this module carries its own: ``threefry2x32``,
``prng_key``, ``fold_in`` and the float conversion of uniform bits, in int64
arithmetic masked to 32 bits.  They give the bits of
``jax.random.gumbel(fold_in(PRNGKey(seed), pos), (V,), float32)`` under
JAX's default ``jax_threefry_partitionable=True``, so sampled streams can be
compared token for token with the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32
NEG_INF = -1e30
# Floor for the temperature divide on sampled rows.
_MIN_TEMP = 1e-6
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(torch.finfo(F32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values;
    all four broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def prng_key(seeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``PRNGKey(seed)`` for int32 seeds: the key is (seed >> 32, seed's
    low 32 bits), and the high word of an int32 is 0."""
    s = seeds.to(torch.int64) & _M32
    return torch.zeros_like(s), s


def fold_in(key, data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fold_in(key, data)``: threefry of the count pair (0, data)."""
    d = data.to(torch.int64) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def uniform_bits(key, n: int) -> torch.Tensor:
    """The 32 random bits per element that ``jax.random.uniform`` draws for
    shape ``(n,)``: threefry of the counts (0, i), the two words XORed.
    key: two (B,) tensors.  Returns (B, n) int64 in [0, 2**32)."""
    k1, k2 = key[0][:, None], key[1][:, None]
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """JAX's conversion of 32 random bits to a float32 in [0, 1): the top
    23 bits become the mantissa of a float in [1, 2), minus 1."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(F32) - 1.0


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(B, vocab) Gumbel(0,1) noise, row i drawn from
    ``fold_in(PRNGKey(seeds[i]), positions[i])`` exactly as
    ``jax.random.gumbel`` draws it (uniform on [tiny, 1), then
    ``-log(-log(u))``)."""
    key = fold_in(prng_key(seeds), positions)
    f = bits_to_unit_float(uniform_bits(key, vocab))
    u = torch.clamp_min(f * (1.0 - _TINY_F32) + _TINY_F32, _TINY_F32)
    # Each log is taken in float64 and rounded to float32: the correctly
    # rounded value, which XLA's float32 log is within 1 ulp of (PyTorch's
    # float32 log on the CPU is not, near u = 1).
    inner = torch.log(u.double()).to(F32)
    return -torch.log(-inner.double()).to(F32)


def sample_tokens(logits, seeds, positions, temperature, top_k,
                  top_p) -> torch.Tensor:
    """Sample one token per logits row.

    logits: (B, V) — decode-step logits (inactive rows masked to zeros).
    seeds/positions: (B,) int32 — per-request PRNG seed and the absolute
      stream position of the token being sampled.
    temperature: (B,) f32 — ``<= 0`` selects bitwise-greedy argmax.
    top_k: (B,) int32 — keep the k highest-probability tokens (``<= 0`` or
      ``>= V`` disables the filter).
    top_p: (B,) f32 — nucleus filter: keep the smallest prefix of the
      descending distribution whose cumulative probability reaches top_p
      (``>= 1.0`` disables; the argmax token is always kept).

    Returns (B,) int32 sampled token ids.
    """
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)

    scaled = logits.to(F32) / torch.clamp_min(
        temperature.to(F32), _MIN_TEMP)[:, None]
    # One descending sort feeds both filters.  Stable order so rank ties
    # resolve to the lowest token id.
    order = torch.argsort(-scaled, dim=-1, stable=True)
    ranked = torch.gather(scaled, -1, order)

    ranks = torch.arange(V, dtype=torch.int32, device=logits.device)[None, :]
    k = torch.where(top_k <= 0, V, top_k).to(torch.int32)[:, None]
    keep_k = ranks < k
    probs = torch.softmax(ranked, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Exclusive cumsum < top_p keeps the smallest covering prefix and always
    # keeps rank 0, so the filter can never empty a row.
    keep_p = (cum - probs) < top_p.to(F32)[:, None]

    keep = torch.zeros((B, V), dtype=torch.bool, device=logits.device)
    keep.scatter_(1, order, keep_k & keep_p)
    masked = torch.where(keep, scaled, torch.full_like(scaled, NEG_INF))

    noise = gumbel_noise(seeds, positions, V)
    sampled = torch.argmax(masked + noise, dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy)
