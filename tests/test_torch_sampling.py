"""The port's sampling epilogue against the JAX package: its threefry
bits equal JAX's exactly, its Gumbel noise is within 1 ulp of
``jax.random.gumbel``, and ``sample_tokens`` picks the same token as
``repro.kernels.sampling.sample_tokens`` and the numpy oracle over
temperature / top-k / top-p sweeps.  Greedy rows are bitwise argmax."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import sampling as jsampling  # noqa: E402
from repro.kernels.ref import sample_tokens_reference  # noqa: E402
from repro_torch.kernels import ops, sampling  # noqa: E402

B, V = 8, 211


def jax_bits(seed: int, pos: int, n: int) -> np.ndarray:
    key = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
    return np.asarray(jax.random.bits(key, (n,), jnp.uint32))


def seed_pos_pairs():
    rng = np.random.default_rng(0)
    seeds = [0, 1, 7, 123, 2**31 - 1]
    # Request-id derived seeds live in the int32 sign-bit half.
    seeds += [(0x80000000 | (rid & 0x7FFFFFFF)) - (1 << 32)
              for rid in (0, 1, 5, 999, 2**31 - 1)]
    seeds += rng.integers(-2**31, 2**31, 6).tolist()
    positions = [0, 1, 17, 4095] + rng.integers(0, 2**20, 4).tolist()
    return [(int(s), int(p)) for s in seeds for p in positions]


PAIRS = seed_pos_pairs()


def test_threefry_bits_equal_jax():
    n = 37
    seeds = torch.tensor([s for s, _ in PAIRS], dtype=torch.int32)
    pos = torch.tensor([p for _, p in PAIRS], dtype=torch.int32)
    key = sampling.fold_in(sampling.prng_key(seeds), pos)
    got = sampling.uniform_bits(key, n).numpy().astype(np.uint32)
    for i, (s, p) in enumerate(PAIRS):
        assert np.array_equal(got[i], jax_bits(s, p, n)), (s, p)


def test_unit_float_conversion_equals_jax():
    seeds = torch.tensor([s for s, _ in PAIRS], dtype=torch.int32)
    pos = torch.tensor([p for _, p in PAIRS], dtype=torch.int32)
    key = sampling.fold_in(sampling.prng_key(seeds), pos)
    got = sampling.bits_to_unit_float(sampling.uniform_bits(key, V)).numpy()
    for i, (s, p) in enumerate(PAIRS[:12]):
        k = jax.random.fold_in(jax.random.PRNGKey(s), p)
        want = np.asarray(jax.random.uniform(k, (V,), jnp.float32))
        assert np.array_equal(got[i], want), (s, p)


def test_gumbel_noise_within_one_ulp():
    """Within one ulp of the value, or of 1.0 where |noise| < 1: the port
    rounds each log correctly, XLA's float32 log is not correctly rounded
    near 1, and -log(-log(u)) near 0 magnifies that in ulps of its own."""
    seeds = torch.tensor([s for s, _ in PAIRS], dtype=torch.int32)
    pos = torch.tensor([p for _, p in PAIRS], dtype=torch.int32)
    got = sampling.gumbel_noise(seeds, pos, V).numpy()
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    for i, (s, p) in enumerate(PAIRS):
        want = np.asarray(jsampling.gumbel_noise(s, p, V))
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
        assert np.all(np.abs(got[i] - want) <= ulp), (s, p)


def make_rows(rng, seed_base):
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    seeds = (np.arange(B) + seed_base * 100).astype(np.int32)
    seeds[::3] = -seeds[::3] - 1          # auto-derived seeds are negative
    pos = rng.integers(0, 200, B).astype(np.int32)
    return logits, seeds, pos


def port(logits, seeds, pos, t, k, p) -> np.ndarray:
    return ops.sample_tokens(*(torch.from_numpy(a) for a in
                               (logits, seeds, pos, t, k, p))).numpy()


@pytest.mark.parametrize("seed_base", [0, 1])
@pytest.mark.parametrize("temp", [0.0, 0.3, 0.7, 1.0, 1.3])
@pytest.mark.parametrize("top_k", [0, 1, 5, 50, 500])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5, 0.1])
def test_sample_tokens_equal_jax(seed_base, temp, top_k, top_p):
    rng = np.random.default_rng(seed_base)
    logits, seeds, pos = make_rows(rng, seed_base)
    t = np.full(B, temp, np.float32)
    k = np.full(B, top_k, np.int32)
    p = np.full(B, top_p, np.float32)
    got = port(logits, seeds, pos, t, k, p)
    assert got.dtype == np.int32
    want = np.asarray(jax.jit(jsampling.sample_tokens)(
        *(jnp.asarray(a) for a in (logits, seeds, pos, t, k, p))))
    oracle = sample_tokens_reference(logits, seeds, pos, t, k, p)
    assert np.array_equal(got, want), (temp, top_k, top_p)
    assert np.array_equal(got, oracle), (temp, top_k, top_p)


def test_greedy_rows_are_bitwise_argmax():
    rng = np.random.default_rng(7)
    logits, seeds, pos = make_rows(rng, 7)
    # Ties resolve to the lowest index, as in jnp.argmax.
    logits[0, 3] = logits[0, 9] = logits[0].max() + 1.0
    t = np.array([0.0, 1.0] * (B // 2), np.float32)
    for top_k, top_p in [(0, 1.0), (3, 0.5), (1, 0.1)]:
        got = port(logits, seeds, pos, t, np.full(B, top_k, np.int32),
                   np.full(B, top_p, np.float32))
        assert np.array_equal(got[::2], np.argmax(logits, axis=-1)[::2])
    assert port(logits, seeds, pos, np.zeros(B, np.float32),
                np.zeros(B, np.int32), np.ones(B, np.float32))[0] == 3


def test_same_key_same_token_and_positions_decorrelate():
    logits = np.zeros((B, V), np.float32)       # uniform: pure noise argmax
    seeds = np.full(B, 42, np.int32)
    t, k, p = (np.ones(B, np.float32), np.zeros(B, np.int32),
               np.ones(B, np.float32))
    a = port(logits, seeds, np.full(B, 17, np.int32), t, k, p)
    assert len(set(a.tolist())) == 1
    c = port(logits, seeds, np.arange(B, dtype=np.int32), t, k, p)
    assert len(set(c.tolist())) > 1
