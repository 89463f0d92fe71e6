"""Contiguous-cache ``init_cache`` / ``prefill`` / ``decode`` for the dense
and MoE families, on the CPU at smoke widths in f32: the port of
``tests/test_recurrent_prefill.py`` and ``tests/test_ring_kv.py`` for
``llama3_2_1b``, ``granite_moe_3b_a800m`` and the sliding-window
``mixtral_8x7b`` (window 64 at smoke widths), with the JAX package's
weights carried across.

Within the port: a windowed arch's cache is a ring of ``window`` slots;
ring decode past the window equals the full windowed forward (prefill) at
the same position; prefill past the window, then decode, continues as
stepwise decode does; prefill-then-decode gives the greedy tokens of
stepwise decode.  Across frameworks: the cache shapes, the prefill's
logits and K/V, and stepwise decode's logits equal the JAX ``Model``'s.
Logits are held to 2e-3 of the largest (the JAX package's own tolerance
for prefill against stepwise decode), greedy tokens exactly; the ring
decode layer alone to 1e-5 (one layer, f32 products in other orders)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ARCHS = ["llama3_2_1b", "granite_moe_3b_a800m", "mixtral_8x7b"]
RING = "mixtral_8x7b"
TOL = 2e-3


@functools.lru_cache(maxsize=None)
def pair(arch):
    cfg = dataclasses.replace(jget_smoke(arch), remat=False,
                              dtype=jnp.float32)
    jm = build_model(cfg)
    params = jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jm.init(jax.random.PRNGKey(0)))
    tm = Model(config_from_reference(cfg), device="cpu")
    tm.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params),
                                         device="cpu"))
    return jm, params, tm


@functools.lru_cache(maxsize=None)
def jdecode(arch):
    jm, params, _ = pair(arch)
    return jax.jit(jm.decode)


def close(got, want) -> None:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=TOL)


def prompt(arch, S, seed=0):
    vocab = pair(arch)[2].cfg.vocab
    return np.random.default_rng(seed).integers(1, vocab, S).astype(np.int32)


def stepwise(tm, toks, cache_len, n_new=0):
    """Decode the prompt one token at a time, then ``n_new`` greedy steps:
    (logits after each prompt token, greedy tokens, the cache)."""
    cache = tm.init_cache(1, cache_len)
    logits = []
    for t, tok in enumerate(toks):
        lg, cache = tm.decode(torch.tensor([int(tok)]), cache, t)
        logits.append(lg[0].numpy().copy())
    new, pos = [], len(toks)
    for _ in range(n_new):
        nxt = int(lg[0].argmax())
        new.append(nxt)
        lg, cache = tm.decode(torch.tensor([nxt]), cache, pos)
        pos += 1
    return logits, new, cache


def prefilled(tm, toks, cache_len, n_new=0):
    """Prefill, then ``n_new`` greedy steps: (prefill logits, greedy
    tokens, the logits of each step)."""
    cache = tm.init_cache(1, cache_len)
    lg, cache = tm.prefill(torch.from_numpy(toks[None]), cache)
    first = lg[0].numpy().copy()
    new, steps, pos = [], [], len(toks)
    for _ in range(n_new):
        nxt = int(lg[0].argmax())
        new.append(nxt)
        lg, cache = tm.decode(torch.tensor([nxt]), cache, pos)
        steps.append(lg[0].numpy().copy())
        pos += 1
    return first, new, steps


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_follow_the_jax_rule(arch):
    jm, _, tm = pair(arch)
    for B, S in ((2, 512), (1, 16)):
        got = tm.init_cache(B, S)
        want = jm.init_cache(B, S)
        assert set(got) == set(want) == {"kv"}
        for leaf in ("k", "v"):
            assert tuple(got["kv"][leaf].shape) == want["kv"][leaf].shape
            assert got["kv"][leaf].dtype == torch.float32
    if arch == RING:
        assert tm.init_cache(2, 512)["kv"]["k"].shape[2] == \
            tm.cfg.window == 64


def test_ring_decode_matches_the_full_windowed_forward():
    """Step-by-step ring decode against prefill (the flash forward with the
    window) at positions beyond the window."""
    _, _, tm = pair(RING)
    W = tm.cfg.window
    S = W + 24                      # well past one ring wrap
    toks = prompt(RING, S)
    ring, _, cache = stepwise(tm, toks, S)
    assert cache["kv"]["k"].shape[2] == W
    for t in (W - 2, W, W + 5, S - 1):
        full, _, _ = prefilled(tm, toks[:t + 1], t + 1)
        close(ring[t], full)
        assert ring[t].argmax() == full.argmax(), t


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_stepwise(arch):
    _, _, tm = pair(arch)
    S, n_new, cache_len = 8, 4, 16
    toks = prompt(arch, S)
    first, a, steps = prefilled(tm, toks, cache_len, n_new)
    logits, b, _ = stepwise(tm, toks, cache_len, n_new)
    assert a == b, (arch, a, b)
    close(first, logits[-1])
    assert first.argmax() == logits[-1].argmax()


def test_prefill_past_the_window_then_decode_continues():
    """Prefill a prompt longer than the window (the cache ring-ified: slot
    p % W), then keep decoding on the ring: stepwise ring decode gives the
    same tokens and logits."""
    _, _, tm = pair(RING)
    W = tm.cfg.window
    S = W + 10
    toks = prompt(RING, S, seed=1)
    first, a, steps = prefilled(tm, toks, S, 4)
    logits, b, _ = stepwise(tm, toks, S, 4)
    assert a == b
    close(first, logits[-1])
    tail, _, _ = stepwise(tm, np.concatenate([toks, a[:3]]), S)
    for got, want in zip(steps, tail[S:]):
        close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_kv_match_jax(arch):
    """The prefill's last logits and every layer's K/V against the JAX
    ``Model.prefill`` (its cache is the prompt's length, or the window's
    for a ring); for mixtral past the window too."""
    jm, params, tm = pair(arch)
    lengths = (12, 70) if arch == RING else (12,)
    for S in lengths:
        toks = prompt(arch, S, seed=S)
        want, jcache = jax.jit(jm.prefill)(
            params, {"tokens": jnp.asarray(toks[None])},
            jm.init_cache(1, S))
        cache = tm.init_cache(1, S)
        before = dict(fa.LAUNCHES)
        got, cache = tm.prefill(torch.from_numpy(toks[None]), cache)
        assert fa.LAUNCHES == before   # the CPU takes the plain version
        close(got.numpy(), want)
        n = jcache["kv"]["k"].shape[2]
        assert n == min(S, tm.cfg.window or S)
        for leaf in ("k", "v"):
            close(cache["kv"][leaf][:, :, :n].numpy(), jcache["kv"][leaf])


@pytest.mark.parametrize("arch", ARCHS)
def test_stepwise_decode_logits_match_jax(arch):
    """Stepwise decode from an empty cache, past mixtral's window (the
    ring), against the JAX ``Model.decode`` step by step; then JAX's ring
    continuing from its own prefill past the window against the port's."""
    jm, params, tm = pair(arch)
    W = tm.cfg.window
    S = W + 6 if W else 10
    toks = prompt(arch, S, seed=3)
    ours, _, _ = stepwise(tm, toks, S)
    cache = jm.init_cache(1, S)
    decode = jdecode(arch)
    for t in range(S):
        lg, cache = decode(params, cache, jnp.asarray([[int(toks[t])]]),
                           jnp.int32(t))
        close(ours[t], lg[0])
    if arch == RING:
        _, jc = jax.jit(jm.prefill)(
            params, {"tokens": jnp.asarray(toks[None])}, jm.init_cache(1, S))
        nxt = int(np.argmax(ours[-1]))
        want, _ = decode(params, jc, jnp.asarray([[nxt]]), jnp.int32(S))
        _, _, steps = prefilled(tm, toks, S, 1)
        close(steps[0], want[0])


@pytest.mark.parametrize("pos", [3, 15, 21])
def test_ring_decode_layer_matches_jax(pos):
    """``attention_decode_ring`` on one layer against the JAX one: the
    output and the ring after the write at slot pos % W (W = 16), before
    the ring fills, at its last slot and after a wrap."""
    rng = np.random.default_rng(pos)
    B, d, H, K, dh, W = 2, 32, 4, 2, 8, 16
    w = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, H, dh)), ("wk", (d, K, dh)),
                      ("wv", (d, K, dh)), ("wo", (H, dh, d)))}
    x = rng.normal(size=(B, 1, d)).astype(np.float32)
    ck, cv = (rng.normal(size=(B, W, K, dh)).astype(np.float32)
              for _ in range(2))
    cfg = jl.AttnConfig(d_model=d, n_heads=H, kv_heads=K, head_dim=dh,
                        window=W)
    want, wk, wv = jl.attention_decode_ring(
        {n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos), cfg)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = tl.attention_decode_ring(
        {n: torch.from_numpy(a) for n, a in w.items()}, torch.from_numpy(x),
        tk, tv, pos, tl.rope_freqs(dh, cfg.rope_theta, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for got_c, want_c in ((tk, wk), (tv, wv)):
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   atol=1e-5, rtol=1e-5)


def test_a_cache_too_short_for_the_prompt_is_refused():
    _, _, tm = pair("llama3_2_1b")
    with pytest.raises(ValueError, match="at least 12 positions"):
        tm.prefill(torch.ones((1, 12), dtype=torch.long),
                   tm.init_cache(1, 8))
