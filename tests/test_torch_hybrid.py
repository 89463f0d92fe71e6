"""The port's hybrid family (zamba2: Mamba2 layers and one shared
attention+MLP block) against the JAX package, on the CPU at smoke widths:
the contiguous-cache ``prefill`` and ``decode``, the weights across the
packages, and what the slice does not serve.

f32 throughout, with the JAX params cast to f32 (they are bf16 whatever
``cfg.dtype`` says), as ``tests/test_recurrent_prefill.py`` does.
Tolerance: 2e-3, the JAX package's own for logits (its prefill against its
stepwise decode), for logits (as a fraction of the largest logit) and for
every cache leaf (in norm), with equal greedy tokens.  The two packages
sum in other orders, and seven random layers amplify f32 round-off: the
differences grow layer by layer, in each package's two forms as between
the packages, so the 1e-4 that holds one kernel call does not hold here.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    jax_order,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import Engine, LLM, ServeConfig  # noqa: E402

ARCH = "zamba2_7b"
TOL = 2e-3


def f32_pair(seed=0):
    """The JAX model and f32 params, and the port's f32 model holding the
    same weights."""
    cfg = dataclasses.replace(jget_smoke(ARCH), remat=False,
                              dtype=jnp.float32)
    jm = build_model(cfg)
    params = jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jm.init(jax.random.PRNGKey(seed)))
    tm = Model(config_from_reference(cfg), device="cpu")
    tm.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params),
                                         device="cpu"))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return f32_pair()


def assert_scaled_close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol)


def assert_norm_close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


def assert_caches_close(tcache, jcache):
    """Every layer's (or shared application's) slice of every leaf."""
    leaves = [(tcache["conv"], jcache["conv"]), (tcache["ssm"], jcache["ssm"]),
              (tcache["kv"]["k"], jcache["kv"]["k"]),
              (tcache["kv"]["v"], jcache["kv"]["v"])]
    for t, j in leaves:
        assert t.dtype == torch.float32
        for i in range(t.shape[0]):
            assert_norm_close(t[i].numpy(), j[i])


def prompts(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(
        np.int32)


def test_config_matches_the_reference():
    assert configs.get(ARCH) == config_from_reference(jget(ARCH))
    assert configs.get_smoke(ARCH) == config_from_reference(jget_smoke(ARCH))
    cfg = configs.get(ARCH)
    assert (cfg.d_inner, cfg.resolved_head_dim) == (7168, 112)
    with pytest.raises(ValueError, match="attn_every"):
        dataclasses.replace(cfg, attn_every=0).validate()


@pytest.mark.parametrize("S", [256, 8])
def test_prefill_matches_jax(pair, S):
    """Two SSD chunks of 128, and a prompt shorter than one chunk: the
    last-position logits and every cache leaf."""
    jm, params, tm = pair
    cfg = tm.cfg
    tokens = prompts(cfg.vocab, 2, S, 1)
    jlogits, jcache = jax.jit(jm.prefill)(
        params, {"tokens": jnp.asarray(tokens)}, jm.init_cache(2, S + 8))
    tcache = tm.init_cache(2, S + 8)
    assert {k: tuple(v.shape) for k, v in tcache["kv"].items()} == \
        {k: v.shape for k, v in jcache["kv"].items()}
    tlogits, tcache = tm.prefill(torch.from_numpy(tokens), tcache)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (2, cfg.vocab)
    assert_scaled_close(tlogits.numpy(), jlogits)
    assert_caches_close(tcache, jcache)


def test_greedy_decode_matches_jax(pair):
    """Prefill 8 tokens, then 4 greedy decode steps: the same tokens, the
    logits and the final cache close."""
    jm, params, tm = pair
    tokens = prompts(tm.cfg.vocab, 2, 8, 2)
    jlogits, jcache = jax.jit(jm.prefill)(
        params, {"tokens": jnp.asarray(tokens)}, jm.init_cache(2, 16))
    tlogits, tcache = tm.prefill(torch.from_numpy(tokens),
                                 tm.init_cache(2, 16))
    jdecode = jax.jit(jm.decode)
    for pos in range(8, 12):
        jnext = np.asarray(jnp.argmax(jlogits, -1), np.int32)
        tnext = tlogits.argmax(-1)
        assert tnext.tolist() == jnext.tolist(), pos
        jlogits, jcache = jdecode(params, jcache,
                                  jnp.asarray(jnext[:, None]),
                                  jnp.int32(pos))
        tlogits, tcache = tm.decode(tnext, tcache, pos)
        assert_scaled_close(tlogits.numpy(), jlogits)
    assert_caches_close(tcache, jcache)


def run_both_ways(tm, tokens, n_new, cache_len):
    """(tokens, logits) of prefill-then-greedy-decode and of pure stepwise
    decode of the same prompt (``test_recurrent_prefill.py`` mirrored)."""
    S = tokens.shape[1]
    t = torch.from_numpy(tokens)
    logits, cache = tm.prefill(t, tm.init_cache(1, cache_len))
    a, la = [], [logits]
    for pos in range(S, S + n_new):
        a.append(int(logits.argmax(-1)))
        logits, cache = tm.decode(logits.argmax(-1), cache, pos)
        la.append(logits)
    cache = tm.init_cache(1, cache_len)
    for pos in range(S):
        logits, cache = tm.decode(t[:, pos], cache, pos)
    b, lb = [], [logits]
    for pos in range(S, S + n_new):
        b.append(int(logits.argmax(-1)))
        logits, cache = tm.decode(logits.argmax(-1), cache, pos)
        lb.append(logits)
    return (a, la), (b, lb)


@pytest.mark.parametrize("S", [8, 256])
def test_prefill_then_decode_matches_stepwise(pair, S):
    _, _, tm = pair
    (a, la), (b, lb) = run_both_ways(tm, prompts(tm.cfg.vocab, 1, S, 3), 4,
                                     S + 8)
    assert a == b
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=TOL,
                                   rtol=TOL)


def test_hybrid_weights_load_and_round_trip_bitwise():
    """The JAX hybrid tree (``ssm_layers`` stacked over L, ``shared_attn``
    unstacked, bf16 and f32 leaves) loads into the port and comes back bit
    for bit."""
    jm = build_model(dataclasses.replace(jget_smoke(ARCH), remat=False))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    tm = Model(config_from_reference(jget_smoke(ARCH)), device="cpu")
    state = params_from_numpy(tree, device="cpu")
    tm.load_state_dict(state)
    assert tm.ssm_layers[6].ssm.w_z.dtype == torch.bfloat16
    assert tm.ssm_layers[6].ssm.a_log.dtype == torch.float32
    assert np.array_equal(tm.ssm_layers[6].ssm.w_z.float().numpy(),
                          tree["ssm_layers"]["ssm"]["w_z"][6].astype(
                              np.float32))
    back = params_to_numpy(dict(tm.named_parameters()))

    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            name = f"{prefix}/{k}" if prefix else k
            out.update(flat(v, name) if isinstance(v, dict) else {name: v})
        return out

    got, want = flat(back), flat(tree)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        assert np.ascontiguousarray(g).tobytes() == \
            np.ascontiguousarray(w).tobytes(), name
    names = jax_order(dict(tm.named_parameters()))
    assert names[0] == "embed.tok" and names[-1].startswith("ssm_layers.6.")


def test_init_follows_the_reference_statistics():
    """zamba2's leaves: D and the gated norm ones, dt_bias and a_log zeros,
    conv_x N(0, 0.5^2), the projections N(0, 1/fan_in)."""
    cfg = dataclasses.replace(configs.get_smoke(ARCH), dtype=torch.float32)
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    ref = build_model(dataclasses.replace(jget_smoke(ARCH), remat=False))
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      ref.init(jax.random.PRNGKey(0)))
    ours = dict(m.named_parameters())
    theirs = dict(params_from_numpy(jp, device="cpu"))
    assert ours.keys() == theirs.keys()
    for name, p in ours.items():
        a, b = p.detach().numpy(), theirs[name].numpy()
        if a.std() == 0 or b.std() == 0:
            assert np.array_equal(a, b), name
            continue
        assert abs(a.std() / b.std() - 1.0) < 0.15, name


def test_what_the_slice_does_not_serve_raises(pair):
    _, _, tm = pair
    # The paged engine serves decoder LMs, as the JAX engine asserts.
    with pytest.raises(ValueError, match="paged engine serves decoder LMs"):
        Engine(tm, ServeConfig())
    with pytest.raises(ValueError, match="paged engine serves decoder LMs"):
        LLM.from_arch(ARCH, device="cpu")
    # A dense model's contiguous cache has the JAX package's shape.
    dense = Model(configs.get_smoke("llama3_2_1b"), device="cpu")
    want = build_model(jget_smoke("llama3_2_1b")).init_cache(1, 8)
    got = dense.init_cache(1, 8)
    assert set(got) == set(want) == {"kv"}
    for leaf in ("k", "v"):
        assert tuple(got["kv"][leaf].shape) == want["kv"][leaf].shape
