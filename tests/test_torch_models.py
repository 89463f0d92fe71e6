"""The port's layers, configs, weight bridge and hardware model against the
JAX package, at small widths.  Inputs are made with numpy from a seed.

Layers agree within 1e-5 in f32 (different summation orders) and within
one bf16 rounding (2e-2) in bf16.  ``linear`` and ``rmsnorm`` give every
row the same bits whatever the number of rows in the call."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
    torch_dtype,
)
from repro_torch.core import H100, h100  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(a, dtype):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JAX_DT[dtype]), torch.from_numpy(a).to(
        TORCH_DT[dtype])


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    rng = np.random.default_rng(0)
    R, d, f, H, dh, V = 7, 32, 48, 4, 16, 50
    jx, tx = both(rng.normal(size=(R, d)), dtype)
    js, ts = both(1.0 + 0.1 * rng.normal(size=(d,)), dtype)
    close(tl.rmsnorm(ts, tx), jl.rmsnorm({"scale": js}, jx), dtype)

    jq, tq = both(rng.normal(size=(R, H, dh)), dtype)
    pos = rng.integers(0, 5000, R).astype(np.int32)
    close(tl.rope(tq, torch.from_numpy(pos),
                  tl.rope_freqs(dh, 500000.0, "cpu")),
          jl.rope(jq[None], jnp.asarray(pos)[None], 500000.0)[0], dtype)

    (jg, tg), (ju, tu), (jd, td) = (
        both(rng.normal(size=s) / np.sqrt(s[0]), dtype)
        for s in ((d, f), (d, f), (f, d)))
    close(tl.mlp(tg, tu, td, tx),
          jl.mlp({"w_gate": jg, "w_up": ju, "w_down": jd}, jx[None])[0],
          dtype)

    je, te = both(rng.normal(size=(V, d)), dtype)
    tok = rng.integers(0, V, R).astype(np.int32)
    close(tl.embed(te, torch.from_numpy(tok)),
          jl.embed({"tok": je}, jnp.asarray(tok)), dtype)

    jh, th = both(rng.normal(size=(d, V)) / np.sqrt(d), dtype)
    got = tl.lm_head(th, tx)
    assert got.dtype == torch.float32
    close(got, jl.lm_head({"w": jh}, jx[None])[0], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_tiles_make_rows_independent_of_the_call(dtype):
    """Row r of a call with R rows equals the same row in a 1-row call and
    in a call of 37 other rows — the projections' share of one-shot ==
    chunked."""
    rng = np.random.default_rng(1)
    _, x = both(rng.normal(size=(37, 96)), dtype)
    _, w = both(rng.normal(size=(96, 80)), dtype)
    _, s = both(1.0 + rng.normal(size=(96,)), dtype)
    full_lin, full_norm = tl.linear(x, w), tl.rmsnorm(s, x)
    for r in (0, 5, 36):
        assert torch.equal(tl.linear(x[r:r + 1], w)[0], full_lin[r])
        assert torch.equal(tl.rmsnorm(s, x[r:r + 1])[0], full_norm[r])
    assert torch.equal(tl.linear(x[3:20], w), full_lin[3:20])


def test_config_and_weights_carry_across():
    ref = jget_smoke("llama3_2_1b")
    assert config_from_reference(ref) == configs.get_smoke("llama3_2_1b")
    assert config_from_reference(jget("llama3_2_1b")) == \
        configs.get("llama3_2_1b")
    assert torch_dtype(jnp.bfloat16) == torch.bfloat16
    model = build_model(dataclasses.replace(ref, remat=False))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    m = Model(config_from_reference(ref), device="cpu")
    m.load_state_dict(params_from_numpy(params, device="cpu"))
    wq = params["layers"]["attn"]["wq"]              # (L, d, H, dh) bf16
    assert m.layers[1].attn.wq.shape == wq.shape[1:]
    assert np.array_equal(m.layers[1].attn.wq.float().numpy(),
                          wq[1].astype(np.float32))
    assert np.array_equal(m.head.w.float().numpy(),
                          params["head"]["w"].astype(np.float32))


def test_init_follows_the_reference_statistics():
    """Per leaf: ones for norm scales, N(0, 0.02) for the embedding,
    N(0, 1/fan_in) with fan_in = shape[-2] elsewhere (as ``_leaf_init``
    reads the JAX package's layer-stacked shapes)."""
    cfg = dataclasses.replace(configs.get_smoke("llama3_2_1b"),
                              dtype=torch.float32)
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    ref = build_model(dataclasses.replace(jget_smoke("llama3_2_1b"),
                                          remat=False))
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      ref.init(jax.random.PRNGKey(0)))
    ours = dict(m.named_parameters())
    theirs = dict(params_from_numpy(jp, device="cpu"))
    assert ours.keys() == theirs.keys()
    for name, p in ours.items():
        a, b = p.detach().numpy(), theirs[name].numpy()
        if name.endswith(".scale"):
            assert np.all(a == 1.0) and np.all(b == 1.0)
            continue
        assert abs(a.std() / b.std() - 1.0) < 0.15, name


def test_h100_model_follows_the_page():
    page = 16 * 16 * 8 * 64 * 2 * 2
    assert H100.page_bytes == page and H100.fast.capacity_bytes == 80 * 10**9
    small = h100(4096)
    assert small.page_bytes == 4096
    assert small.ns_per_page_moved < H100.ns_per_page_moved
    assert H100.extra_ns_per_slow_access > 0
