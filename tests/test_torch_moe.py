"""The port's MoE layer and grouped-expert FFN against the JAX package, at
small widths.  Inputs are made with numpy from a seed.

Across frameworks: the port's plain grouped FFN against the Pallas kernel
(run with ``interpret=True``, as the JAX package's own tests run it) and
the JAX oracle, within 1e-5 in f32 and 1e-2 in bf16 (different summation
orders; bf16 rounds the output once); ``route_tokens`` picks the same
experts with gates within 1e-6; ``moe`` agrees within 1e-5 in f32.

Within the port, bitwise: a row's grouped-FFN output and a token's MoE
output do not depend on the other rows of the call, and the
``expert_slots`` remap changes nothing."""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gemm import moe_grouped_ffn_pallas  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import init_params  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(a, dtype="float32"):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JAX_DT[dtype]), torch.from_numpy(a).to(
        TORCH_DT[dtype])


def ffn_case(rng, E, G, d, f, max_size, dtype):
    """Ragged sizes over G groups with one forced empty group, and random
    inputs for both frameworks."""
    sizes = rng.integers(0, max_size, G)
    sizes[rng.integers(0, G)] = 0
    if sizes.sum() == 0:
        sizes[0] = 3
    T = int(sizes.sum())
    arrays = [both(rng.normal(size=(T, d)), dtype)]
    arrays += [both(rng.normal(size=s) * 0.1, dtype)
               for s in ((E, d, f), (E, d, f), (E, f, d))]
    return sizes.astype(np.int32), arrays


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_ffn_plain_matches_pallas_and_oracle(dtype, seed):
    """The ``test_moe_dispatch`` sweep: ragged sizes, empty groups forced,
    segments straddling the kernel's row tiles."""
    rng = np.random.default_rng(seed)
    E = int(rng.integers(2, 9))
    sizes, [(jx, tx), (jg, tg), (ju, tu), (jd, td)] = ffn_case(
        rng, E, E, 64, 96, 50, dtype)
    gs = jnp.asarray(sizes)
    got = ref.moe_grouped_ffn_reference(tx, tg, tu, td,
                                        torch.from_numpy(sizes))
    assert got.dtype == TORCH_DT[dtype]
    for want in (moe_grouped_ffn_pallas(jx, jg, ju, jd, gs, block_t=32,
                                        block_f=64, interpret=True),
                 jref.moe_grouped_ffn_reference(jx, jg, ju, jd, gs)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_ffn_group_experts_map(seed):
    """G > E groups with a group -> weight-row map (the ep and expert-cache
    layouts), against the Pallas kernel and the oracle."""
    rng = np.random.default_rng(10 + seed)
    E, G = 3, 8
    sizes, [(jx, tx), (jg, tg), (ju, tu), (jd, td)] = ffn_case(
        rng, E, G, 32, 48, 20, "float32")
    gexp = rng.integers(0, E, G).astype(np.int32)
    gs, ge = jnp.asarray(sizes), jnp.asarray(gexp)
    got = ref.moe_grouped_ffn_reference(tx, tg, tu, td,
                                        torch.from_numpy(sizes),
                                        torch.from_numpy(gexp))
    for want in (moe_grouped_ffn_pallas(jx, jg, ju, jd, gs, ge, block_t=16,
                                        block_f=32, interpret=True),
                 jref.moe_grouped_ffn_reference(jx, jg, ju, jd, gs, ge)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_grouped_ffn_rows_are_independent_of_the_call():
    """Bitwise: the first rows of a call equal the same rows computed alone
    (their groups cut to those rows), and rows past sum(group_sizes) are
    zeros."""
    rng = np.random.default_rng(3)
    E, d, f = 5, 32, 40
    sizes = np.array([7, 0, 20, 3, 11], np.int32)
    x = torch.from_numpy(rng.normal(size=(45, d)).astype(np.float32))
    w = [torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    full = ref.moe_grouped_ffn_reference(x, *w, torch.from_numpy(sizes))
    assert torch.all(full[41:] == 0)
    head = np.array([7, 0, 5, 0, 0], np.int32)
    part = ref.moe_grouped_ffn_reference(x[:12], *w, torch.from_numpy(head))
    assert torch.equal(part, full[:12])


def moe_cfg(parallelism="tp", top_k=2):
    return jmoe.MoEConfig(d_model=32, d_ff=48, n_experts=6, top_k=top_k,
                          parallelism=parallelism, ep_axis_size=4)


def params(cfg, seed=0):
    """JAX params in f32 (the router already is) and the same weights as
    the port's attribute bag."""
    jp = jax.tree.map(
        lambda a: a.astype(jnp.float32),
        init_params(jmoe.moe_defs(cfg), jax.random.PRNGKey(seed)))
    tp = types.SimpleNamespace(
        **{k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jp, tp


def port_cfg(cfg):
    return tmoe.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                          n_experts=cfg.n_experts, top_k=cfg.top_k,
                          parallelism=cfg.parallelism,
                          ep_axis_size=cfg.ep_axis_size)


@pytest.mark.parametrize("parallelism", ["tp", "ep"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_route_tokens_matches_jax(parallelism, top_k):
    """ep pads 6 experts to 8 dead-masked ones."""
    cfg = moe_cfg(parallelism, top_k)
    jp, tp = params(cfg)
    assert tp.router.shape[1] == port_cfg(cfg).padded_experts
    jx, tx = both(np.random.default_rng(4).normal(size=(40, 32)))
    jg, je = jmoe.route_tokens(jp["router"], jx, cfg)
    tg, te = tmoe.route_tokens(tp.router, tx, port_cfg(cfg))
    assert te.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-6)
    assert int(te.max()) < cfg.n_experts


@pytest.mark.parametrize("parallelism", ["tp", "ep"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_matches_jax(parallelism, top_k):
    cfg = moe_cfg(parallelism, top_k)
    jp, tp = params(cfg, seed=1)
    jx, tx = both(np.random.default_rng(5).normal(size=(2, 9, 32)))
    want = jmoe.moe(jp, jx, cfg)
    got = tmoe.moe(tp, tx, port_cfg(cfg))
    assert got.shape == (2, 9, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(
        tmoe.moe_decode(tp, tx, port_cfg(cfg)).numpy(), got.numpy())


def test_moe_rows_one_at_a_time_equal_the_whole_set():
    """Bitwise, within the port: moe over S rows == each row alone, as a
    (1, 1, d) decode call and as part of a shorter chunk."""
    cfg = port_cfg(moe_cfg("tp", 2))
    _, tp = params(moe_cfg("tp", 2), seed=2)
    x = torch.from_numpy(
        np.random.default_rng(6).normal(size=(1, 21, 32)).astype(np.float32))
    full = tmoe.moe(tp, x, cfg)
    for s in range(21):
        assert torch.equal(tmoe.moe_decode(tp, x[:, s:s + 1], cfg)[0, 0],
                           full[0, s])
    assert torch.equal(tmoe.moe(tp, x[:, 5:12], cfg), full[:, 5:12])


def test_expert_slots_remap_is_bitwise_equal():
    """``apply_dropless_flat`` with ``expert_slots``: the identity map and a
    permuted bank with a junk row give the dense layout's bits."""
    cfg = port_cfg(moe_cfg("tp", 2))
    _, tp = params(moe_cfg("tp", 2), seed=3)
    x = torch.from_numpy(
        np.random.default_rng(7).normal(size=(2, 6, 32)).astype(np.float32))
    gates, experts = tmoe.route_tokens(tp.router, x.reshape(12, 32), cfg)
    w = (tp.w_gate, tp.w_up, tp.w_down)
    dense = tmoe.apply_dropless_flat(gates, experts, x, *w, cfg)
    E = cfg.n_experts
    ident = tmoe.apply_dropless_flat(gates, experts, x, *w, cfg,
                                     expert_slots=torch.arange(E))
    assert torch.equal(dense, ident)
    perm = torch.from_numpy(np.random.default_rng(8).permutation(E))
    bank = [torch.cat([a[perm], torch.full_like(a[:1], 1e3)]) for a in w]
    slots = torch.argsort(perm)               # expert e sits in row slots[e]
    assert torch.equal(bank[0][slots], w[0])
    remapped = tmoe.apply_dropless_flat(gates, experts, x, *bank, cfg,
                                        expert_slots=slots)
    assert torch.equal(dense, remapped)


def test_capacity_and_per_row_dispatches_match_jax():
    """The two dispatches the port once refused run and agree with the JAX
    package in f32: ``moe(dispatch="capacity")`` and the per-row dropless
    layout (``_moe_dropless(per_row=True)``)."""
    cfg = moe_cfg()
    jp, tp = params(cfg, seed=4)
    jx, tx = both(np.random.default_rng(9).normal(size=(2, 7, 32)))
    got = tmoe.moe(tp, tx, port_cfg(cfg), dispatch="capacity")
    want = jmoe.moe(jp, jx, cfg, dispatch="capacity")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    got = tmoe._moe_dropless(tp, tx, port_cfg(cfg), per_row=True)
    want = jmoe._moe_dropless(jp, jx, cfg, per_row=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


