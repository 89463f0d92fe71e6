"""MoE training in the port against the JAX package, on the CPU, at
granite's smoke widths (d_model 96, d_ff 64, 8 experts, top-2, 2 layers),
f32, inputs made with numpy from a seed.

The grouped-FFN backward: the port's plain version
(``ref.moe_grouped_ffn_bwd_reference``) against ``jax.vjp`` of the Pallas
kernel in interpret mode (its custom VJP ``_ffn_bwd``), within 1e-4 of
each output's largest entry (other summation orders); and against
autograd through a differentiable restatement of the plain forward, within
1e-5.  ``linear``'s gradients against ``matmul``'s, its forward bitwise
unchanged.  The MoE layer's gradients against ``jax.grad`` of
``repro.models.moe.moe`` within 1e-5 of each leaf's norm.  ``Model.loss``
and its gradients against the JAX model's (rtol 1e-4, each gradient leaf
within 1e-4 in norm, as ``tests/test_torch_train.py`` holds the dense
model), remat leaving the gradient bitwise unchanged; a 5-step trajectory
(rtol 1e-3, AdamW eps 1e-4); guided training lossless, with the JAX
trainer's sites and decisions.  Within the port, bitwise: two backward
passes of the layer, and the dispatch and combine's gradients against the
index arithmetic they stand for."""

import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import GuidanceConfig as JGuidanceConfig  # noqa: E402
from repro.core import TPU_V5E as JTPU_V5E  # noqa: E402
from repro.kernels.moe_gemm import moe_grouped_ffn_pallas  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import init_params  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import tiles  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.core import TPU_V5E, GuidanceConfig  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import value_and_grad  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "granite_moe_3b_a800m"
F32 = torch.float32
SMOKE = get_smoke(ARCH)
D, FF, E = SMOKE.d_model, SMOKE.d_ff, SMOKE.n_experts


# ------------------------------------------------------------------ helpers
def ffn_inputs(rng, sizes, n_weights=E):
    """Rows sorted into ``sizes`` segments and weights of the model's
    statistics, as numpy f32."""
    T = int(sum(sizes))
    x = rng.normal(size=(T, D)).astype(np.float32)
    wg = (rng.normal(size=(n_weights, D, FF)) / np.sqrt(D)).astype(np.float32)
    wu = (rng.normal(size=(n_weights, D, FF)) / np.sqrt(D)).astype(np.float32)
    wd = (rng.normal(size=(n_weights, FF, D)) / np.sqrt(FF)).astype(
        np.float32)
    dy = rng.normal(size=(T, D)).astype(np.float32)
    return x, wg, wu, wd, dy


def assert_scaled(got, want, tol):
    """max|got - want| <= tol * max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def assert_leaves_close(port_state, jax_tree, rtol):
    """Each leaf within ``rtol`` of the JAX leaf, in norm."""
    got = flat(params_to_numpy(port_state))
    want = flat(jax_tree)
    assert got.keys() == want.keys()
    for name in want:
        a = got[name].astype(np.float64)
        w = np.asarray(want[name], np.float64)
        assert a.shape == w.shape, name
        assert np.linalg.norm(a - w) <= rtol * np.linalg.norm(w), name


def jax_model(remat=False):
    return build_model(dataclasses.replace(jget_smoke(ARCH), remat=remat))


def jax_params(jm, seed=0, dtype=jnp.float32):
    return jax.tree.map(lambda a: a.astype(dtype),
                        jm.init(jax.random.PRNGKey(seed)))


def port_model(jm, jp, dtype=F32):
    cfg = dataclasses.replace(config_from_reference(jm.cfg), dtype=dtype)
    m = Model(cfg, device="cpu")
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jp),
                                        "cpu"))
    return m


def batches(n, batch=2, seq=32, seed=3):
    src = SyntheticLM(SMOKE.vocab, seq, batch, seed=seed)
    return [src.batch_np(i) for i in range(n)]


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# --------------------------------------------------- the grouped FFN's VJP
# (sizes, group_experts): empty groups, a map with repeats (G > E).
VJP_CASES = [
    ([5, 0, 17, 0, 3, 7, 0, 12], None),
    ([9, 0, 14, 6, 21, 0, 3, 8, 11, 2, 0, 5],
     [2, 0, 1, 1, 0, 7, 7, 3, 2, 5, 6, 2]),
    ([0, 0, 40, 0, 0, 0, 0, 1], None),
]


@pytest.mark.parametrize("sizes,experts", VJP_CASES)
def test_plain_backward_matches_the_pallas_vjp(sizes, experts):
    """(a) dx, dWg, dWu, dWd against ``jax.vjp`` of the Pallas kernel in
    interpret mode (its ``_ffn_bwd``), within 1e-4 of each output's
    largest entry."""
    rng = np.random.default_rng(len(sizes))
    x, wg, wu, wd, dy = ffn_inputs(rng, sizes)
    gs = np.asarray(sizes, np.int32)
    ge = None if experts is None else np.asarray(experts, np.int32)

    def fn(a, b, c, d):
        return moe_grouped_ffn_pallas(
            a, b, c, d, jnp.asarray(gs),
            None if ge is None else jnp.asarray(ge), block_t=16, block_f=32,
            interpret=True)

    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, wg, wu, wd)))
    want = vjp(jnp.asarray(dy))
    got = ref.moe_grouped_ffn_bwd_reference(
        *(torch.from_numpy(a) for a in (x, wg, wu, wd)),
        torch.from_numpy(gs), None if ge is None else torch.from_numpy(ge),
        torch.from_numpy(dy))
    for g, w in zip(got, want):
        assert g.dtype == F32
        assert_scaled(g.numpy(), w, 1e-4)


def restated_ffn(x, wg, wu, wd, sizes, experts):
    """The plain forward written with differentiable ops, group by group."""
    out, start = [], 0
    for g, n in enumerate(sizes):
        e = g if experts is None else experts[g]
        xr = x[start:start + n]
        h = torch.nn.functional.silu(xr @ wg[e]) * (xr @ wu[e])
        out.append(h @ wd[e])
        start += n
    return torch.cat(out)


@pytest.mark.parametrize("sizes,experts", VJP_CASES)
def test_plain_backward_equals_autograd_of_the_forward(sizes, experts):
    """(b) Within 1e-5 of each output's largest entry; the plain forward
    is the function autograd differentiates (within 1e-6)."""
    rng = np.random.default_rng(10 + len(sizes))
    arrays = [torch.from_numpy(a) for a in ffn_inputs(rng, sizes)]
    x, wg, wu, wd, dy = arrays
    gs = torch.tensor(sizes, dtype=torch.int32)
    ge = None if experts is None else torch.tensor(experts,
                                                   dtype=torch.int32)
    leaves = [t.clone().requires_grad_(True) for t in (x, wg, wu, wd)]
    y = restated_ffn(*leaves, sizes, experts)
    assert_scaled(ref.moe_grouped_ffn_reference(x, wg, wu, wd, gs, ge),
                  y.detach(), 1e-6)
    want = torch.autograd.grad(y, leaves, dy)
    got = ref.moe_grouped_ffn_bwd_reference(x, wg, wu, wd, gs, ge, dy)
    for g, w in zip(got, want):
        assert_scaled(g, w, 1e-5)


def test_plain_backward_edges():
    """Rows past the segments get zero dx; a group at slot -1 gets NaN dx
    rows and leaves every weight gradient as the same call without that
    group's rows gives it; an expert without rows gets zeros."""
    rng = np.random.default_rng(5)
    sizes = [6, 0, 9, 4]
    x, wg, wu, wd, dy = (torch.from_numpy(a)
                         for a in ffn_inputs(rng, sizes + [3]))
    gs = torch.tensor(sizes, dtype=torch.int32)
    good = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    bad = torch.tensor([0, 1, 2, -1], dtype=torch.int32)
    dx, *dw = ref.moe_grouped_ffn_bwd_reference(x, wg, wu, wd, gs, good, dy)
    assert torch.all(dx[19:] == 0) and torch.isfinite(dx[:19]).all()
    for w in dw:
        assert torch.all(w[1] == 0) and torch.all(w[4:] == 0)
    ndx, *ndw = ref.moe_grouped_ffn_bwd_reference(x, wg, wu, wd, gs, bad, dy)
    assert torch.isnan(ndx[15:19]).all() and torch.equal(ndx[:15], dx[:15])
    cut = torch.tensor([6, 0, 9, 0], dtype=torch.int32)
    _, *cdw = ref.moe_grouped_ffn_bwd_reference(x, wg, wu, wd, cut, good, dy)
    for a, b in zip(ndw, cdw):
        assert torch.equal(a, b)


def test_ops_grouped_ffn_is_differentiable_on_the_cpu():
    """``ops.moe_grouped_ffn`` takes the plain forward and backward through
    ``GroupedFFN``: autograd gives ``moe_grouped_ffn_bwd_reference``'s
    bits."""
    rng = np.random.default_rng(6)
    sizes = [5, 0, 17, 0, 3, 7, 0, 12]
    x, wg, wu, wd, dy = (torch.from_numpy(a) for a in ffn_inputs(rng, sizes))
    gs = torch.tensor(sizes, dtype=torch.int32)
    leaves = [t.clone().requires_grad_(True) for t in (x, wg, wu, wd)]
    y = ops.moe_grouped_ffn(*leaves, gs)
    assert torch.equal(y.detach(),
                       ref.moe_grouped_ffn_reference(x, wg, wu, wd, gs))
    got = torch.autograd.grad(y, leaves, dy)
    want = ref.moe_grouped_ffn_bwd_reference(x, wg, wu, wd, gs, None, dy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert mg.LAUNCHES["moe_grouped_ffn_bwd"] == 0     # no kernel on the CPU


# ------------------------------------------------------------------ linear
@pytest.mark.parametrize("rows", [1, 16, 37])
def test_linear_gradients_equal_matmul_and_forward_is_unchanged(rows):
    """(c) The forward keeps its bits with and without autograd; the
    gradients equal autograd through ``torch.matmul``."""
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.normal(size=(rows, 24)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(24, 10)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(rows, 10)).astype(np.float32))
    with torch.no_grad():
        plain = tiles.linear(x, w)
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = tiles.linear(xl, wl)
    assert torch.equal(y.detach(), plain)
    gx, gw = torch.autograd.grad(y, (xl, wl), dy)
    xm, wm = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    mx, mw = torch.autograd.grad(torch.matmul(xm, wm), (xm, wm), dy)
    torch.testing.assert_close(gx, mx, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gw, mw, rtol=1e-6, atol=1e-6)
    # Only the tensor that needs a gradient gets one.
    (gw_only,) = torch.autograd.grad(tiles.linear(x, wl), (wl,), dy)
    assert torch.equal(gw_only, gw)


# ---------------------------------------------------------------- MoE layer
def moe_cfg(top_k=2, parallelism="tp"):
    """ep pads the 8 experts to 9, one of them dead."""
    return jmoe.MoEConfig(d_model=D, d_ff=FF, n_experts=E, top_k=top_k,
                          parallelism=parallelism, ep_axis_size=3)


def port_cfg(cfg):
    return tmoe.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                          n_experts=cfg.n_experts, top_k=cfg.top_k,
                          parallelism=cfg.parallelism,
                          ep_axis_size=cfg.ep_axis_size)


def moe_params(cfg, seed):
    jp = init_params(jmoe.moe_defs(cfg), jax.random.PRNGKey(seed))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("top_k,parallelism", [(1, "tp"), (2, "tp"),
                                               (2, "ep")])
def test_moe_layer_gradients_match_jax(top_k, parallelism):
    """(d) x, router and expert gradients of a random projection of the
    layer's output, against ``jax.grad`` of ``repro.models.moe.moe``, each
    within 1e-5 of the JAX leaf's norm (ep: the dead expert's router
    column and weights get zero gradient in both).  With one pick the
    router has no gradient to compare."""
    cfg = moe_cfg(top_k, parallelism)
    jp, tp = moe_params(cfg, seed=top_k)
    rng = np.random.default_rng(20 + top_k)
    x = rng.normal(size=(2, 9, D)).astype(np.float32)
    proj = rng.normal(size=(2, 9, D)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jmoe.moe(p, xx, cfg) * proj)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tmoe.moe(types.SimpleNamespace(**leaves), xt, port_cfg(cfg))
    loss = torch.sum(y * torch.from_numpy(proj))
    grads = torch.autograd.grad(loss, [xt, *leaves.values()])
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jp, x)),
                               rtol=1e-5)
    scale = np.linalg.norm(np.asarray(jgx))
    for name, got, want in zip(["x", *leaves], grads,
                               [jgx, *(jg[k] for k in leaves)]):
        got, want = got.numpy().astype(np.float64), np.asarray(want,
                                                               np.float64)
        if name == "router" and top_k == 1:
            # One pick renormalises to a gate of exactly 1: the router's
            # gradient is round-off in both, compared with the input's.
            assert np.linalg.norm(got) <= 1e-5 * scale
            assert np.linalg.norm(want) <= 1e-5 * scale
            continue
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want), \
            name


def test_moe_layer_backward_is_bitwise_reproducible():
    """Two backward passes of the layer give the same bits; the dispatch's
    gradient is the fixed-order sum of each token's k pick gradients, and
    the combine's the gather of each pick's token row."""
    cfg = port_cfg(moe_cfg(2))
    _, tp = moe_params(moe_cfg(2), seed=9)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 13, D)).astype(np.float32))
    proj = torch.from_numpy(rng.normal(size=(2, 13, D)).astype(np.float32))
    runs = []
    for _ in range(2):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        xt = x.clone().requires_grad_(True)
        y = tmoe.moe(types.SimpleNamespace(**leaves), xt, cfg)
        runs.append(torch.autograd.grad(torch.sum(y * proj),
                                        [xt, *leaves.values()]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)

    T, k = 5, 3
    order = torch.from_numpy(rng.permutation(T * k))
    tok_idx = order // k
    inverse = torch.argsort(order)
    where = torch.sort(inverse.reshape(T, k), dim=-1).values
    src = torch.from_numpy(rng.normal(size=(T, 4)).astype(np.float32))
    src.requires_grad_(True)
    rows = tmoe._Dispatch.apply(src, tok_idx, where)
    assert torch.equal(rows.detach(), src.detach()[tok_idx])
    d_rows = torch.from_numpy(rng.normal(size=(T * k, 4)).astype(np.float32))
    (got,) = torch.autograd.grad(rows, src, d_rows)
    want = torch.zeros(T, 4)
    for j in range(k):
        want = want + d_rows[where[:, j]]
    assert torch.equal(got, want)
    ys = torch.from_numpy(rng.normal(size=(T * k, 4)).astype(np.float32))
    gates = torch.from_numpy(rng.random(T * k).astype(np.float32))
    ys.requires_grad_(True)
    gates.requires_grad_(True)
    y = tmoe._Combine.apply(ys, gates, order, inverse, where)
    dy = torch.from_numpy(rng.normal(size=(T, 4)).astype(np.float32))
    dys, dgates = torch.autograd.grad(y, (ys, gates), dy)
    gs = gates.detach()[order]
    assert torch.equal(dys, dy[tok_idx] * gs[:, None])
    want = torch.empty(T * k)
    want[order] = (dy[tok_idx] * ys.detach()).sum(-1)
    assert torch.equal(dgates, want)


# -------------------------------------------------------- loss and training
@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_and_gradients_match_jax(remat):
    """(e) ``Model.loss`` and every gradient leaf, remat on and off."""
    jm = jax_model(remat)
    jp = jax_params(jm)
    m = port_model(jm, jp)
    assert m.cfg.remat == remat and m.cfg.family == "moe"
    b = batches(1, batch=2, seq=64)[0]
    want_loss, want_grads = jax.value_and_grad(jm.loss)(jp, to_jax(b))
    loss, grads = value_and_grad(m, dict(m.named_parameters()), to_torch(b))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert_leaves_close(grads, want_grads, rtol=1e-4)
    assert not any(p.requires_grad for p in m.parameters())


def test_moe_remat_does_not_change_the_gradient():
    """The recompute under remat routes as the first forward did: loss and
    gradients bitwise equal with and without remat."""
    jm = jax_model(False)
    jp = jax_params(jm, seed=1)
    plain = port_model(jm, jp)
    remat = port_model(jax_model(True), jp)
    b = to_torch(batches(1, seq=48)[0])
    l1, g1 = value_and_grad(plain, dict(plain.named_parameters()), b)
    l2, g2 = value_and_grad(remat, dict(remat.named_parameters()), b)
    assert torch.equal(l1, l2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


def jax_trainer(jm, jp, opt, cfg, **kw):
    tr = JTrainer(jm, opt, cfg, rng=jax.random.PRNGKey(0), **kw)
    tr.params = jax.tree.map(jnp.copy, jp)       # the step donates them
    tr.opt_state = opt.init(tr.params)
    return tr


def test_moe_trainer_trajectory_matches_jax():
    """(f) Five steps of both trainers from the same f32 weights and
    batches, AdamW eps 1e-4 (see ``tests/test_torch_train.py``)."""
    jm = jax_model()
    jp = jax_params(jm, seed=2)
    data = batches(5, batch=4, seq=32)
    jtr = jax_trainer(jm, jp, JAdamW(lr=1e-3, eps=1e-4),
                      JTrainerConfig(steps=5, log_every=1))
    jtr.run(iter(to_jax(b) for b in data))
    m = port_model(jm, jp)
    tr = Trainer(m, AdamW(lr=1e-3, eps=1e-4),
                 TrainerConfig(steps=5, log_every=1),
                 params=dict(m.state_dict()))
    tr.run(iter(to_torch(b) for b in data))
    got = [r["loss"] for r in tr.metrics_log]
    want = [r["loss"] for r in jtr.metrics_log]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]
    assert [r["step"] for r in tr.metrics_log] == [1, 2, 3, 4, 5]


def test_moe_guided_training_is_lossless_and_offloads():
    """(g) Guided == unguided losses and parameters, bitwise, with state
    on the slow tier."""
    data = [to_torch(b) for b in batches(6, batch=4, seq=32)]
    jm = jax_model()
    jp = jax_params(jm, seed=5)

    def trainer(gdt=None):
        m = port_model(jm, jp)
        return Trainer(m, AdamW(lr=1e-3, eps=1e-4),
                       TrainerConfig(steps=6, log_every=1, gdt=gdt),
                       params=dict(m.state_dict()))

    plain = trainer()
    state = sum(p.numel() * (p.element_size() + 8)
                for p in plain.params.values())
    guided = trainer(GuidanceConfig(
        enabled=True, fast_capacity_bytes=int(state * 0.6),
        interval_steps=2, promotion_threshold=1024))
    plain.run(iter(data))
    out = guided.run(iter(data))
    assert [r["loss"] for r in guided.metrics_log] == \
        [r["loss"] for r in plain.metrics_log]
    assert guided.placer.slow_bytes() > 0 and out["transfer_bytes"] > 0
    for name, p in plain.params.items():
        assert torch.equal(guided.params[name].data, p.data), name
    assert any(k.startswith("params/layers/moe") or
               k.startswith("adam_v/layers/moe")
               for k in guided._site_groups)


def test_moe_sites_and_decisions_match_the_jax_trainer():
    """(g) Same GuidanceConfig, TPU_V5E on both, bf16 weights (the router
    f32) on both: the same sites with the same bytes (the MoE groups among
    them), the same first-touch fractions, interval decisions and
    migration totals (they read bytes, not values); the per-layer router,
    rank 3 in JAX, is decayed."""
    jm = jax_model()
    jp = jax_params(jm, seed=6, dtype=jnp.bfloat16)
    data = batches(6, batch=2, seq=32)
    total = sum(a.size * a.dtype.itemsize + 8 * a.size
                for a in jax.tree.leaves(jp))
    kw = dict(fast_capacity_bytes=int(total * 0.1), interval_steps=2,
              promotion_threshold=1024)
    jtr = JTrainer(jm, JAdamW(lr=1e-3),
                   JTrainerConfig(steps=6, log_every=1,
                                  gdt=JGuidanceConfig(enabled=True, **kw)),
                   hw=JTPU_V5E, rng=jax.random.PRNGKey(0))
    jtr.run(iter(to_jax(b) for b in data))
    m = port_model(jm, jp, dtype=torch.bfloat16)
    tr = Trainer(m, AdamW(lr=1e-3),
                 TrainerConfig(steps=6, log_every=1,
                               gdt=GuidanceConfig(enabled=True, **kw)),
                 hw=TPU_V5E, params=dict(m.state_dict()))
    tr.run(iter(to_torch(b) for b in data))
    assert "params/layers/moe" in tr._site_groups
    assert list(tr._site_groups) == list(jtr._site_groups)
    for key, (site, arena, _) in tr._site_groups.items():
        jsite, jarena, _ = jtr._site_groups[key]
        assert site.path == jsite.path and site.kind.value == jsite.kind.value
        assert arena.resident_bytes == jarena.resident_bytes, key
        assert arena.fast_fraction == jarena.fast_fraction, key
    assert tr.gdt.migration_count == jtr.gdt.migration_count
    assert tr.gdt.total_bytes_migrated == jtr.gdt.total_bytes_migrated

    def stream(rt):
        return [(e.interval_index, e.decision.rental_cost_ns,
                 e.decision.purchase_cost_ns, e.decision.bytes_to_move,
                 e.decision.migrate, e.migrated, e.bytes_moved,
                 e.fast_bytes_after)
                for e in rt.events if e.kind == "interval"]

    assert stream(tr.gdt) == stream(jtr.gdt) and stream(tr.gdt)
    from repro_torch.train.step import jax_ndim

    router = tr.params["layers.0.moe.router"]
    assert router.dim() == 2 and jax_ndim("layers.0.moe.router", router) == 3


def test_launcher_trains_moe_under_an_hbm_budget():
    """``python -m repro_torch.launch.train`` takes the MoE arch, guided."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
         "--seq", "32", "--gdt-budget-mb", "1", "--gdt-interval", "2"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"transfer_bytes"' in proc.stdout and '"final_loss"' in proc.stdout
