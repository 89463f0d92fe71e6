"""The MoE dispatches the port added beside the flat dropless layout,
against the JAX package in f32 at granite's smoke widths (d 96, f 64, 8
experts, top-2; ep pads 6 experts to 8): the per-row dropless layout and
the capacity dispatch, outputs within 1e-5 and gradients within 1e-4 of
each leaf's largest entry of ``jax.grad``'s.

Within the port: the per-row layout's output equals the flat layout's bit
for bit (a row's grouped-FFN bits depend on the row and its expert alone,
and each token's k results combine in the same order); the capacity
dispatch drops picks (counted), keeps a live slot C-1 when the capacity
is a multiple of 8 (the JAX scatter sends dropped picks there with a zero
update), equals dropless at one token a row, and serves through the
``Engine`` as ``Model`` generates."""

import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401
from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import init_params  # noqa: E402
from repro.models.layers import lm_head as jlm_head  # noqa: E402
from repro.models.layers import rmsnorm as jrmsnorm  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import norm, project  # noqa: E402
from repro_torch.serve import Engine, SamplingParams, ServeConfig  # noqa: E402

MOE = "granite_moe_3b_a800m"
SMOKE = get_smoke(MOE)
D, FF = SMOKE.d_model, SMOKE.d_ff


def jax_cfg(parallelism="tp", n_experts=SMOKE.n_experts, top_k=2,
            capacity_factor=1.0):
    return jmoe.MoEConfig(d_model=D, d_ff=FF, n_experts=n_experts,
                          top_k=top_k, capacity_factor=capacity_factor,
                          parallelism=parallelism, ep_axis_size=4)


def port_cfg(cfg):
    return tmoe.MoEConfig(**dataclasses.asdict(cfg))


def params(cfg, seed):
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_params(jmoe.moe_defs(cfg),
                                  jax.random.PRNGKey(seed)))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def inputs(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def grads_both(jfn, tfn, jp, tp, x, seed):
    """Loss and gradients (x first, then each parameter) of a random
    projection of the layer's output, by ``jax.grad`` and by autograd."""
    proj = inputs(x.shape, seed)

    def jloss(p, xx):
        return jnp.sum(jfn(p, xx) * proj)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    got = port_grads(tfn, tp, x, proj)
    return ["x", *tp], got, [jgx, *(jg[k] for k in tp)]


def port_grads(tfn, tp, x, proj):
    """The port's gradients of ``sum(tfn(p, x) * proj)``: x, then each
    parameter of ``tp``."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tfn(types.SimpleNamespace(**leaves), xt)
    return torch.autograd.grad(torch.sum(y * torch.from_numpy(proj)),
                               [xt, *leaves.values()])


def assert_leaves_close(names, got, want, tol=1e-4):
    """Each gradient within ``tol`` of the JAX leaf's largest entry."""
    for name, a, w in zip(names, got, want):
        w = np.asarray(w, np.float64)
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(a.numpy().astype(np.float64) - w).max()
        assert err <= tol * scale, (name, err, scale)


# ------------------------------------------------------------ per-row
@pytest.mark.parametrize("parallelism,n_experts",
                         [("tp", 8), ("ep", 6)])
def test_per_row_matches_jax_and_the_flat_layout(parallelism, n_experts):
    cfg = jax_cfg(parallelism, n_experts)
    jp, tp = params(cfg, seed=1)
    x = inputs((3, 11, D), 2)
    p = types.SimpleNamespace(**tp)
    got = tmoe._moe_dropless(p, torch.from_numpy(x), port_cfg(cfg),
                             per_row=True)
    want = jmoe._moe_dropless(jp, jnp.asarray(x), cfg, per_row=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    flat = tmoe._moe_dropless(p, torch.from_numpy(x), port_cfg(cfg))
    assert torch.equal(got, flat)


@pytest.mark.parametrize("parallelism,n_experts",
                         [("tp", 8), ("ep", 6)])
def test_per_row_gradients_match_jax(parallelism, n_experts):
    """Against ``jax.grad`` of the JAX per-row layout, and against the
    flat layout's gradients within 1e-5 of each one's largest entry: the
    plain backward multiplies whole segments, so its bits depend on where
    segments start (the kernel's dx rows do not; ``chip_smoke.py`` phase
    15 holds dx bitwise on the card)."""
    cfg = jax_cfg(parallelism, n_experts)
    jp, tp = params(cfg, seed=3)
    x = inputs((2, 9, D), 4)
    names, got, want = grads_both(
        lambda p, xx: jmoe._moe_dropless(p, xx, cfg, per_row=True),
        lambda p, xx: tmoe._moe_dropless(p, xx, port_cfg(cfg),
                                         per_row=True),
        jp, tp, x, 5)
    assert_leaves_close(names, got, want)
    _, flat, _ = grads_both(
        lambda p, xx: jmoe._moe_dropless(p, xx, cfg, per_row=False),
        lambda p, xx: tmoe._moe_dropless(p, xx, port_cfg(cfg)),
        jp, tp, x, 5)
    for a, b in zip(got, flat):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-30)


def test_per_row_launches_b_times_e_groups(monkeypatch):
    """The grouped FFN takes B*E segments, each row's picks counted by
    expert, with ``group_experts`` = arange(E) tiled B times."""
    cfg = jax_cfg()
    _, tp = params(cfg, seed=6)
    x = torch.from_numpy(inputs((3, 5, D), 7))
    calls = []
    real = tmoe.ops.moe_grouped_ffn

    def spy(xs, wg, wu, wd, sizes, experts=None):
        calls.append((sizes.clone(), None if experts is None
                      else experts.clone()))
        return real(xs, wg, wu, wd, sizes, experts)

    monkeypatch.setattr(tmoe.ops, "moe_grouped_ffn", spy)
    p = types.SimpleNamespace(**tp)
    tmoe._moe_dropless(p, x, port_cfg(cfg), per_row=True)
    sizes, experts = calls[-1]
    E = cfg.n_experts
    assert torch.equal(experts, torch.arange(E, dtype=torch.int32).repeat(3))
    _, picks = tmoe.route_tokens(p.router, x.reshape(15, D), port_cfg(cfg))
    want = torch.stack([torch.bincount(picks.reshape(3, -1)[b].long(),
                                       minlength=E) for b in range(3)])
    assert sizes.dtype == torch.int32
    assert torch.equal(sizes.long(), want.reshape(-1))


# ----------------------------------------------------------- capacity
def drops_by_numpy(experts, k, E, cap):
    """The JAX rule restated: a pick's slot is the count of earlier picks
    of its expert in its row; it is dropped at slot >= cap."""
    out = 0
    for row in experts:
        seen = np.zeros(E, int)
        for e in row:
            out += seen[e] >= cap
            seen[e] += 1
    return out


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 1.25])
def test_capacity_matches_jax_and_drops(capacity_factor):
    cfg = jax_cfg(capacity_factor=capacity_factor)
    jp, tp = params(cfg, seed=8)
    x = inputs((2, 24, D), 9)
    pc = port_cfg(cfg)
    got = tmoe.moe(types.SimpleNamespace(**tp), torch.from_numpy(x), pc,
                   dispatch="capacity")
    want = jmoe.moe(jp, jnp.asarray(x), cfg, dispatch="capacity")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    _, je = jmoe.route_tokens(jp["router"], jnp.asarray(x.reshape(48, D)),
                              cfg)
    cap = jmoe._capacity(24, cfg)
    want_drops = drops_by_numpy(np.asarray(je).reshape(2, -1), 2, 8, cap)
    drops = tmoe.dropped_picks(torch.from_numpy(x), tp["router"], pc)
    assert drops == want_drops
    if capacity_factor < 1.25:
        assert drops > 0


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0])
def test_capacity_gradients_match_jax(capacity_factor):
    cfg = jax_cfg(capacity_factor=capacity_factor)
    jp, tp = params(cfg, seed=10)
    x = inputs((2, 16, D), 11)
    assert tmoe.dropped_picks(torch.from_numpy(x), tp["router"],
                              port_cfg(cfg)) > 0
    names, got, want = grads_both(
        lambda p, xx: jmoe.moe(p, xx, cfg, dispatch="capacity"),
        lambda p, xx: tmoe.moe(p, xx, port_cfg(cfg), dispatch="capacity"),
        jp, tp, x, 12)
    assert_leaves_close(names, got, want)


def test_capacity_backward_is_bitwise_reproducible():
    cfg = jax_cfg(capacity_factor=0.5)
    _, tp = params(cfg, seed=13)
    x = inputs((2, 16, D), 14)
    proj = inputs(x.shape, 15)
    runs = [port_grads(lambda p, xx: tmoe.moe(p, xx, port_cfg(cfg),
                                              dispatch="capacity"),
                       tp, x, proj) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


CAPACITY_SWEEP = [(tokens, k, n_experts, factor)
                  for tokens in (1, 3, 16, 24, 40, 64, 100)
                  for k, n_experts in ((1, 8), (2, 6), (2, 8), (8, 40))
                  for factor in (0.5, 0.75, 1.0, 1.25, 2.0)]


def test_capacity_and_padding_equal_the_reference_over_a_sweep():
    """``_capacity`` and ``_padded_capacity`` over a sweep, tp and ep (its
    padding experts never enter the budget), with cases where the
    capacity is a multiple of 8 (the padded buffer's last slot is live)."""
    multiples = 0
    for tokens, k, n_experts, factor in CAPACITY_SWEEP:
        for par in ("tp", "ep"):
            cfg = jmoe.MoEConfig(d_model=8, d_ff=8, n_experts=n_experts,
                                 top_k=k, capacity_factor=factor,
                                 parallelism=par, ep_axis_size=16)
            cap = tmoe._capacity(tokens, port_cfg(cfg))
            assert cap == jmoe._capacity(tokens, cfg)
            assert tmoe._padded_capacity(cap) == jmoe._padded_capacity(cap)
            multiples += cap % 8 == 0
    assert multiples > 0
    with pytest.raises(ValueError, match="capacity_factor"):
        tmoe._capacity(4, tmoe.MoEConfig(8, 8, 4, 2, capacity_factor=0.0))


def test_capacity_keeps_the_live_last_slot():
    """At a capacity that is a multiple of 8 the buffer's last slot C-1 is
    live, and the JAX scatter sends every dropped pick there with a zero
    update.  A dispatch that wrote (not added) dropped picks there would
    zero a kept token; the port's gather-built buffer holds it, and the
    layer equals the JAX one."""
    cfg = jax_cfg(capacity_factor=1.0)
    jp, tp = params(cfg, seed=16)
    pc = port_cfg(cfg)
    S = 32                                # cap = ceil(32 * 2 / 8) = 8 = C
    assert tmoe._capacity(S, pc) == tmoe._padded_capacity(8) == 8
    x = inputs((2, S, D), 17)
    p = types.SimpleNamespace(**tp)
    _, experts = tmoe.route_tokens(p.router, torch.from_numpy(
        x.reshape(2 * S, D)), pc)
    slots = tmoe._assign_slots(experts.reshape(2, S * 2), 8, 8, 8, 2)
    assert int((~slots.kept).sum()) > 0
    # An expert with drops has its last slot full, and the buffer's row
    # there is its token's.
    b, e = map(int, torch.nonzero(slots.full[:, :, 7])[0])
    buf = tmoe._CapacityDispatch.apply(torch.from_numpy(x), slots, 2)
    assert torch.equal(buf[b, e, 7], torch.from_numpy(x)[
        b, int(slots.token[b, e, 7])])
    got = tmoe.moe(p, torch.from_numpy(x), pc, dispatch="capacity")
    want = jmoe.moe(jp, jnp.asarray(x), cfg, dispatch="capacity")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_slot_assignment_is_a_bijection():
    """The kept picks and the full slots map onto each other: each kept
    pick's (expert, slot) holds that pick, and each full slot's pick is
    kept at that (expert, slot)."""
    rng = np.random.default_rng(18)
    B, S, k, E, cap = 3, 20, 2, 5, 6
    experts = torch.from_numpy(rng.integers(0, E, (B, S * k)))
    s = tmoe._assign_slots(experts, cap, 8, E, k)
    for b in range(B):
        seen = np.zeros(E, int)
        for i, e in enumerate(experts[b].tolist()):
            assert bool(s.kept[b, i]) == (seen[e] < cap)
            if seen[e] < cap:
                assert int(s.slot[b, i]) == seen[e]
                assert bool(s.full[b, e, seen[e]])
                assert int(s.pick[b, e, seen[e]]) == i
                assert int(s.token[b, e, seen[e]]) == i // k
            seen[e] += 1
        assert int(s.full[b].sum()) == int(np.minimum(seen, cap).sum())


@pytest.mark.parametrize("parallelism,n_experts", [("tp", 8), ("ep", 6)])
def test_single_token_capacity_equals_dropless(parallelism, n_experts):
    cfg = port_cfg(jax_cfg(parallelism, n_experts))
    _, tp = params(jax_cfg(parallelism, n_experts), seed=19)
    x = torch.from_numpy(inputs((5, 1, D), 20))
    p = types.SimpleNamespace(**tp)
    cap = tmoe.moe(p, x, cfg, dispatch="capacity")
    drop = tmoe.moe(p, x, cfg, dispatch="dropless")
    np.testing.assert_allclose(cap.numpy(), drop.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_capacity_budgets_over_live_experts():
    cfg = jmoe.MoEConfig(d_model=8, d_ff=8, n_experts=6, top_k=2,
                         parallelism="ep", ep_axis_size=4)
    pc = port_cfg(cfg)
    assert pc.padded_experts == 8
    assert tmoe._capacity(8, pc) == jmoe._capacity(8, cfg) == 3
    big = tmoe.MoEConfig(d_model=8, d_ff=8, n_experts=40, top_k=1,
                         parallelism="ep", ep_axis_size=16)
    assert big.padded_experts == 48 and tmoe._capacity(96, big) == 3


# ------------------------------------------------ the model and engine
def capacity_models():
    jcfg = dataclasses.replace(SMOKE, remat=False, dtype=jnp.float32,
                               moe_dispatch="capacity",
                               capacity_factor=0.5)
    jm = build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    m = Model(config_from_reference(jm.cfg), device="cpu")
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu"))
    return jm, jp, m


def test_capacity_model_logits_match_jax():
    """``Model`` with ``moe_dispatch="capacity"`` (capacity factor 0.5:
    its MoE layers drop picks) against the JAX model's logits."""
    jm, jp, m = capacity_models()
    assert m.moe_cfg.dispatch == "capacity"
    tokens = np.random.default_rng(21).integers(1, SMOKE.vocab, (2, 32))
    x, _ = jm._trunk(jp, {"tokens": jnp.asarray(tokens)})
    want = jlm_head(jp["head"], jrmsnorm(jp["final_ln"], x))
    with torch.no_grad():
        t = torch.from_numpy(tokens)
        got = project(norm(m.final_ln.scale, m(t)), m.head.w)
        h = norm(m.layers[0].ln2.scale, m.embed.tok[t.long()])
        assert tmoe.dropped_picks(h, m.layers[0].moe.router,
                                  m.moe_cfg) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_engine_serves_capacity_as_the_model_generates():
    """One request at a time (``max_batch=1``), prompts of a prefill
    bucket's length (a power of two of at least a page): the engine's
    prefill routes the prompt as ``Model.prefill`` does, and a decode row
    is one token (capacity ``top_k``, no drop), so the greedy streams are
    ``Model``'s own."""
    _, _, m = capacity_models()
    prompts = {0: list(range(3, 35)), 1: list(range(40, 56))}
    eng = Engine(m, ServeConfig(max_batch=1, page_size=4, hbm_pages=48,
                                host_pages=16))
    for rid, prompt in prompts.items():
        eng.add_request(rid, prompt, params=SamplingParams(max_tokens=5))
    while eng.requests:
        eng.step()
    for rid, prompt in prompts.items():
        cache = m.init_cache(1, len(prompt) + 8)
        logits, cache = m.prefill(torch.tensor([prompt]), cache)
        want = [int(logits.argmax(-1))]
        for i in range(4):
            logits, cache = m.decode(torch.tensor(want[-1:]), cache,
                                     len(prompt) + i)
            want.append(int(logits.argmax(-1)))
        assert eng.finished[rid].generated == want, rid
    with pytest.raises(ValueError, match="moe_dispatch is 'capacity'"):
        Engine(m, ServeConfig(expert_offchip=True))
