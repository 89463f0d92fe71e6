"""The port's tiered expert store (``repro_torch.serve.expert_store``) on the
CPU, against the JAX package's and through ``LLM.generate``.

Across frameworks: the same dispatch, prefetch and controller sequence
through both stores gives the same slot maps, LRU victims, prefetch hits,
counters and modeled clocks (the reference store is given the port's H100
model, and its host tier is put on the device: its host-tier gather does
not run on this tree's jax, ROADMAP queue C); the port's greedy and
sampled streams equal the JAX tiered engine's in f32, logits within 1e-4.

Within the port, bitwise: tiered == resident across cache sizes, double
buffering on == off, chunked prefill through a tight cache, preemption
replay; an overflowing working set raises ``ExpertCacheMissError`` naming
``expert_cache_size``; the controllers tick KV -> prefix -> expert.  The
plain grouped FFN gives NaN rows for a group whose slot is -1, and an
``apply_dropless_flat`` call leaves every live row unchanged when masked
rows hit such slots."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.core import hwmodel as jhw  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serve import LLM as JLLM  # noqa: E402
from repro.serve import SamplingParams as JSamplingParams  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import expert_store as jes  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
)
from repro_torch.core import h100  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.moe import (  # noqa: E402
    MoEConfig,
    apply_dropless_flat,
    route_tokens,
)
from repro_torch.serve import (  # noqa: E402
    LLM,
    Engine,
    ExpertCacheMissError,
    ExpertStore,
    SamplingParams,
    ServeConfig,
)

# ============================================================ store level
L, E, D, F = 2, 4, 4, 4
NAMES = ("w_gate", "w_up", "w_down")


def jax_hw():
    """The port's H100 model as the reference package's dataclass."""
    hw = h100()
    tier = lambda t: jhw.TierSpec(**dataclasses.asdict(t))   # noqa: E731
    fields = {f.name: getattr(hw, f.name)
              for f in dataclasses.fields(hw)}
    fields.update(fast=tier(hw.fast), slow=tier(hw.slow))
    return jhw.HardwareModel(**fields)


def device_host_tier(store):
    """Put a reference store's host tier on the device sharding (its
    pinned-host gather is the reference fault of ROADMAP queue C)."""
    for name in NAMES:
        setattr(store, name + "_host", jax.device_put(
            getattr(store, name + "_host"), store._dev_sharding))


def weights(seed=0):
    rng = np.random.default_rng(seed)
    return {"w_gate": rng.normal(size=(L, E, D, F)).astype(np.float32),
            "w_up": rng.normal(size=(L, E, D, F)).astype(np.float32),
            "w_down": rng.normal(size=(L, E, F, D)).astype(np.float32)}


def make_store(cache_slots, double_buffer=False):
    w = weights()
    return w, ExpertStore({k: torch.from_numpy(v) for k, v in w.items()},
                          L, E, cache_slots, double_buffer=double_buffer,
                          hw=h100(), device="cpu")


def both_stores(cache_slots, double_buffer):
    w = weights()
    port = ExpertStore({k: torch.from_numpy(v) for k, v in w.items()},
                       L, E, cache_slots, double_buffer=double_buffer,
                       hw=h100(), window_bytes=4096, device="cpu")
    ref_store = jes.ExpertStore({k: jnp.asarray(v) for k, v in w.items()},
                                L, E, cache_slots,
                                double_buffer=double_buffer, hw=jax_hw(),
                                window_bytes=4096)
    device_host_tier(ref_store)
    return w, port, ref_store


def counts(*experts):
    c = np.zeros(E, dtype=np.int64)
    for e in experts:
        c[e] += 1
    return c


def state(st):
    return dict(
        slots={k: b.slot for k, b in st.blocks.items()},
        last_used={k: b.last_used for k, b in st.blocks.items()},
        accesses={k: b.accesses for k, b in st.blocks.items()},
        fetches={k: b.fetches for k, b in st.blocks.items()},
        free=list(st._free), reserved=sorted(st._reserved),
        pinned=sorted(st._pinned), pending=sorted(st._pending),
        counters=(st.demand_fetches, st.prefetch_fetches, st.prefetch_hits,
                  st.dropped_prefetches, st.evictions, st.bytes_fetched,
                  st.transfer_events, st.m_compute_s, st.m_blocked_s),
        resident=st.resident_count(), fast=st.fast_resident_bytes())


def cache_rows(st, is_ref):
    out = {}
    for name in NAMES:
        rows = np.asarray(getattr(st, name + "_cache"))
        out[name] = {k: rows[b.slot].copy() for k, b in st.blocks.items()
                     if b.slot is not None}
    return out


@pytest.mark.parametrize("cache_slots", [2, 4, 6])
@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_store_sequences_equal_the_reference(cache_slots, double_buffer,
                                             seed):
    """A random sequence of dispatches, forecasts, recency prefetches and
    controller moves: slot maps, errors, every block's tier state, the
    counters and modeled clocks equal the reference store's, and the cache
    rows hold the host blocks bitwise."""
    w, port, ref_store = both_stores(cache_slots, double_buffer)
    rng = np.random.default_rng(seed)
    for step in range(1, 30):
        layer = int(rng.integers(L))
        op = rng.random()
        if op < 0.55:
            need = rng.choice(E, size=int(rng.integers(1, E + 1)),
                              replace=False)
            c = np.zeros(E, dtype=np.int64)
            c[need] = rng.integers(1, 4, size=len(need))
            out = []
            for st in (port, ref_store):
                try:
                    out.append(("ok", st.dispatch(layer, c, step).tolist()))
                except (ExpertCacheMissError,
                        jes.ExpertCacheMissError) as err:
                    out.append(("miss", str(err)))
            assert out[0] == out[1]
            assert port.take_rental_bytes() == ref_store.take_rental_bytes()
        elif op < 0.8:
            predicted = (None if rng.random() < 0.3 else
                         rng.permutation(E)[:int(rng.integers(1, E + 1))]
                         .tolist())
            assert port.prefetch(layer, step, predicted) == \
                ref_store.prefetch(layer, step, predicted)
        elif op < 0.9:
            pairs = [(int(rng.integers(L)), int(rng.integers(E)))
                     for _ in range(3)]
            assert port.drop_many(pairs) == ref_store.drop_many(pairs)
        else:
            pairs = [(int(rng.integers(L)), int(rng.integers(E)))
                     for _ in range(2)]
            assert port.fetch_many(pairs, step) == \
                ref_store.fetch_many(pairs, step)
        assert state(port) == state(ref_store)
    got, want = cache_rows(port, False), cache_rows(ref_store, True)
    for name in NAMES:
        assert got[name].keys() == want[name].keys()
        for (l, e), row in got[name].items():
            assert np.array_equal(row, w[name][l, e])
            assert np.array_equal(row, want[name][(l, e)])


def test_store_rejects_zero_slots():
    with pytest.raises(ValueError, match="expert_cache_size"):
        make_store(0)


def test_dispatch_installs_and_maps_slots():
    w, st = make_store(4)
    slot_map = st.dispatch(0, counts(0, 2), step=1)
    assert st.is_resident(0, 0) and st.is_resident(0, 2)
    assert slot_map[1] == -1 and slot_map[3] == -1
    assert st.demand_fetches == 2
    cache = st.w_gate_cache.numpy()
    assert np.array_equal(cache[slot_map[0]], w["w_gate"][0, 0])
    assert np.array_equal(cache[slot_map[2]], w["w_gate"][0, 2])


def test_lru_eviction_prefers_oldest():
    _, st = make_store(2)
    st.dispatch(0, counts(0, 1), step=1)
    st.dispatch(0, counts(1), step=2)          # refresh (0,1): (0,0) is LRU
    st.dispatch(1, counts(3), step=3)          # needs a slot: evict (0,0)
    assert not st.is_resident(0, 0)
    assert st.is_resident(0, 1) and st.is_resident(1, 3)
    assert st.evictions == 1


def test_working_set_overflow_raises_named_error():
    _, st = make_store(2)
    with pytest.raises(ExpertCacheMissError, match="expert_cache_size"):
        st.dispatch(0, counts(0, 1, 2), step=1)


def test_prefetch_hits_pins_and_sync_mode():
    _, st = make_store(4, double_buffer=True)
    st.dispatch(0, counts(0, 1), step=1)
    assert st.prefetch(1, step=1, predicted=[0, 1]) == 2
    st.dispatch(1, counts(0, 2), step=1)
    assert (st.prefetch_fetches, st.prefetch_hits, st.demand_fetches) == \
        (2, 1, 3)
    _, st = make_store(2, double_buffer=True)
    st.dispatch(0, counts(0, 1), step=1)       # both slots pinned
    assert st.prefetch(1, step=1, predicted=[2, 3]) == 0
    assert st.dropped_prefetches == 2
    _, st = make_store(4, double_buffer=False)
    st.dispatch(0, counts(0), step=1)
    assert st.prefetch(1, step=1, predicted=[0, 1]) == 0
    assert not st.can_prefetch(1)


def test_controller_moves_and_refetch_are_bitwise():
    w, st = make_store(4)
    st.dispatch(0, counts(0, 1), step=1)
    st.fetch_many([(1, 3)], step=1)
    assert st.drop_many([(0, 0), (1, 3)]) == [(1, 3)]
    _, full = make_store(2)
    full.dispatch(0, counts(0, 1), step=1)
    assert full.fetch_many([(1, 2)], step=2) == ([], [(1, 2)])
    m0 = st.dispatch(0, counts(0), step=2)
    first = st.w_down_cache[m0[0]].clone()
    _, small = make_store(2)
    m = small.dispatch(0, counts(0), step=1)
    small.dispatch(1, counts(1, 2), step=2)    # evicts (0, 0)
    m = small.dispatch(0, counts(0), step=3)   # refetch from the host tier
    assert torch.equal(small.w_down_cache[m[0]], first)
    assert np.array_equal(first.numpy(), w["w_down"][0, 0])


# ================================================== -1 slots, the satellite
def test_plain_grouped_ffn_gives_nan_rows_for_out_of_range_experts():
    """A group whose weight row is -1 (or past the array) gets NaN rows,
    as the kernel does; it no longer wraps to the last weight row."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((12, 32), generator=g)
    w = [torch.randn(s, generator=g) for s in ((3, 32, 16), (3, 32, 16),
                                               (3, 16, 32))]
    sizes = torch.tensor([4, 0, 3, 5], dtype=torch.int32)
    good = ref.moe_grouped_ffn_reference(
        x, *w, sizes, torch.tensor([0, 1, 2, 1], dtype=torch.int32))
    for bad in ([0, 1, -1, 1], [0, 1, 3, 1]):
        got = ref.moe_grouped_ffn_reference(
            x, *w, sizes, torch.tensor(bad, dtype=torch.int32))
        assert torch.isnan(got[4:7]).all()
        assert torch.equal(got[:4], good[:4])
        assert torch.equal(got[7:], good[7:])
    wrapped = ref.moe_grouped_ffn_reference(
        x, *w, sizes, torch.tensor([0, 1, 2, 1], dtype=torch.int32))
    assert torch.isfinite(wrapped).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropless_live_rows_unchanged_by_minus_one_slots(dtype):
    """Masked rows routed to experts absent from a cache (slot -1) leave
    every live row of ``apply_dropless_flat`` bitwise unchanged; their own
    rows are NaN (the engine masks them to zero)."""
    cfg = MoEConfig(d_model=32, d_ff=16, n_experts=6, top_k=2)
    g = torch.Generator().manual_seed(1)
    R = 10
    x = torch.randn((1, R, 32), generator=g).to(dtype)
    router = torch.randn((32, 6), generator=g)
    w = [torch.randn(s, generator=g).to(dtype)
         for s in ((6, 32, 16), (6, 32, 16), (6, 16, 32))]
    gates, experts = route_tokens(router, x[0], cfg)
    live = torch.arange(R) < 6
    picks = experts[live].unique().tolist()
    # A 9-row cache holding the live rows' experts at scattered rows.
    rows = torch.randperm(9, generator=g)[:6]
    cache = [torch.randn((9,) + t.shape[1:], generator=g).to(dtype)
             for t in w]
    slots = torch.full((6,), -1, dtype=torch.int32)
    for e in picks:
        for c, t in zip(cache, w):
            c[rows[e]] = t[e]
        slots[e] = rows[e]
    resident = apply_dropless_flat(gates, experts, x, *w, cfg)[0]
    tiered = apply_dropless_flat(gates, experts, x, *cache, cfg,
                                 expert_slots=slots)[0]
    assert torch.equal(tiered[live], resident[live])
    dead = [r for r in range(R) if not set(experts[r].tolist()) <= set(picks)]
    assert dead and torch.isnan(tiered[dead].float()).any(dim=-1).all()
    masked = torch.where(live[:, None], tiered, 0)
    assert torch.isfinite(masked.float()).all()


# ========================================================= engine level
@pytest.fixture(scope="module")
def moe():
    """(JAX model, its f32 params, the port's model with those weights)."""
    cfg = dataclasses.replace(get_smoke("granite_moe_3b_a800m"),
                              remat=False, dtype=jnp.float32)
    model = build_model(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          model.init(jax.random.PRNGKey(0)))
    m = Model(config_from_reference(model.cfg), device="cpu")
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu"))
    return model, params, m


CFG = dict(max_batch=2, page_size=4, hbm_pages=32, host_pages=64,
           max_pages_per_seq=16, interval_steps=4, keep_logits=True)
PROMPTS = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8], [1, 6, 1, 8, 0, 3]]
PLIST = [dict(max_tokens=6),
         dict(max_tokens=6, temperature=0.8, top_k=4, seed=7),
         dict(max_tokens=6, temperature=1.1, top_p=0.9, seed=3)]


def make_llm(m, **kw):
    return LLM(m, ServeConfig(**CFG, **kw))


def drive(llm, prompts, plist, sp=SamplingParams):
    handles = [llm.submit(p, sp(**kw)) for p, kw in zip(prompts, plist)]
    logits = {h.request_id: [] for h in handles}
    while any(not h.finished for h in handles):
        out = llm.step()
        for rid in out:
            if rid in llm.engine.last_logits:
                logits[rid].append(llm.engine.last_logits[rid].copy())
    return [h.result() for h in handles], logits


def assert_equal_runs(a, b):
    (outs_a, logits_a), (outs_b, logits_b) = a, b
    assert [o.token_ids for o in outs_a] == [o.token_ids for o in outs_b]
    for rid in logits_a:
        assert len(logits_a[rid]) == len(logits_b[rid])
        assert all(np.array_equal(x, y)
                   for x, y in zip(logits_a[rid], logits_b[rid])), rid


@pytest.fixture(scope="module")
def resident(moe):
    return drive(make_llm(moe[2]), PROMPTS, PLIST)


@pytest.mark.parametrize("cache,extra", [
    pytest.param(8, {}, id="cache8"),
    pytest.param(12, {}, id="cache12"),
    pytest.param(16, {}, id="cache16"),
    pytest.param(8, {"expert_double_buffer": False}, id="cache8-sync"),
    pytest.param(12, {"expert_double_buffer": False}, id="cache12-sync"),
    pytest.param(4, {"prefill_chunk_tokens": 2}, id="cache4-chunked"),
    pytest.param(8, {"prefill": "chunked"}, id="cache8-chunked-oracle"),
    pytest.param(8, {"enable_prefix_cache": True}, id="cache8-prefix"),
])
def test_tiered_equals_resident_bitwise(moe, resident, cache, extra):
    """Streams and logits through the expert cache equal the resident
    path's bitwise, from all-fit (16 of 16 blocks) to heavy churn, with
    double buffering on or off, through chunked prefill at the decode
    floor, and beside the prefix cache."""
    llm = make_llm(moe[2], expert_offchip=True, expert_cache_size=cache,
                   **extra)
    assert_equal_runs(resident, drive(llm, PROMPTS, PLIST))
    st = llm.stats()
    assert st["expert_cache_slots"] == cache
    assert st["expert_demand_fetches"] > 0 and st["expert_bytes_fetched"]
    assert st["expert_host_syncs"] > 0
    if cache < 16:
        assert st["expert_evictions"] > 0
    if extra.get("expert_double_buffer", True):
        assert st["expert_prefetch_hits"] > 0
    else:
        assert st["expert_prefetch_fetches"] == 0


def test_engine_moves_expert_weights_into_the_host_tier(moe):
    m = Model(moe[2].cfg, device="cpu")
    m.load_state_dict(moe[2].state_dict())
    before = [lp.moe.w_up.clone() for lp in m.layers]
    eng = Engine(m, ServeConfig(**CFG, expert_offchip=True,
                                expert_cache_size=8))
    host = eng.expert_store.w_up_host
    for l, lp in enumerate(m.layers):
        assert torch.equal(lp.moe.w_up, before[l])
        assert lp.moe.w_up.untyped_storage().data_ptr() == \
            host.untyped_storage().data_ptr()


def test_preemption_replay_through_tiered_path(moe):
    def run(preempt):
        llm = make_llm(moe[2], expert_offchip=True, expert_cache_size=8)
        llm.submit(PROMPTS[0], SamplingParams(max_tokens=1)).result()
        h = llm.submit(PROMPTS[1], SamplingParams(
            max_tokens=8, temperature=0.9, seed=11))
        for _ in range(3):
            llm.step()
        if preempt:
            llm.pause(h.request_id)
            assert llm.engine._preempt_one()
            llm.resume(h.request_id)
        return h.result().token_ids, llm.stats()

    calm, _ = run(preempt=False)
    replayed, stats = run(preempt=True)
    assert replayed == calm and stats["preemptions"] >= 1


def test_one_shot_overflow_raises_named_error(moe):
    llm = make_llm(moe[2], expert_offchip=True, expert_cache_size=4)
    with pytest.raises(ExpertCacheMissError, match="expert_cache_size"):
        llm.submit(list(range(1, 13)), SamplingParams(max_tokens=2))
        for _ in range(4):
            llm.step()


def test_init_validation_names_knobs(moe):
    for size in (2, -1):
        with pytest.raises(ValueError, match="expert_cache_size"):
            make_llm(moe[2], expert_offchip=True, expert_cache_size=size)
    dense = Model(config_from_reference(dataclasses.replace(
        get_smoke("llama3_2_1b"), remat=False)), device="cpu")
    with pytest.raises(ValueError, match="expert_offchip requires a MoE"):
        Engine(dense, ServeConfig(expert_offchip=True))


def test_controller_tick_order_is_pinned(moe):
    """KV pages, shared prefixes, expert weights: once a step each, in
    that order."""
    eng = Engine(moe[2], ServeConfig(
        max_batch=2, page_size=4, hbm_pages=24, host_pages=64,
        policy="gdt", interval_steps=4, enable_prefix_cache=True,
        expert_offchip=True, expert_cache_size=8))
    ticked = []
    for name, rt in (("paged_kv", eng.runtime),
                     ("prefix", eng.prefix_runtime),
                     ("expert", eng.expert_runtime)):
        assert rt is not None

        def record(orig=rt.on_step, name=name):
            ticked.append(name)
            return orig()

        rt.on_step = record
    eng.add_request(0, [3, 1, 4, 1, 5, 9], max_new=6)
    n_steps = 0
    while eng.requests:
        eng.step()
        n_steps += 1
    assert n_steps >= 3
    assert ticked == ["paged_kv", "prefix", "expert"] * n_steps
    assert eng.expert_runtime.history, "the expert controller ran"


@pytest.mark.parametrize("double_buffer", [False, True])
def test_tiered_streams_match_jax(moe, double_buffer):
    """Port vs the JAX tiered engine in f32: equal streams, logits within
    1e-4; with double buffering off (and no controller) the demand
    fetches, evictions and bytes equal the reference's too."""
    model, params, m = moe
    kw = dict(CFG, policy="lru", expert_offchip=True, expert_cache_size=8,
              expert_double_buffer=double_buffer)
    jllm = JLLM(model, params, JServeConfig(**kw))
    device_host_tier(jllm.engine.expert_store)
    want = drive(jllm, PROMPTS, PLIST, JSamplingParams)
    assert jllm.engine.pool.swaps_in == 0
    llm = LLM(m, ServeConfig(**kw))
    got = drive(llm, PROMPTS, PLIST)
    assert [o.token_ids for o in got[0]] == [o.token_ids for o in want[0]]
    for rid in want[1]:
        np.testing.assert_allclose(np.stack(got[1][rid]),
                                   np.stack(want[1][rid]),
                                   atol=1e-4, rtol=1e-4)
    if not double_buffer:
        for key in ("expert_demand_fetches", "expert_evictions",
                    "expert_bytes_fetched", "expert_transfer_events"):
            assert llm.stats()[key] == jllm.engine.stats()[key], key
