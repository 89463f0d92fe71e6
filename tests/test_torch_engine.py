"""The port's serving engine on ``llama3_2_1b`` SMOKE in f32 (and, where a
test says so, ``granite_moe_3b_a800m`` SMOKE), with the JAX package's
weights carried across by ``params_from_numpy``.

Across frameworks: greedy and sampled token streams equal the JAX
``Engine``'s, and logits agree within 1e-4 (the two frameworks sum in
different orders).  The JAX engine's pool is sized so that it never
migrates a page: its swap-in does not run on this tree's jax.

Within the port, bitwise: one-shot == chunked == interleaved prefill,
preemption by recompute == uninterrupted, a migration-heavy run == a
resident run, and the pool's round trips and transfer counts are exact.
Eviction ranks its victims exactly as the earlier scan-and-repeat
algorithm did."""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import SamplingParams as JSamplingParams  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    LLM,
    Engine,
    PagedKVPool,
    SamplingParams,
    ServeConfig,
)

PROMPTS = {0: [5, 17, 133, 42, 7, 99, 250, 3, 11, 29],
           1: [3, 1, 4, 1, 5, 9, 2, 6],
           2: [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9]}
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9)


DENSE, MOE = "llama3_2_1b", "granite_moe_3b_a800m"
# (arch, sampled) with the ids the dense cases had before MoE joined them.
ARCH_CASES = [pytest.param(DENSE, False, id="greedy"),
              pytest.param(DENSE, True, id="sampled"),
              pytest.param(MOE, False, id="moe-greedy"),
              pytest.param(MOE, True, id="moe-sampled")]


@functools.lru_cache(maxsize=None)
def models(arch):
    """(JAX model, its f32 params, the port's model with those weights)."""
    cfg = dataclasses.replace(get_smoke(arch), remat=False,
                              dtype=jnp.float32)
    model = build_model(cfg)
    # The JAX package declares its weights in bf16 whatever cfg.dtype is
    # (which sets the KV pool's type): run both sides in f32.
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          model.init(jax.random.PRNGKey(0)))
    m = Model(config_from_reference(model.cfg), device="cpu")
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu"))
    return model, params, m


@pytest.fixture(scope="module")
def port_model():
    return models(DENSE)[2]


def drive(eng, prompts, params):
    """Add every request, step to the end; per request the generated
    stream and the logits of each of its decode steps."""
    for rid, prompt in prompts.items():
        eng.add_request(rid, prompt, params=params[rid])
    logits = {rid: [] for rid in prompts}
    while eng.requests:
        eng.step()
        for rid, row in eng.last_logits.items():
            logits.setdefault(rid, []).append(np.array(row))
        eng.last_logits.clear()
    return ({rid: eng.finished[rid].generated for rid in prompts}, logits)


def both_params(max_tokens, sampled):
    """Per-request SamplingParams for each side; request 1 leaves its seed
    to the engine (derived from the request id)."""
    out = ({}, {})
    for rid in PROMPTS:
        kw = dict(max_tokens=max_tokens)
        if sampled:
            kw.update(SAMPLED, seed=None if rid == 1 else 100 + rid)
        out[0][rid] = JSamplingParams(**kw)
        out[1][rid] = SamplingParams(**kw)
    return out


@pytest.mark.parametrize("arch,sampled", ARCH_CASES)
def test_streams_and_logits_match_jax(arch, sampled):
    model, params, port_model = models(arch)
    kw = dict(max_batch=2, page_size=4, hbm_pages=48, host_pages=64,
              policy="gdt", interval_steps=4, keep_logits=True)
    jp, tp = both_params(6, sampled)
    jeng = JEngine(model, params, JServeConfig(**kw))
    want, want_logits = drive(jeng, PROMPTS, jp)
    assert jeng.pool.swaps_in == 0 and jeng.pool.swaps_out == 0
    teng = Engine(port_model, ServeConfig(**kw))
    got, got_logits = drive(teng, PROMPTS, tp)
    assert got == want
    for rid in PROMPTS:
        # The last step's row leaves with the finished request.
        assert len(got_logits[rid]) == len(want_logits[rid]) == 5
        np.testing.assert_allclose(np.stack(got_logits[rid]),
                                   np.stack(want_logits[rid]),
                                   atol=1e-4, rtol=1e-4)
    if sampled:
        greedy, _ = drive(Engine(port_model, ServeConfig(**kw)), PROMPTS,
                          both_params(6, False)[1])
        assert got != greedy, "sampled streams should differ from greedy"


def pages_bits(eng, rid):
    out = []
    for p in eng.pool.request_pages(rid):
        assert p.hbm_slot is not None
        out.append(eng.pool.k_hbm[:, p.hbm_slot].clone())
        out.append(eng.pool.v_hbm[:, p.hbm_slot].clone())
    return out


@pytest.mark.parametrize("arch,sampled", ARCH_CASES)
def test_one_shot_equals_chunked_equals_interleaved(arch, sampled):
    port_model = models(arch)[2]
    base = dict(max_batch=2, page_size=4, hbm_pages=48, host_pages=64,
                policy="gdt", interval_steps=4, keep_logits=True)
    modes = {"one_shot": dict(),
             "chunked": dict(prefill="chunked"),
             "interleaved": dict(prefill_chunk_tokens=4)}
    _, tp = both_params(5, sampled)
    runs = {}
    for name, extra in modes.items():
        eng = Engine(port_model, ServeConfig(**base, **extra))
        eng.add_request(0, PROMPTS[0], params=tp[0])
        while not eng.requests[0].generated:   # prefilled and one decode
            eng.step()
        bits = pages_bits(eng, 0)
        eng.last_logits.clear()
        streams, logits = drive(eng, {1: PROMPTS[1], 2: PROMPTS[2]}, tp)
        streams[0] = eng.finished[0].generated
        runs[name] = (bits, streams, logits, eng)
    assert runs["one_shot"][3].prefill_dispatches == 3
    assert runs["interleaved"][3].prefill_chunks > 3
    ref_bits, ref_streams, ref_logits, _ = runs["one_shot"]
    for name in ("chunked", "interleaved"):
        bits, streams, logits, _ = runs[name]
        assert all(torch.equal(a, b) for a, b in zip(bits, ref_bits)), name
        assert streams == ref_streams, name
        # The last rows are decode steps in every mode (the chunked oracle
        # also records rows while it steps a prompt through decode).
        for rid in (0, 1, 2):
            n = 2 if rid == 0 else 4
            assert len(logits[rid]) >= n and len(ref_logits[rid]) >= n
            assert all(np.array_equal(a, b) for a, b in
                       zip(logits[rid][-n:], ref_logits[rid][-n:])), name


@pytest.mark.parametrize("arch,sampled", ARCH_CASES)
def test_preempt_and_recompute_equals_uninterrupted(arch, sampled):
    port_model = models(arch)[2]
    prompt_a, prompt_b = [3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8, 1, 8]
    kw = dict(max_tokens=4)
    if sampled:
        kw.update(temperature=0.9, top_k=50, top_p=0.95, seed=123)
    sp = SamplingParams(**kw)
    twin = Engine(port_model, ServeConfig(max_batch=1, page_size=2,
                                          hbm_pages=16, host_pages=32))
    twin.add_request(0, prompt_a, params=sp)
    while 0 in twin.requests:
        twin.step()

    eng = Engine(port_model, ServeConfig(max_batch=1, page_size=2,
                                         hbm_pages=7, host_pages=1))
    eng.add_request(0, prompt_a, params=sp)
    eng.step()
    eng.pause(0)
    eng.add_request(1, prompt_b, max_new=2)       # forces full preemption
    assert eng.preemptions >= 1
    assert eng.requests[0].state == "preempted"
    assert not eng.pool.request_pages(0)
    while 1 in eng.requests:
        eng.step()
    eng.resume(0)
    while 0 in eng.requests:
        eng.step()
    assert eng.finished[0].generated == twin.finished[0].generated


def run_sessions(model, hbm_pages, policy="gdt"):
    """Three paused sessions and an active one; then the paused ones
    resume.  With few HBM pages their pages spill to the host tier and
    come back."""
    eng = Engine(model, ServeConfig(max_batch=2, page_size=4,
                                    hbm_pages=hbm_pages, host_pages=64,
                                    policy=policy, interval_steps=2,
                                    keep_logits=True))
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    for rid in range(3):
        eng.add_request(rid, prompt[rid:] + [rid],
                        params=SamplingParams(max_tokens=5, seed=rid,
                                              **(SAMPLED if rid else {})))
        eng.step()
        eng.pause(rid)
    logits = {rid: [] for rid in range(4)}

    def step():
        eng.step()
        for rid, row in eng.last_logits.items():
            logits[rid].append(np.array(row))
        eng.last_logits.clear()

    eng.add_request(3, prompt, max_new=6)
    while 3 in eng.requests:
        step()
    for rid in range(3):
        eng.resume(rid)
    while eng.requests:
        step()
    return ({rid: eng.finished[rid].generated for rid in range(4)}, logits,
            eng)


@pytest.mark.parametrize("policy", ["gdt", "lru", "fifo"])
def test_migration_heavy_run_equals_resident_run(port_model, policy):
    want, want_logits, resident = run_sessions(port_model, 64)
    got, got_logits, heavy = run_sessions(port_model, 11, policy)
    assert resident.pool.swaps_in == resident.pool.swaps_out == 0
    assert heavy.pool.swaps_out > 0 and heavy.pool.swaps_in > 0
    if policy == "gdt":
        assert heavy.runtime.history, "the runtime recorded intervals"
    else:
        assert heavy.runtime is None
    assert got == want
    for rid in want:
        assert len(got_logits[rid]) == len(want_logits[rid])
        assert all(np.array_equal(a, b) for a, b in
                   zip(got_logits[rid], want_logits[rid])), rid


@pytest.mark.parametrize("scheduler", ["priority", "drr"])
def test_scheduler_policies_change_when_not_which(port_model, scheduler):
    """A policy reorders admission and packing; every stream is the same
    as under fifo (sampling folds absolute positions)."""
    kw = dict(max_batch=2, page_size=4, hbm_pages=48, host_pages=64)
    _, tp = both_params(5, sampled=True)
    want, _ = drive(Engine(port_model, ServeConfig(**kw)), PROMPTS, tp)
    got, _ = drive(Engine(port_model, ServeConfig(scheduler=scheduler, **kw)),
                   PROMPTS, tp)
    assert got == want


def test_export_request_is_the_stream_identity(port_model):
    eng = Engine(port_model, ServeConfig(max_batch=2, page_size=4,
                                         hbm_pages=16, host_pages=16))
    sp = SamplingParams(max_tokens=4, seed=5, **SAMPLED)
    eng.add_request(3, PROMPTS[1], params=sp)
    eng.step()
    ticket = eng.export_request(3)
    assert (ticket.request_id, ticket.prompt, ticket.max_new,
            ticket.params) == (3, PROMPTS[1], 4, sp)
    assert ticket.generated == eng.requests[3].generated
    assert len(ticket.generated) == 1
    with pytest.raises(ValueError, match="unknown or finished"):
        eng.export_request(4)


def fill(pool, rng):
    pool.k_hbm.copy_(torch.from_numpy(
        rng.normal(size=tuple(pool.k_hbm.shape)).astype(np.float32)))
    pool.v_hbm.copy_(torch.from_numpy(
        rng.normal(size=tuple(pool.v_hbm.shape)).astype(np.float32)))


def page_data(pool, pid):
    p = pool.pages[pid]
    if p.hbm_slot is not None:
        k, v, slot = pool.k_hbm, pool.v_hbm, p.hbm_slot
    else:
        k, v, slot = pool.k_host, pool.v_host, p.host_slot
    return k[:, slot].clone(), v[:, slot].clone()


def test_pool_round_trip_and_transfer_events_exact():
    pool = PagedKVPool(n_layers=2, page_size=4, kv_heads=2, head_dim=8,
                       hbm_pages=8, host_pages=8, dtype=torch.float32,
                       device="cpu")
    pages = [pool.allocate(rid, idx, 0) for rid in (0, 1) for idx in range(3)]
    fill(pool, np.random.default_rng(0))
    before = {p.page_id: page_data(pool, p.page_id) for p in pages}
    ids = [p.page_id for p in pages]

    pool.swap_out_many(ids[:4] + ids[:2])          # duplicates dedupe
    assert pool.transfer_events == 2 and pool.swaps_out == 4
    assert all(pool.pages[i].hbm_slot is None for i in ids[:4])
    pool.swap_out_many([])                         # empty: no transfer
    assert pool.transfer_events == 2
    pool.swap_in_many(ids[:3])
    assert pool.transfer_events == 4 and pool.swaps_in == 3
    pool.exchange(ids[4:], [ids[3]])               # both directions
    assert pool.transfer_events == 8
    assert pool.bytes_moved == pool.page_bytes * (4 + 3 + 3)
    for pid in ids:
        k, v = page_data(pool, pid)
        assert torch.equal(k, before[pid][0])
        assert torch.equal(v, before[pid][1])

    export = pool.export_pages(ids[:3])
    assert export.fast == [True, True, True] and pool.exported_pages == 3
    other = PagedKVPool(n_layers=2, page_size=4, kv_heads=2, head_dim=8,
                        hbm_pages=2, host_pages=4, dtype=torch.float32,
                        device="cpu")
    landed = other.import_pages(export, 7, step=1)
    assert [p.index_in_seq for p in other.request_pages(7)] == [0, 1, 2]
    assert sum(p.hbm_slot is None for p in landed) == 1   # overflowed
    for src, dst in zip(ids[:3], landed):
        k, v = page_data(other, dst.page_id)
        assert torch.equal(k, before[src][0])
        assert torch.equal(v, before[src][1])

    copy = pool.copy_page(ids[0], 0, step=2)
    assert torch.equal(page_data(pool, copy.page_id)[0], before[ids[0]][0])
    assert ids[0] not in pool.pages               # the only reference moved
    assert pool.release_request(1) == ids[3:]
    with pytest.raises(ValueError, match="unknown or already-freed"):
        pool.free(ids[3])


def test_llm_generate_and_streaming(port_model):
    llm = LLM(port_model, ServeConfig(max_batch=2, page_size=4,
                                      hbm_pages=32, host_pages=32))
    outs = llm.generate([PROMPTS[0], PROMPTS[1]],
                        SamplingParams(max_tokens=3))
    assert [len(o.token_ids) for o in outs] == [3, 3]
    assert all(o.finish_reason == "length" for o in outs)
    h = llm.submit(PROMPTS[2], SamplingParams(max_tokens=4))
    deltas = list(h)
    assert [d[1] for d in deltas] == [None, None, None, "length"]
    assert h.result().token_ids == [d[0] for d in deltas]
    assert llm.stats()["finished_length"] == 3


def test_out_of_slice_options_raise(port_model):
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        Engine(port_model, ServeConfig(enable_prefix_cache=True))
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        Engine(port_model, ServeConfig(expert_offchip=True))
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        LLM(port_model, replicas=2)
    xlstm = config_from_reference(get_smoke("xlstm_350m"))
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        Model(xlstm, device="cpu")
    # The hybrid family is a Model now, but the paged engine serves decoder
    # LMs only, as the JAX engine asserts.
    hybrid = Model(config_from_reference(get_smoke("zamba2_7b")),
                   device="cpu")
    with pytest.raises(ValueError, match="paged engine serves decoder LMs"):
        Engine(hybrid, ServeConfig())
    capacity = dataclasses.replace(configs.get_smoke(MOE),
                                   moe_dispatch="capacity")
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        Model(capacity, device="cpu")


def test_pool_refcounts_and_copy_on_write():
    pool = PagedKVPool(n_layers=2, page_size=4, kv_heads=2, head_dim=8,
                       hbm_pages=6, host_pages=4, dtype=torch.float32,
                       device="cpu")
    fill(pool, np.random.default_rng(2))
    page = pool.allocate(0, 0, step=0)
    pool.attach(1, page.page_id, step=1)          # a second holder
    assert page.refcount == 2 and pool.holders(page.page_id) == [0, 1]
    with pytest.raises(ValueError, match="attach in order"):
        pool.attach(1, page.page_id, step=1)
    k0 = page_data(pool, page.page_id)[0]
    private = pool.copy_page(page.page_id, 1, step=2)
    assert page.refcount == 1 and private.refcount == 1
    assert private.hbm_slot != page.hbm_slot
    assert torch.equal(page_data(pool, private.page_id)[0], k0)
    pool.k_hbm[:, private.hbm_slot] += 1.0         # the writer's copy only
    assert torch.equal(page_data(pool, page.page_id)[0], k0)
    assert pool.release_request(0) == [page.page_id]
    assert pool.release_request(1) == [private.page_id]
    assert sorted(pool.free_hbm) == list(range(6)) and not pool.pages


def scan_holders(pool, page_id):
    """The holder scan eviction used before the pool kept an index."""
    return [rid for rid, seq in pool._seq.items()
            if any(p.page_id == page_id for p in seq)]


def repeated_pick_many(policy, candidates, engine, n):
    """The earlier eviction: ``min`` over the candidates per victim, with
    the holders found by scanning every sequence."""
    def recency(p):
        stamps = [engine.requests[rid].last_scheduled
                  for rid in scan_holders(engine.pool, p.page_id)
                  if rid in engine.requests]
        return max(stamps) if stamps else p.last_used

    def pick(cands):
        if policy == "fifo":
            return min(cands, key=lambda p: p.birth_step).page_id
        if policy == "gdt" and engine.last_recs:
            cold = [p for p in cands
                    if not engine.last_recs.get(p.page_id, False)]
            cands = cold or cands
        return min(cands, key=recency).page_id

    pool, victims = list(candidates), []
    while len(victims) < n and pool:
        vid = pick(pool)
        victims.append(vid)
        pool = [p for p in pool if p.page_id != vid]
    return victims


def random_pool(rng):
    """Requests allocating, sharing (attach), copying on write, releasing
    and coming back, with random clocks; some pages on the host tier."""
    pool = PagedKVPool(n_layers=1, page_size=2, kv_heads=1, head_dim=2,
                       hbm_pages=64, host_pages=64, dtype=torch.float32,
                       device="cpu")
    rids = [int(r) for r in rng.permutation(8)]
    for rid in rids:
        donor = pool.request_pages(int(rng.choice(rids)))
        n_shared = int(rng.integers(0, len(donor) + 1)) if donor else 0
        for p in donor[:n_shared]:
            pool.attach(rid, p.page_id, step=int(rng.integers(0, 50)))
        for idx in range(n_shared, n_shared + int(rng.integers(1, 5))):
            pool.allocate(rid, idx, step=int(rng.integers(0, 50)))
    for rid in rng.choice(rids, 2, replace=False):
        shared = [p for p in pool.request_pages(int(rid)) if p.refcount > 1]
        if shared:
            pool.copy_page(shared[0].page_id, int(rid), step=60)
    back = int(rng.choice(rids))
    pool.release_request(back)                     # re-enters last
    pool.allocate(back, 0, step=70)
    pool.swap_out_many([pid for pid in pool.pages if rng.random() < 0.2])
    for p in pool.pages.values():
        p.last_used = int(rng.integers(0, 80))
    return pool, rids


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("policy", ["gdt", "lru", "fifo"])
def test_eviction_victims_equal_the_scan_and_repeat_algorithm(seed, policy):
    from repro_torch.serve.eviction import make_eviction_policy

    rng = np.random.default_rng(seed)
    pool, rids = random_pool(rng)
    assert any(p.refcount > 1 for p in pool.pages.values())
    for pid in pool.pages:
        assert pool.holders(pid) == scan_holders(pool, pid), pid
    live = [r for r in rids if rng.random() < 0.7]
    recs = {} if seed % 3 == 0 else {
        pid: bool(rng.random() < 0.5) for pid in pool.pages
        if rng.random() < 0.8}
    engine = types.SimpleNamespace(
        pool=pool, last_recs=recs,
        requests={rid: types.SimpleNamespace(
            last_scheduled=int(rng.integers(0, 5))) for rid in live})
    cands = [p for p in pool.pages.values() if p.hbm_slot is not None]
    rng.shuffle(cands)
    evict = make_eviction_policy(policy)
    for n in (1, 3, len(cands) // 2, len(cands) + 2):
        want = repeated_pick_many(policy, cands, engine, n)
        assert evict.pick_many(cands, engine, n) == want, n
    assert evict.pick_many([], engine, 3) == []
