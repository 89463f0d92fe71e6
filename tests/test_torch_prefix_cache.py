"""The port's shared-prefix cache (``repro_torch.serve.prefix_cache``) on the
CPU, against the JAX package's and through ``LLM.generate``.

Across frameworks: chain hashes, and the node sets, hit counters and
reclaim victims of ``match``/``insert``/``reclaim`` equal
``repro.serve.prefix_cache``'s on the same token sequences (the two pools
hand out the same page ids); the engine's greedy streams equal the JAX
engine's in f32 with the cache on (the JAX pool is sized so that it never
swaps a page in: its swap-in does not run on this tree's jax), and logits
agree within 1e-4.

Within the port, bitwise: cached == uncached with one-shot, chunked and
interleaved prefill, a full hit (which dispatches nothing) and preemption
replay through a hit.  Also the pool's shared references, the
``PrefixBackend``'s enforcement, and shared pages never appearing in the
per-request ``PagedKVBackend``'s profile."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serve import LLM as JLLM  # noqa: E402
from repro.serve import SamplingParams as JSamplingParams  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro.serve import prefix_cache as jpc  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
)
from repro_torch.core import MigrationPlan  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    LLM,
    PagedKVPool,
    PrefixBackend,
    PrefixCache,
    SamplingParams,
    ServeConfig,
    block_hash,
)

SHARED = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]    # 3 full pages of 4


# ============================================================ pool fixtures
def small_pool(hbm=8, host=16):
    return PagedKVPool(n_layers=2, page_size=4, kv_heads=2, head_dim=8,
                       hbm_pages=hbm, host_pages=host, dtype=torch.float32,
                       device="cpu")


def jax_pool(hbm=8, host=16):
    return jkv.PagedKVPool(n_layers=2, page_size=4, kv_heads=2, head_dim=8,
                           hbm_pages=hbm, host_pages=host, dtype=jnp.float32)


def full_pages(pool, rid, n, step=0):
    """Allocate ``n`` FULL pages (the only shareable kind) for ``rid``."""
    pages = [pool.allocate(rid, i, step) for i in range(n)]
    for p in pages:
        p.tokens_used = pool.page_size
    return pages


# ================================================== the pool's references
def test_free_is_refcount_decrement_and_acquire_marks_shared():
    pool = small_pool()
    page = pool.allocate(0, 0, step=0)
    assert not page.shared
    pool.acquire(page.page_id, shared=True)
    assert page.shared and page.refcount == 2
    free_before = len(pool.free_hbm)
    pool.free(page.page_id)                 # the cache's ref survives
    assert page.page_id in pool.pages
    assert len(pool.free_hbm) == free_before
    pool.free(page.page_id)                 # last ref: the slot returns
    assert page.page_id not in pool.pages
    assert len(pool.free_hbm) == free_before + 1
    with pytest.raises(ValueError, match="refcount reaches zero"):
        pool.free(page.page_id)


def test_release_request_returns_only_dead_pages():
    pool = small_pool()
    pages = full_pages(pool, 0, 3)
    pool.acquire(pages[0].page_id, shared=True)   # the cache holds page 0
    assert pool.release_request(0) == [pages[1].page_id, pages[2].page_id]
    assert pages[0].page_id in pool.pages
    assert pool.request_pages(0) == []


# ============================================= the radix cache against JAX
@pytest.mark.parametrize("blocks", [
    [(1, 2, 3, 4)],
    [(1, 2, 3, 4), (5, 6, 7, 8)],
    [(9, 2, 3, 4), (5, 6, 7, 8), (0, 0, 0, 0)],
    [(49154, 7, 12, 3), (1, 1, 1, 1)],
])
def test_block_hash_chains_equal_the_reference(blocks):
    key, jkey = b"", b""
    for block in blocks:
        key = block_hash(key, block)
        jkey = jpc.block_hash(jkey, block)
        assert key == jkey
    # The chain commits to the left context.
    assert block_hash(b"", blocks[-1]) != key or len(blocks) == 1


def node_set(cache):
    return sorted((n.page_id, n.depth, n.key, n.tokens,
                   None if n.parent is None else n.parent.page_id,
                   n.hits, n.last_hit_step)
                  for n in cache.nodes())


def counters(cache):
    return (cache.lookups, cache.hit_requests, cache.hit_pages,
            cache.inserted_pages, cache.evicted_pages, len(cache),
            cache.hit_rate)


def both_caches(min_pages=1):
    pools = (small_pool(hbm=16), jax_pool(hbm=16))
    return pools, tuple(mod(pool, page_size=4, min_pages=min_pages)
                        for mod, pool in zip((PrefixCache, jpc.PrefixCache),
                                             pools))


def check_same(caches, pools):
    port, ref = caches
    assert node_set(port) == node_set(ref)
    assert counters(port) == counters(ref)
    assert sorted(n.page_id for n in port.evictable()) == \
        sorted(n.page_id for n in ref.evictable())
    for pid, page in pools[1].pages.items():
        p = pools[0].pages[pid]
        assert (p.refcount, p.shared, p.accesses, p.last_used) == \
            (page.refcount, page.shared, page.accesses, page.last_used)


@pytest.mark.parametrize("min_pages", [1, 2])
def test_match_insert_reclaim_equal_the_reference(min_pages):
    """The same token sequences through both caches: every node (page,
    depth, chain key, parent, hits), counter, evictable set and reclaim
    victim order is the reference's."""
    pools, caches = both_caches(min_pages)
    prompts = [SHARED + [20, 21, 22, 23],           # 4 full pages
               SHARED[:8] + [7, 7, 7, 7, 1],        # diverges at page 2
               SHARED + [20, 21, 22, 23, 9],        # a full 4-page hit
               [5] * 6,                              # 1 full page
               SHARED[:4]]                           # 1 page, hits root
    for rid, prompt in enumerate(prompts):
        chains = [c.match(prompt, step=rid) for c in caches]
        assert [[n.page_id for n in ch] for ch in chains][0] == \
            [n.page_id for n in chains[1]]
        n_full = len(prompt) // 4
        for pool, cache, chain in zip(pools, caches, chains):
            for node in chain:
                pool.attach(rid, node.page_id, step=rid)
            fresh = [pool.allocate(rid, i, rid)
                     for i in range(len(chain), n_full)]
            for p in fresh:
                p.tokens_used = 4
            cache.insert(prompt, pool.request_pages(rid), limit=len(prompt),
                         step=rid, chain=chain)
        check_same(caches, pools)
    for rid in (0, 2, 3):                    # requests finish
        for pool in pools:
            pool.release_request(rid)
    check_same(caches, pools)
    for n in (1, 2, 10):
        victims = []
        for cache in caches:
            before = {node.page_id for node in cache.nodes()}
            assert cache.reclaim(n) == len(before) - len(cache)
            victims.append(before - {node.page_id for node in cache.nodes()})
        assert victims[0] == victims[1]
        check_same(caches, pools)
    assert caches[0].reclaim(1) == 0          # what is left is held


def test_reclaim_drops_coldest_leaf_and_cascades():
    pool = small_pool()
    cache = PrefixCache(pool, page_size=4)
    tokens = list(range(1, 13))
    pages = full_pages(pool, 0, 3)
    cache.insert(tokens, pages, limit=12, step=0)
    pool.release_request(0)                     # cache-only references now
    pool.attach(1, pages[0].page_id, step=1)    # a live holder pins page 0
    assert {n.depth for n in cache.evictable()} == {2}
    assert cache.reclaim(3) == 2
    assert len(cache) == 1 and cache.evicted_pages == 2
    assert pages[0].page_id in pool.pages
    assert cache.reclaim(1) == 0
    with pytest.raises(ValueError, match="cached children"):
        cache2 = PrefixCache(small_pool(), page_size=4)
        ps = full_pages(cache2.pool, 0, 2)
        cache2.insert(tokens[:8], ps, limit=8, step=0)
        cache2.release(cache2.by_page[ps[0].page_id])
    with pytest.raises(ValueError, match="min_prefix_pages"):
        PrefixCache(pool, page_size=4, min_pages=0)


# ============================================================ the backend
def make_plan(placement):
    return MigrationPlan(
        profile=None, exploded=None, fragments=[], assignment=None,
        decision=None, fractions={}, chunk_placement=placement,
        capacity_bytes=0, strategy="thermos")


def seeded_cache():
    pool = small_pool(hbm=6, host=8)
    cache = PrefixCache(pool, page_size=4)
    tokens = list(range(1, 13))
    pages = full_pages(pool, 0, 3)
    g = torch.Generator().manual_seed(0)
    pool.k_hbm.copy_(torch.randn(pool.k_hbm.shape, generator=g))
    pool.v_hbm.copy_(torch.randn(pool.v_hbm.shape, generator=g))
    cache.insert(tokens, pages, limit=12, step=0)
    pool.release_request(0)
    return pool, cache, tokens, pages


def test_prefix_backend_enforce_demotes_and_promotes_bitwise():
    pool, cache, tokens, pages = seeded_cache()
    backend = PrefixBackend(cache, clock=lambda: 0)
    ids = [p.page_id for p in pages]
    before = [pool.k_hbm[:, pool.pages[i].hbm_slot].clone() for i in ids]
    stats = backend.enforce(make_plan({pid: False for pid in ids}))
    assert all(pool.pages[pid].hbm_slot is None for pid in ids)
    assert stats.bytes_demoted == 3 * pool.page_bytes
    stats = backend.enforce(make_plan({pid: True for pid in ids}))
    assert all(pool.pages[pid].hbm_slot is not None for pid in ids)
    assert stats.bytes_promoted == 3 * pool.page_bytes
    for pid, k in zip(ids, before):
        assert torch.equal(pool.k_hbm[:, pool.pages[pid].hbm_slot], k)
    cache.match(tokens, step=1)
    snap = backend.snapshot()
    assert len(snap.rows) == 1 and snap.rows[0].accesses == pytest.approx(3)
    assert backend.fast_bytes() == 3 * pool.page_bytes


def test_prefix_backend_never_demotes_referenced_pages():
    pool, cache, tokens, pages = seeded_cache()
    backend = PrefixBackend(cache, clock=lambda: 0)
    for node in cache.match(tokens, step=1)[:2]:    # a live request holds
        pool.attach(5, node.page_id, step=1)         # pages 0 and 1
    backend.enforce(make_plan({p.page_id: False for p in pages}))
    assert [pool.pages[p.page_id].hbm_slot is None for p in pages] == \
        [False, False, True]


# =================================================== through the engine
def port_model(arch="llama3_2_1b"):
    """(JAX model, its f32 params, the port's model with those weights)."""
    cfg = dataclasses.replace(get_smoke(arch), remat=False,
                              dtype=jnp.float32)
    model = build_model(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          model.init(jax.random.PRNGKey(0)))
    m = Model(config_from_reference(model.cfg), device="cpu")
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu"))
    return model, params, m


@pytest.fixture(scope="module")
def dense():
    return port_model()


def make_llm(model, **kw):
    return LLM(model, ServeConfig(
        max_batch=4, page_size=4, hbm_pages=32, host_pages=64,
        max_pages_per_seq=16, interval_steps=4, keep_logits=True, **kw))


def drive(llm, prompts, params_list):
    """Generation by hand: every finished stream and each decode step's
    logits per request."""
    handles = [llm.submit(p, sp) for p, sp in zip(prompts, params_list)]
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
    assert [o.finish_reason for o in outs_a] == \
        [o.finish_reason for o in outs_b]
    for rid in logits_a:
        assert len(logits_a[rid]) == len(logits_b[rid])
        assert all(np.array_equal(x, y)
                   for x, y in zip(logits_a[rid], logits_b[rid])), rid


PROMPTS = [SHARED + [20 + i] for i in range(3)] + [SHARED[:9]]
PLIST = [SamplingParams(max_tokens=5),
         SamplingParams(max_tokens=5, temperature=0.8, top_k=40, seed=7),
         SamplingParams(max_tokens=5, temperature=1.1, top_p=0.9),
         SamplingParams(max_tokens=5)]


@pytest.mark.parametrize("mode", [
    pytest.param({}, id="one_shot"),
    pytest.param({"prefill": "chunked"}, id="chunked"),
    pytest.param({"prefill_chunk_tokens": 3}, id="interleaved"),
])
def test_cached_equals_uncached_bitwise(dense, mode):
    """Identical prompts with and without the cache give bitwise-equal
    logits and streams, greedy and sampled, in every prefill mode.  A
    warm-up request runs first, so that every prompt hits even where an
    interleaved prefill enters the cache only when it completes."""
    runs, stats = [], None
    for cache in (False, True):
        llm = make_llm(dense[2], enable_prefix_cache=cache, **mode)
        llm.submit(SHARED + [99], SamplingParams(max_tokens=1)).result()
        runs.append(drive(llm, PROMPTS, PLIST))
        stats = llm.stats()
    assert_equal_runs(*runs)
    assert stats["prefix_hit_requests"] == len(PROMPTS)
    assert stats["saved_prefill_tokens"] == 3 * 12 + 8


def test_interleaved_prefill_through_a_hit_equals_one_shot(dense):
    """A chunked (interleaved) suffix behind a cache hit equals the
    one-shot run bitwise, and the hit is taken."""
    m = dense[2]
    outs = {}
    for extra in ({}, {"prefill_chunk_tokens": 3}):
        llm = make_llm(m, enable_prefix_cache=True, **extra)
        llm.submit(SHARED + [50], SamplingParams(max_tokens=1)).result()
        outs[bool(extra)] = llm.submit(
            SHARED + [51, 52, 53, 54, 55],
            SamplingParams(max_tokens=4, temperature=0.7, seed=3)
        ).result().token_ids
        assert llm.stats()["saved_prefill_tokens"] == 12
    assert outs[True] == outs[False]


def test_full_hit_skips_prefill_dispatch(dense):
    llm = make_llm(dense[2], enable_prefix_cache=True)
    prompt = SHARED + [42]                       # n_ingest = 12 = 3 pages
    sp = SamplingParams(max_tokens=3)
    first = llm.submit(prompt, sp).result()
    d0 = llm.engine.prefill_dispatches
    second = llm.submit(prompt, sp).result()
    assert llm.engine.prefill_dispatches == d0
    assert second.token_ids == first.token_ids
    assert llm.stats()["saved_prefill_tokens"] == 12
    # Its decode wrote to a fresh private page, never a shared one.
    assert all(p.refcount == 1 for p in llm.engine.pool.pages.values())


def test_preemption_replay_through_cache_hit(dense):
    def run(preempt):
        llm = make_llm(dense[2], enable_prefix_cache=True)
        llm.submit(SHARED + [77], SamplingParams(max_tokens=1)).result()
        h = llm.submit(SHARED + [88], SamplingParams(
            max_tokens=8, temperature=0.9, seed=11))
        for _ in range(3):
            llm.step()
        if preempt:
            llm.pause(h.request_id)
            assert llm.engine._preempt_one()
            assert llm.engine.requests[h.request_id].state == "preempted"
            llm.resume(h.request_id)
        return h.result().token_ids, llm.stats()

    calm, _ = run(preempt=False)
    replayed, stats = run(preempt=True)
    assert replayed == calm
    assert stats["preemptions"] >= 1
    assert stats["prefix_hit_requests"] >= 2     # admit + re-admit both hit


def test_shared_pages_never_in_the_kv_profile(dense):
    llm = make_llm(dense[2], enable_prefix_cache=True)
    for p in PROMPTS[:3]:
        llm.submit(p, SamplingParams(max_tokens=6))
    llm.step()
    eng = llm.engine
    shared = {pid for pid, p in eng.pool.pages.items() if p.shared}
    assert shared == set(eng.prefix_cache.by_page) and shared
    eng.kv_backend.snapshot()
    profiled = {c.chunk_id for rows in eng.kv_backend.telemetry().values()
                for c in rows}
    assert profiled and not profiled & shared
    before = {pid: eng.pool.pages[pid].accesses for pid in shared}
    eng.kv_backend.reweight(0.5)
    assert {pid: eng.pool.pages[pid].accesses for pid in shared} == before


def test_prefix_runtime_drives_interval_loop(dense):
    llm = make_llm(dense[2], enable_prefix_cache=True)
    eng = llm.engine
    assert eng.prefix_runtime is not None
    llm.generate([SHARED + [60 + i] for i in range(3)],
                 SamplingParams(max_tokens=6))
    assert [e for e in eng.prefix_runtime.events
            if getattr(e, "kind", None) == "interval"]
    assert set(eng.prefix_cache.by_page) & set(eng.last_recs)


def test_cold_prefixes_reclaimed_before_preemption(dense):
    """Under logical-page pressure, cached prefixes no request holds yield
    their pages before any live request is preempted."""
    llm = LLM(dense[2], ServeConfig(
        max_batch=2, page_size=4, hbm_pages=9, host_pages=2,
        max_pages_per_seq=8, enable_prefix_cache=True))
    llm.generate([SHARED + [1]], SamplingParams(max_tokens=1))
    assert len(llm.engine.prefix_cache) == 3
    llm.generate([[9] * 20, [8] * 9], SamplingParams(max_tokens=2))
    st = llm.stats()
    assert st["prefix_evicted_pages"] > 0 and st["preemptions"] == 0


@pytest.mark.parametrize("sampled", [False, True])
def test_cached_streams_match_jax(dense, sampled):
    """Port vs the JAX engine in f32 with the cache on: equal streams and
    hit counts, logits within 1e-4."""
    model, params, m = dense
    kw = dict(max_batch=4, page_size=4, hbm_pages=48, host_pages=64,
              max_pages_per_seq=16, interval_steps=4, keep_logits=True,
              enable_prefix_cache=True)
    prompts = PROMPTS + [SHARED + [20]]              # a full hit
    plist = [dict(max_tokens=5) for _ in prompts]
    if sampled:
        for i, sp in enumerate(plist):
            sp.update(temperature=0.8, top_k=40, top_p=0.9, seed=100 + i)
    jllm = JLLM(model, params, JServeConfig(**kw))
    want = drive(jllm, prompts, [JSamplingParams(**sp) for sp in plist])
    assert jllm.engine.pool.swaps_in == 0
    llm = LLM(m, ServeConfig(**kw))
    got = drive(llm, prompts, [SamplingParams(**sp) for sp in plist])
    assert [o.token_ids for o in got[0]] == [o.token_ids for o in want[0]]
    for key in ("prefix_hit_requests", "prefix_hit_pages",
                "saved_prefill_tokens", "prefix_cached_pages",
                "prefill_tokens"):
        assert llm.stats()[key] == jllm.engine.stats()[key], key
    for rid in want[1]:
        assert len(got[1][rid]) == len(want[1][rid])
        if want[1][rid]:
            np.testing.assert_allclose(np.stack(got[1][rid]),
                                       np.stack(want[1][rid]),
                                       atol=1e-4, rtol=1e-4)
