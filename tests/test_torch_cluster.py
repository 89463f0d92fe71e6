"""The port's elastic multi-replica serving (``repro_torch.serve.cluster``)
on ``llama3_2_1b`` SMOKE in f32, with the JAX package's weights carried
across by ``params_from_numpy``: the reference suite
``tests/test_cluster.py`` on the port, plus parity with the JAX package.

Across frameworks: the Router's dispatch (the replica each request lands
on) and the greedy and seeded streams equal the JAX cluster's.  The JAX
pools are sized so that they never swap a page in: that move does not run
on this tree's jax.

Within the port, bitwise: N=3 == N=1, a crash's cold migration, a drain's
warm migration (with shared prefix pages too), a warm import that falls
back to cold, and a rolling restart under load all give the streams of
the unkilled single-replica run; a MoE cluster with experts off the device
equals one replica."""

import dataclasses
import functools

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
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
)
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch.analysis import serving_summary  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    LLM,
    ReplicaLostError,
    Router,
    SamplingParams,
    ServeConfig,
)
from repro_torch.serve.kvcache import PagedKVPool  # noqa: E402

DENSE, MOE = "llama3_2_1b", "granite_moe_3b_a800m"
SC = ServeConfig(max_batch=2, page_size=4, hbm_pages=16, host_pages=32)
# A pool the JAX engines never swap into (its swap-in fails on this jax).
ROOMY = dict(max_batch=2, page_size=4, hbm_pages=64, host_pages=32)
MAX_NEW = 8
N_REQ = 6


@functools.lru_cache(maxsize=None)
def models(arch):
    """(JAX model, its f32 params, the port's model with those weights)."""
    cfg = dataclasses.replace(get_smoke(arch), remat=False,
                              dtype=jnp.float32)
    model = build_model(cfg)
    # The JAX package declares its weights in bf16 whatever cfg.dtype is.
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          model.init(jax.random.PRNGKey(0)))
    m = Model(config_from_reference(model.cfg), device="cpu")
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu"))
    return model, params, m


@pytest.fixture(scope="module")
def port_model():
    return models(DENSE)[2]


def prompts_for(vocab, n=N_REQ, seed=0, length=6):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, length)]
            for _ in range(n)]


def sampled(i, max_tokens=MAX_NEW, sp=SamplingParams):
    """Seeded non-greedy sampling: a migrated request must resample
    identically, which holds only if seed AND absolute stream position
    survive the move."""
    return sp(temperature=0.8, top_k=40, top_p=0.9, seed=100 + i,
              max_tokens=max_tokens)


def run_to_completion(llm, handles):
    steps = 0
    while any(not h.finished for h in handles):
        llm.step()
        steps += 1
        assert steps < 400, "cluster failed to converge (dropped request?)"
    return {h.request_id: (list(h.token_ids), h.finish_reason)
            for h in handles}


@pytest.fixture(scope="module")
def prompts(port_model):
    return prompts_for(port_model.cfg.vocab)


@pytest.fixture(scope="module")
def reference_streams(port_model, prompts):
    """The unkilled single-replica run every migration test compares to."""
    llm = LLM(port_model, SC)
    handles = [llm.submit(p, sampled(i), request_id=i)
               for i, p in enumerate(prompts)]
    return run_to_completion(llm, handles)


# ------------------------------------------------- pool export / import
def make_pool(seed=0):
    pool = PagedKVPool(n_layers=2, page_size=4, kv_heads=2, head_dim=8,
                       hbm_pages=8, host_pages=16, dtype=torch.float32,
                       device="cpu")
    rng = np.random.default_rng(seed)
    for t in (pool.k_hbm, pool.v_hbm):
        t.copy_(torch.from_numpy(
            rng.normal(size=tuple(t.shape)).astype(np.float32)))
    for idx in range(3):
        page = pool.allocate(0, idx, step=0)
        page.tokens_used = 4 if idx < 2 else 2
        page.accesses = float(10 - idx)
    pool.swap_out(pool.request_pages(0)[2].page_id)   # one page on host
    return pool


def page_bytes(pool, page):
    fast = page.hbm_slot is not None
    k, v = (pool.k_hbm, pool.v_hbm) if fast else (pool.k_host, pool.v_host)
    slot = page.hbm_slot if fast else page.host_slot
    return (k[:, slot].numpy().tobytes(), v[:, slot].numpy().tobytes())


def test_export_import_roundtrip_bitwise_and_tier_preserving():
    src = make_pool()
    pages = src.request_pages(0)
    want = [page_bytes(src, p) for p in pages]
    export = src.export_pages([p.page_id for p in pages])
    assert src.exported_pages == 3
    assert export.fast == [True, True, False]      # source tiers recorded

    dst = PagedKVPool(n_layers=2, page_size=4, kv_heads=2, head_dim=8,
                      hbm_pages=8, host_pages=16, dtype=torch.float32,
                      device="cpu")
    landed = dst.import_pages(export, request_id=5, step=3)
    assert dst.imported_pages == 3
    assert [p.index_in_seq for p in landed] == [0, 1, 2]
    assert [p.tokens_used for p in landed] == [4, 4, 2]
    assert [p.accesses for p in landed] == [10.0, 9.0, 8.0]
    # Tier placement survives when the destination has room.
    assert [p.hbm_slot is not None for p in landed] == [True, True, False]
    assert [page_bytes(dst, p) for p in landed] == want
    assert [p.page_id for p in dst.request_pages(5)] == \
        [p.page_id for p in landed]


def test_export_unknown_page_and_geometry_mismatch_raise():
    src = make_pool()
    with pytest.raises(ValueError, match="999"):
        src.export_pages([999])
    export = src.export_pages([p.page_id for p in src.request_pages(0)])
    other = PagedKVPool(n_layers=2, page_size=8, kv_heads=2, head_dim=8,
                        hbm_pages=8, host_pages=16, dtype=torch.float32,
                        device="cpu")
    with pytest.raises(ValueError, match="share one model/page geometry"):
        other.import_pages(export, request_id=1, step=0)


def test_import_into_full_pool_raises_memoryerror_for_cold_fallback():
    src = make_pool()
    export = src.export_pages([p.page_id for p in src.request_pages(0)])
    tiny = PagedKVPool(n_layers=2, page_size=4, kv_heads=2, head_dim=8,
                       hbm_pages=1, host_pages=1, dtype=torch.float32,
                       device="cpu")
    with pytest.raises(MemoryError, match="cold-migrate instead"):
        tiny.import_pages(export, request_id=1, step=0)
    assert tiny.pages == {} and tiny.imported_pages == 0


def test_select_from_keeps_only_trailing_blocks():
    src = make_pool()
    export = src.export_pages([p.page_id for p in src.request_pages(0)])
    tail = export.select_from(2)
    assert len(tail) == 1 and tail.index_in_seq == [2]
    assert tail.k.shape[1] == 1
    assert torch.equal(tail.v[:, 0], export.v[:, 2])


# ------------------------------------------------------------- dispatch
def test_least_loaded_dispatch_round_robins_fresh_cluster(port_model,
                                                          prompts):
    llm = LLM(port_model, SC, replicas=3)
    for i, p in enumerate(prompts):
        llm.submit(p, SamplingParams(max_tokens=MAX_NEW), request_id=i)
    owners = [llm.cluster.owner[i].replica_id for i in range(N_REQ)]
    assert owners == [0, 1, 2, 0, 1, 2]     # pages-in-use ties broken by id

    # Pinning overrides the balance; pinning to a non-alive replica raises.
    llm2 = LLM(port_model, SC, replicas=2)
    llm2.submit(prompts[0], SamplingParams(max_tokens=2), request_id=0,
                replica_id=1)
    assert llm2.cluster.owner[0].replica_id == 1
    llm2.cluster.fail(0)
    with pytest.raises(ValueError, match="failed"):
        llm2.submit(prompts[1], SamplingParams(max_tokens=2), request_id=1,
                    replica_id=0)


def test_n3_cluster_matches_single_replica_bitwise(port_model, prompts,
                                                   reference_streams):
    llm = LLM(port_model, SC, replicas=3)
    handles = [llm.submit(p, sampled(i), request_id=i)
               for i, p in enumerate(prompts)]
    assert run_to_completion(llm, handles) == reference_streams


# ------------------------------------------------------ cold migration
def test_replica_crash_cold_migrates_bitwise(port_model, prompts,
                                             reference_streams):
    llm = LLM(port_model, SC, replicas=3, heartbeat_timeout=2.0)
    handles = [llm.submit(p, sampled(i), request_id=i)
               for i, p in enumerate(prompts)]
    for _ in range(2):
        llm.step()
    victim = llm.cluster.replicas[0].replica_id
    orphaned = sorted(rid for rid, rep in llm.cluster.owner.items()
                      if rep.replica_id == victim)
    llm.cluster.fail(victim)
    assert run_to_completion(llm, handles) == reference_streams
    assert llm.cluster.failovers == 1
    assert llm.cluster.migrations_cold == len(orphaned)
    assert llm.cluster.requests_lost == 0
    # The failed member is gone; its requests decode on survivors.
    assert [r.replica_id for r in llm.cluster.replicas] == [1, 2]


def test_finished_before_crash_result_survives_via_ticket(port_model,
                                                          prompts):
    llm = LLM(port_model, SC, replicas=2, heartbeat_timeout=2.0)
    llm.submit(prompts[0], SamplingParams(max_tokens=3), request_id=9)
    steps = 0
    while 9 not in llm.cluster.finished:
        llm.cluster.step()        # step the router directly: no handle drain
        steps += 1
        assert steps < 100
    llm.cluster.fail(llm.cluster.owner[9].replica_id)
    for _ in range(4):
        llm.cluster.step()        # detection + recovery
    req = llm.cluster.pop_finished(9)   # orphaned result, served anyway
    assert req.finish_reason == "length" and len(req.generated) == 3


# ------------------------------------------------------ warm migration
def test_drain_warm_migrates_pages_bitwise(port_model, prompts,
                                           reference_streams):
    llm = LLM(port_model, SC, replicas=3)
    handles = [llm.submit(p, sampled(i), request_id=i)
               for i, p in enumerate(prompts)]
    for _ in range(3):
        llm.step()
    victim = llm.cluster.replicas[0].replica_id
    n_owned = sum(1 for rep in llm.cluster.owner.values()
                  if rep.replica_id == victim)
    assert llm.cluster.drain(victim) == n_owned
    assert llm.cluster.migrations_warm == n_owned   # pages fit: all warm
    assert llm.cluster.migrations_cold == 0
    llm.cluster.remove_replica(victim)
    assert run_to_completion(llm, handles) == reference_streams
    assert llm.stats()["imported_pages"] > 0
    assert llm.cluster.requests_lost == 0


def test_drain_with_shared_prefix_pages_stays_bitwise(port_model):
    sc = dataclasses.replace(SC, enable_prefix_cache=True,
                             min_prefix_pages=1)
    vocab = port_model.cfg.vocab
    rng = np.random.default_rng(1)
    shared = [int(t) for t in rng.integers(1, vocab, 9)]
    p1 = shared + [int(t) for t in rng.integers(1, vocab, 3)]
    p2 = shared + [int(t) for t in rng.integers(1, vocab, 3)]

    def run(kill):
        llm = LLM(port_model, sc, replicas=2)
        rep0 = llm.cluster.replicas[0].replica_id
        h1 = llm.submit(p1, SamplingParams(max_tokens=6), request_id=0,
                        replica_id=rep0)
        run_to_completion(llm, [h1])    # seeds the prefix cache on rep0
        h2 = llm.submit(p2, SamplingParams(max_tokens=6), request_id=1,
                        replica_id=rep0)
        for _ in range(2):
            llm.step()
        # The in-flight request really holds shared prefix-cache pages.
        eng = llm.cluster.owner[1].engine
        assert any(p.shared for p in eng.pool.request_pages(1))
        if kill:
            llm.cluster.drain(rep0)
            llm.cluster.remove_replica(rep0)
            assert llm.cluster.migrations_warm == 1
            # The destination adopted the migrated prompt's three full
            # blocks (the leading two are p1's too).
            dst = llm.cluster.owner[1].engine
            assert len(dst.prefix_cache) == 3
        return run_to_completion(llm, [h2])

    assert run(kill=True) == run(kill=False)


def test_warm_import_reattaches_the_destinations_cached_prefix(port_model):
    """The warm path's prefix branch: a destination whose cache already
    holds the leading blocks attaches them by reference and imports only
    the tail; the stream stays bitwise."""
    sc = dataclasses.replace(SC, enable_prefix_cache=True)
    vocab = port_model.cfg.vocab
    rng = np.random.default_rng(2)
    shared = [int(t) for t in rng.integers(1, vocab, 9)]
    p1, p2 = (shared + [int(t) for t in rng.integers(1, vocab, 3)]
              for _ in range(2))

    def run(kill):
        llm = LLM(port_model, sc, replicas=2)
        for rep in (0, 1):                # both caches hold the prefix
            llm.submit(p1, SamplingParams(max_tokens=2), request_id=10 + rep,
                       replica_id=rep).result()
        h = llm.submit(p2, SamplingParams(max_tokens=6), request_id=1,
                       replica_id=0)
        llm.step()
        if kill:
            dst = llm.cluster.replicas[1].engine
            before = dst.pool.imported_pages
            lookups = dst.prefix_cache.lookups
            llm.cluster.drain(0)
            assert llm.cluster.migrations_warm == 1
            # Two of the three pages came from the destination's cache,
            # uncounted; the imported third joined the cache after.
            assert dst.pool.imported_pages - before == 1
            assert dst.prefix_cache.lookups == lookups
            pages = dst.pool.request_pages(1)
            assert len(pages) == 3 and all(p.shared for p in pages)
        return run_to_completion(llm, [h])

    assert run(kill=True) == run(kill=False)


def test_warm_import_that_cannot_fit_falls_back_cold(port_model, prompts,
                                                     reference_streams):
    # The survivor's pool is big enough to DECODE one request at a time
    # (preemption handles the rest) but too small to absorb the drained
    # replica's pages wholesale on top of its own — so per-request warm
    # imports can raise MemoryError and fall back to cold recompute.
    tiny = dataclasses.replace(SC, hbm_pages=5, host_pages=2, max_batch=1)
    llm = LLM(port_model, tiny, replicas=2)
    handles = [llm.submit(p, sampled(i), request_id=i)
               for i, p in enumerate(prompts)]
    for _ in range(3):
        llm.step()
    victim = llm.cluster.replicas[0].replica_id
    llm.cluster.drain(victim)
    llm.cluster.remove_replica(victim)
    got = run_to_completion(llm, handles)
    assert llm.cluster.requests_lost == 0
    assert llm.cluster.migrations_cold >= 1     # at least one didn't fit
    assert got == reference_streams


# ------------------------------------------------------ rolling restart
def test_rolling_restart_under_load_zero_drops_bitwise(port_model, prompts,
                                                       reference_streams):
    llm = LLM(port_model, SC, replicas=3)
    handles = [llm.submit(p, sampled(i), request_id=i)
               for i, p in enumerate(prompts[:4])]
    for _ in range(2):
        llm.step()
    original = [r.replica_id for r in llm.cluster.replicas]
    for i, rep_id in enumerate(original):
        llm.cluster.restart_replica(rep_id)
        # Submissions keep landing while the restart sweeps the cluster.
        rid = 4 + i
        if rid < N_REQ:
            handles.append(llm.submit(prompts[rid], sampled(rid),
                                      request_id=rid))
        llm.step()
    assert run_to_completion(llm, handles) == reference_streams
    assert llm.cluster.restarts == 3
    assert llm.cluster.requests_lost == 0
    # Every original member was replaced by a fresh id.
    now = [r.replica_id for r in llm.cluster.replicas]
    assert not set(now) & set(original) and len(now) == 3


# ----------------------------------------------------------- loud loss
def test_remove_without_migration_raises_replica_lost(port_model, prompts):
    llm = LLM(port_model, SC, replicas=2)
    h = llm.submit(prompts[0], SamplingParams(max_tokens=20), request_id=7)
    llm.step()
    llm.cluster.remove_replica(llm.cluster.owner[7].replica_id,
                               migrate=False)
    with pytest.raises(ReplicaLostError, match="removed without migration"):
        for _ in h:
            pass
    assert llm.cluster.requests_lost == 1
    with pytest.raises(ReplicaLostError):
        llm.pause(7)


def test_crash_with_no_survivor_raises_replica_lost(port_model, prompts):
    llm = LLM(port_model, SC, replicas=1, heartbeat_timeout=2.0)
    h = llm.submit(prompts[0], SamplingParams(max_tokens=20), request_id=3)
    llm.step()
    llm.cluster.fail(llm.cluster.replicas[0].replica_id)
    with pytest.raises(ReplicaLostError, match="no alive replica"):
        for _ in h:
            pass
    assert llm.cluster.requests_lost == 1


def test_drain_requires_another_alive_replica(port_model, prompts):
    llm = LLM(port_model, SC, replicas=1)
    llm.submit(prompts[0], SamplingParams(max_tokens=4), request_id=0)
    with pytest.raises(ValueError, match="no other alive"):
        llm.cluster.drain(0)
    assert llm.cluster.replicas[0].state == "alive"   # rolled back


# ------------------------------------------------- router transparency
def test_single_replica_delegates_engine_attributes(port_model):
    llm = LLM(port_model, SC, replicas=1)
    assert isinstance(llm.engine, Router)
    assert llm.engine.pool is llm.cluster.replicas[0].engine.pool
    assert llm.engine.cfg.page_size == SC.page_size

    multi = LLM(port_model, SC, replicas=2)
    with pytest.raises(AttributeError, match="2 reachable replicas"):
        multi.engine.pool


def test_cluster_serving_summary_aggregates_and_nests(port_model, prompts):
    llm = LLM(port_model, SC, replicas=2)
    handles = [llm.submit(p, SamplingParams(max_tokens=4), request_id=i)
               for i, p in enumerate(prompts[:4])]
    run_to_completion(llm, handles)
    s = serving_summary(llm.cluster)
    assert s["cluster_replicas"] == 2
    assert set(s["replicas"]) == {"replica0", "replica1"}
    per = s["replicas"]
    assert s["engine_steps"] == sum(r["engine_steps"] for r in per.values())
    assert s["engine_finished_length"] == 4
    assert s["intervals"] == sum(r["intervals"] for r in per.values())
    # At N=1 the summary is flat — same shape the pre-cluster tooling read.
    solo = LLM(port_model, SC, replicas=1)
    hs = [solo.submit(prompts[0], SamplingParams(max_tokens=2),
                      request_id=0)]
    run_to_completion(solo, hs)
    flat = serving_summary(solo.cluster)
    assert "replicas" not in flat and flat["cluster_replicas"] == 1


# -------------------------------------------------------- the launcher
def test_serving_launcher_rolling_restart_on_the_cpu(capsys):
    stats = launch_serve.main([
        "--arch", DENSE, "--smoke", "--device", "cpu", "--replicas", "2",
        "--rolling-restart", "--sessions", "4", "--rounds", "4"])
    assert stats["cluster_restarts"] == 2
    assert stats["cluster_requests_lost"] == 0
    assert stats["cluster_migrations_warm"] > 0
    assert stats["tokens"] > 0
    assert '"cluster_restarts": 2' in capsys.readouterr().out


# ------------------------------------------------- the JAX package's cluster
@pytest.fixture(scope="module")
def jax_cluster(prompts):
    """The JAX ``LLM`` at N=3 on the roomy pool: each request's replica
    and its greedy (even ids) or seeded (odd ids) stream."""
    model, params, _ = models(DENSE)
    llm = JLLM(model, params, JServeConfig(**ROOMY), replicas=3)
    handles = [llm.submit(p, sampled(i, sp=JSamplingParams) if i % 2
                          else JSamplingParams(max_tokens=MAX_NEW),
                          request_id=i)
               for i, p in enumerate(prompts)]
    owners = [llm.cluster.owner[i].replica_id for i in range(N_REQ)]
    streams = run_to_completion(llm, handles)
    assert all(rep.engine.pool.swaps_in == 0 for rep in llm.cluster.replicas)
    return owners, streams


@pytest.mark.parametrize("replicas", [1, 3])
def test_dispatch_and_streams_match_jax(port_model, prompts, jax_cluster,
                                        replicas):
    owners, want = jax_cluster
    llm = LLM(port_model, ServeConfig(**ROOMY), replicas=replicas)
    handles = [llm.submit(p, sampled(i) if i % 2
                          else SamplingParams(max_tokens=MAX_NEW),
                          request_id=i)
               for i, p in enumerate(prompts)]
    if replicas == 3:
        assert [llm.cluster.owner[i].replica_id
                for i in range(N_REQ)] == owners
    assert run_to_completion(llm, handles) == want


def test_loaded_dispatch_matches_jax(port_model):
    """Dispatch under load: prompts of mixed lengths arrive while earlier
    ones decode, so the queue-delay key, not the id, decides."""
    model, params, _ = models(DENSE)
    vocab = port_model.cfg.vocab
    rng = np.random.default_rng(5)
    lens = [3, 30, 5, 12, 40, 7, 9, 2]
    reqs = [[int(t) for t in rng.integers(1, vocab, n)] for n in lens]
    kw = dict(ROOMY, max_batch=2, prefill_chunk_tokens=8)

    def owners(llm, sp):
        out = []
        for i, p in enumerate(reqs):
            llm.submit(p, sp(max_tokens=4), request_id=i)
            out.append(llm.cluster.owner[i].replica_id)
            if i % 3 == 2:
                llm.step()
        return out

    want = owners(JLLM(model, params, JServeConfig(**kw), replicas=3),
                  JSamplingParams)
    got = owners(LLM(port_model, ServeConfig(**kw), replicas=3),
                 SamplingParams)
    assert got == want
    assert len(set(got[:3])) == 3 and got != [0, 1, 2, 0, 1, 2, 0, 1]


# --------------------------------------------------------------- MoE
def test_moe_expert_offchip_cluster_equals_one_replica():
    """granite MoE SMOKE with its experts in the host tier: N=2 (one drain
    half way) == N=1.  Every replica builds its own expert store from the
    shared model's weights."""
    m = models(MOE)[2]
    sc = ServeConfig(max_batch=2, page_size=4, hbm_pages=32, host_pages=64,
                     max_pages_per_seq=16, expert_offchip=True,
                     expert_cache_size=8)
    ps = prompts_for(m.cfg.vocab, n=4, seed=3)

    def run(replicas, drain):
        llm = LLM(m, sc, replicas=replicas)
        handles = [llm.submit(p, sampled(i, 6), request_id=i)
                   for i, p in enumerate(ps)]
        if drain:
            for _ in range(2):
                llm.step()
            llm.cluster.drain(0)
            llm.cluster.remove_replica(0)
            assert llm.cluster.migrations_warm > 0
        return run_to_completion(llm, handles), llm.stats()

    want, _ = run(1, False)
    for drain in (False, True):
        got, st = run(2, drain)
        assert got == want
        assert st["expert_demand_fetches"] > 0
