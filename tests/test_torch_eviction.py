"""The eviction policy's ``pick`` hook in the port against the JAX package
(``repro/serve/eviction.py``, DESIGN.md §7): a policy that implements only
``pick`` is ranked by repeated ``pick``, as the reference ranks every
policy; a subclass of a built-in that overrides ``pick`` is ranked by its
own ``pick``, not by the built-in's keys; and the built-ins' ``pick`` names
the victim the JAX package's names.  The pools are random, from a seed;
the JAX policies run on the port's pages, whose fields they read."""

import types
from typing import List, Optional

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.serve import eviction as jev  # noqa: E402
from repro_torch.serve import PagedKVPool  # noqa: E402
from repro_torch.serve import eviction as tev  # noqa: E402


def random_engine(seed: int):
    """A pool of pages shared between requests, some on the host tier,
    with random clocks; an engine view holding it, random recency and a
    random last recommendation (none for every third seed); and the HBM
    pages in a random order."""
    rng = np.random.default_rng(seed)
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
    pool.swap_out_many([pid for pid in pool.pages if rng.random() < 0.2])
    for p in pool.pages.values():
        p.last_used = int(rng.integers(0, 80))
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
    return engine, cands


def largest_share_first(candidates, engine) -> Optional[int]:
    """A policy as the reference's extension point takes one: the page
    with the most holders, then the youngest, then the highest id."""
    if not candidates:
        return None
    return max(candidates, key=lambda p: (
        len(engine.pool.holders(p.page_id)), p.birth_step,
        p.page_id)).page_id


class PortShare(tev.EvictionPolicy):
    name = "share-test"

    def pick(self, candidates, engine):
        return largest_share_first(candidates, engine)


class RefShare(jev.EvictionPolicy):
    name = "share-test"

    def pick(self, candidates, engine):
        return largest_share_first(candidates, engine)


class NewestLRU(tev.LRUEviction):
    """Overrides only ``pick``: the most recently used page first."""

    name = "newest-test"

    def pick(self, candidates, engine):
        if not candidates:
            return None
        return max(candidates,
                   key=lambda p: self.recency(p, engine)).page_id


def counts(cands) -> List[int]:
    return sorted({1, 3, len(cands) // 2, len(cands) + 2})


@pytest.mark.parametrize("seed", range(4))
def test_a_pick_only_policy_picks_what_the_reference_picks(seed):
    engine, cands = random_engine(seed)
    tev.register_eviction_policy(PortShare)
    jev.register_eviction_policy(RefShare)
    try:
        ours = tev.make_eviction_policy("share-test")
        theirs = jev.make_eviction_policy("share-test")
        for n in counts(cands):
            want = theirs.pick_many(cands, engine, n)
            assert ours.pick_many(cands, engine, n) == want, n
            assert len(want) == min(n, len(cands))
        assert ours.pick(cands, engine) == theirs.pick(cands, engine)
        assert ours.pick_many([], engine, 2) == []
    finally:
        del tev.EVICTION_POLICIES["share-test"]
        del jev.EVICTION_POLICIES["share-test"]


@pytest.mark.parametrize("seed", range(3))
def test_an_overridden_pick_ranks_a_builtin_subclass(seed):
    engine, cands = random_engine(seed)
    newest = NewestLRU()
    n = len(cands) // 2
    got = newest.pick_many(cands, engine, n)
    pool, want = list(cands), []
    while len(want) < n:
        want.append(newest.pick(pool, engine))
        pool = [p for p in pool if p.page_id != want[-1]]
    assert got == want
    assert got != tev.LRUEviction().pick_many(cands, engine, n)
    recency = [tev.LRUEviction.recency(p, engine) for p in cands]
    assert tev.LRUEviction.recency(
        next(p for p in cands if p.page_id == got[0]), engine) == \
        max(recency)


def test_a_policy_without_pick_or_keys_says_so():
    engine, cands = random_engine(0)
    with pytest.raises(NotImplementedError):
        tev.EvictionPolicy().pick_many(cands, engine, 1)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", ["gdt", "lru", "fifo"])
def test_builtin_pick_equals_the_reference(seed, name):
    engine, cands = random_engine(seed)
    ours = tev.make_eviction_policy(name)
    theirs = jev.make_eviction_policy(name)
    assert not tev._ranks_by_pick(type(ours))
    for k in range(len(cands)):
        rest = cands[k:]
        assert ours.pick(rest, engine) == theirs.pick(rest, engine), k
    assert ours.pick([], engine) is None
    # The one-sort ranking gives the victims of repeated pick.
    for n in counts(cands):
        assert ours.pick_many(cands, engine, n) == \
            theirs.pick_many(cands, engine, n), n
