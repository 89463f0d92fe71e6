"""First-class eviction policies for the paged KV pool.

Between guidance intervals the engine sometimes needs a free HBM slot *now*
(a paused session resumes, a new page is allocated).  Which resident page
loses its slot is a policy decision, previously inlined in the engine;
policies are now objects in a registry so serving benchmarks — and future
policies — select them by name.

``guided`` consults the latest enforced placement from the
``GuidanceRuntime`` (pages the last plan wanted fast never lose to pages it
wanted slow), tie-breaking by least-recently-scheduled request.  ``lru`` and
``fifo`` are the unguided baselines.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Type

from .kvcache import Page


class EvictionPolicy:
    """Ranks the pages that may lose their HBM slot.  Stateless by default.

    A policy implements ``pick`` (the reference's hook: the one victim of
    ``candidates``) or ``keys`` (one sort key per candidate).  The built-ins
    give keys, and their ``pick`` is the candidate with the least key, the
    first among equals.  ``pick_many`` ranks by one stable sort on the keys,
    so victims come in key order and, among equal keys, in candidate order
    (what repeating ``pick`` and dropping the winner gives, at one ranking
    instead of one per victim); a class whose ``pick`` is its own, below
    the class that gives its ``keys``, is ranked by repeated ``pick``.
    """

    name = "base"

    def keys(self, candidates: List[Page], engine) -> List:
        """One sort key per candidate, in candidate order."""
        raise NotImplementedError

    def pick(self, candidates: List[Page], engine) -> Optional[int]:
        """The page id of the next victim, or None when there is none."""
        if not candidates:
            return None
        keys = self.keys(candidates, engine)
        return candidates[min(range(len(candidates)),
                              key=keys.__getitem__)].page_id

    def pick_many(self, candidates: List[Page], engine,
                  n: int) -> List[int]:
        """Up to ``n`` victims, best first; the engine swaps them out in
        ONE batched migration rather than one transfer per victim."""
        if n <= 0 or not candidates:
            return []
        if _ranks_by_pick(type(self)):
            pool, victims = list(candidates), []
            while len(victims) < n and pool:
                vid = self.pick(pool, engine)
                if vid is None:
                    break
                victims.append(vid)
                pool = [p for p in pool if p.page_id != vid]
            return victims
        keys = self.keys(candidates, engine)
        ranked = sorted(range(len(candidates)), key=keys.__getitem__)
        return [candidates[i].page_id for i in ranked[:n]]


def _ranks_by_pick(cls: type) -> bool:
    """Whether ``cls`` overrides ``pick`` below the class that gives its
    ``keys``: then only repeated ``pick`` honours it."""
    mro = cls.__mro__

    def owner(attr: str) -> int:
        return next(i for i, c in enumerate(mro) if attr in vars(c))

    return owner("pick") < owner("keys")


class LRUEviction(EvictionPolicy):
    """Evict the page of the least-recently-scheduled request.

    Refcount-aware: a page's recency is the MOST recent of its holders'
    last-scheduled steps (a shared prefix page is as hot as its hottest
    request), and a page whose only holder is the prefix cache falls back
    to the page's own ``last_used`` clock (its last hit/attach)."""

    name = "lru"

    @staticmethod
    def recency(p: Page, engine) -> int:
        stamps = [engine.requests[rid].last_scheduled
                  for rid in engine.pool.holders(p.page_id)
                  if rid in engine.requests]
        return max(stamps) if stamps else p.last_used

    def keys(self, candidates: List[Page], engine) -> List:
        return [self.recency(p, engine) for p in candidates]


class FIFOEviction(EvictionPolicy):
    """Evict the oldest page by birth step."""

    name = "fifo"

    def keys(self, candidates: List[Page], engine) -> List:
        return [p.birth_step for p in candidates]


class GuidedEviction(LRUEviction):
    """Prefer pages the last recommendation placed on the slow tier (or
    did not place at all); LRU among equals, and entirely before the first
    interval."""

    name = "gdt"

    def keys(self, candidates: List[Page], engine) -> List:
        recs: Dict[int, bool] = getattr(engine, "last_recs", {}) or {}
        lru = super().keys(candidates, engine)
        if not recs:
            return lru
        return [(recs.get(p.page_id, False), r)
                for p, r in zip(candidates, lru)]


EVICTION_POLICIES: Dict[str, Type[EvictionPolicy]] = {}


def register_eviction_policy(cls: Type[EvictionPolicy]) -> Type[EvictionPolicy]:
    EVICTION_POLICIES[cls.name] = cls
    return cls


for _cls in (LRUEviction, FIFOEviction, GuidedEviction):
    register_eviction_policy(_cls)


def make_eviction_policy(name: str) -> EvictionPolicy:
    try:
        return EVICTION_POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown eviction policy {name!r}; "
            f"expected one of {sorted(EVICTION_POLICIES)}") from None
