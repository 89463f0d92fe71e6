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

from typing import Dict, List, Type

from .kvcache import Page


class EvictionPolicy:
    """Ranks the pages that may lose their HBM slot.  Stateless by default.

    A policy gives each candidate a sort key; ``pick_many`` ranks the
    candidates once by a stable sort on it, so victims come in key order
    and, among equal keys, in candidate order (what repeating ``min`` and
    dropping the winner gives, at one ranking instead of one per victim).
    """

    name = "base"

    def keys(self, candidates: List[Page], engine) -> List:
        """One sort key per candidate, in candidate order."""
        raise NotImplementedError

    def pick_many(self, candidates: List[Page], engine,
                  n: int) -> List[int]:
        """Up to ``n`` victims, best first; the engine swaps them out in
        ONE batched migration rather than one transfer per victim."""
        if n <= 0 or not candidates:
            return []
        keys = self.keys(candidates, engine)
        ranked = sorted(range(len(candidates)), key=keys.__getitem__)
        return [candidates[i].page_id for i in ranked[:n]]


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
