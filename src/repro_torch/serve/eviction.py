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

from typing import Dict, Iterable, List, Optional, Type

from .kvcache import Page


class EvictionPolicy:
    """Picks the page that loses its HBM slot.  Stateless by default."""

    name = "base"

    def pick(self, candidates: List[Page], engine) -> Optional[int]:
        raise NotImplementedError

    def pick_many(self, candidates: List[Page], engine,
                  n: int) -> List[int]:
        """Pick up to ``n`` victims (ranked by repeated ``pick``); the
        engine swaps them out in ONE batched migration rather than one
        transfer per victim.  Policies with a cheaper bulk ranking may
        override."""
        pool = list(candidates)
        victims: List[int] = []
        while len(victims) < n and pool:
            vid = self.pick(pool, engine)
            if vid is None:
                break
            victims.append(vid)
            pool = [p for p in pool if p.page_id != vid]
        return victims


class LRUEviction(EvictionPolicy):
    """Evict the page of the least-recently-scheduled request.

    Refcount-aware: a page's recency is the MOST recent of its holders'
    last-scheduled steps (a shared prefix page is as hot as its hottest
    request), and a page whose only holder is the prefix cache falls back
    to the page's own ``last_used`` clock (its last hit/attach)."""

    name = "lru"

    def pick(self, candidates: List[Page], engine) -> Optional[int]:
        if not candidates:
            return None

        def recency(p: Page) -> int:
            stamps = [engine.requests[rid].last_scheduled
                      for rid in engine.pool.holders(p.page_id)
                      if rid in engine.requests]
            return max(stamps) if stamps else p.last_used

        return min(candidates, key=recency).page_id


class FIFOEviction(EvictionPolicy):
    """Evict the oldest page by birth step."""

    name = "fifo"

    def pick(self, candidates: List[Page], engine) -> Optional[int]:
        if not candidates:
            return None
        return min(candidates, key=lambda p: p.birth_step).page_id


class GuidedEviction(LRUEviction):
    """Prefer pages the last recommendation placed on the slow tier; fall
    back to LRU among equals (and entirely, before the first interval)."""

    name = "gdt"

    def pick(self, candidates: List[Page], engine) -> Optional[int]:
        recs: Dict[int, bool] = getattr(engine, "last_recs", {}) or {}
        if recs:
            cold = [p for p in candidates if not recs.get(p.page_id, False)]
            if cold:
                candidates = cold
        return super().pick(candidates, engine)


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
