"""Hybrid arena allocation (paper Sec. 4.1.1).

Two arena classes:

* **Private pool** — one aggregate arena that absorbs every site whose
  cumulative allocated bytes stay below ``promotion_threshold`` (paper: 4 MB).
  It is always pinned to the fast tier and is *not* profiled, exactly like the
  paper's thread-private arenas: small, hot-or-unknown data is cheap to keep
  fast and expensive to track.

* **Shared arenas** — one per promoted site.  These are the units of
  profiling and of tier migration.  A shared arena knows its resident bytes
  (exact — the runtime is the allocator, the analogue of the paper's VMA
  fault/release instrumentation) and its current tier, possibly fractional:
  ``fast_fraction`` of its pages on the fast tier.  Fractional residency is
  what thermos' "place a portion of a big hot site in the upper tier" needs,
  and what paged arenas (KV pools) implement natively.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional

from .sites import Site, SiteKind, SiteRegistry

PRIVATE_POOL_ID = -1
DEFAULT_PROMOTION_THRESHOLD = 4 * 2**20  # 4 MB, paper Sec. 5.3


@dataclasses.dataclass
class Arena:
    """A profiled, migratable group of data belonging to one site."""

    arena_id: int
    site: Site
    resident_bytes: int = 0
    # Fraction of resident bytes currently on the fast tier, in [0, 1].
    fast_fraction: float = 1.0
    # Cumulative access counter for the current profile epoch.
    accesses: int = 0

    @property
    def fast_bytes(self) -> int:
        return int(round(self.resident_bytes * self.fast_fraction))

    @property
    def slow_bytes(self) -> int:
        return self.resident_bytes - self.fast_bytes


class ArenaManager:
    """Implements the hybrid allocation policy over logical allocations.

    The runtime reports logical allocation events (``allocate``), frees
    (``release``) and access traffic (``touch``).  Small sites live in the
    private pool until their *cumulative* allocated bytes cross the promotion
    threshold; from then on their data belongs to a dedicated shared arena.
    (The already-pooled prefix stays in the pool, as in the paper — only *new*
    data from the promoted context flows to the shared arena.  For tensor
    arenas, where an "allocation" is one array, this means the array that
    crosses the threshold is the first one placed in the shared arena.)
    """

    def __init__(
        self,
        registry: Optional[SiteRegistry] = None,
        promotion_threshold: int = DEFAULT_PROMOTION_THRESHOLD,
        on_promote: Optional[Callable[[Arena], None]] = None,
        fast_capacity_bytes: Optional[int] = None,
    ):
        """``fast_capacity_bytes``: physical size of the fast tier.  When set,
        new allocations follow *first-touch* semantics — they land on the fast
        tier while it has room and spill to the slow tier once full (the
        paper's unguided baseline, and the placement every guided run starts
        from).  When None, everything starts fast (unconstrained)."""
        self.registry = registry if registry is not None else SiteRegistry()
        self.promotion_threshold = promotion_threshold
        self.fast_capacity_bytes = fast_capacity_bytes
        self._cumulative: Dict[int, int] = {}           # site_id -> bytes ever
        self._arenas: Dict[int, Arena] = {}             # site_id -> shared arena
        self._private_bytes: Dict[int, int] = {}        # site_id -> pooled bytes
        self._on_promote = on_promote
        self._next_arena_id = 0

    # ------------------------------------------------------------------ alloc
    def allocate(self, site: Site, nbytes: int) -> Optional[Arena]:
        """Record an allocation; returns the shared arena it landed in, or
        None if it went to the private pool."""
        if nbytes < 0:
            raise ValueError("negative allocation")
        cum = self._cumulative.get(site.site_id, 0) + nbytes
        self._cumulative[site.site_id] = cum
        arena = self._arenas.get(site.site_id)
        if arena is None:
            if cum <= self.promotion_threshold:
                self._private_bytes[site.site_id] = (
                    self._private_bytes.get(site.site_id, 0) + nbytes
                )
                return None
            arena = Arena(arena_id=self._next_arena_id, site=site, resident_bytes=0)
            self._next_arena_id += 1
            self._arenas[site.site_id] = arena
            if self._on_promote is not None:
                self._on_promote(arena)
        if self.fast_capacity_bytes is None:
            arena.resident_bytes += nbytes
            return arena
        # First-touch: the new bytes take whatever fast-tier room remains.
        free = max(0, self.fast_capacity_bytes - self.fast_tier_bytes())
        fast_take = min(nbytes, free)
        old_fast = arena.fast_bytes
        arena.resident_bytes += nbytes
        arena.fast_fraction = (
            (old_fast + fast_take) / arena.resident_bytes
            if arena.resident_bytes
            else 1.0
        )
        return arena

    def release(self, site: Site, nbytes: int) -> None:
        arena = self._arenas.get(site.site_id)
        if arena is not None:
            arena.resident_bytes = max(0, arena.resident_bytes - nbytes)
        else:
            cur = self._private_bytes.get(site.site_id, 0)
            self._private_bytes[site.site_id] = max(0, cur - nbytes)

    # ------------------------------------------------------------------ touch
    def touch(self, site: Site, accesses: int = 1) -> None:
        """Record access traffic.  Private-pool sites are not profiled."""
        arena = self._arenas.get(site.site_id)
        if arena is not None:
            arena.accesses += accesses

    # ---------------------------------------------------------------- queries
    def arena_for(self, site: Site) -> Optional[Arena]:
        return self._arenas.get(site.site_id)

    def arena_by_id(self, arena_id: int) -> Optional[Arena]:
        for a in self._arenas.values():
            if a.arena_id == arena_id:
                return a
        return None

    def arenas(self) -> List[Arena]:
        return list(self._arenas.values())

    def __iter__(self) -> Iterator[Arena]:
        return iter(self._arenas.values())

    @property
    def private_pool_bytes(self) -> int:
        return sum(self._private_bytes.values())

    @property
    def shared_bytes(self) -> int:
        return sum(a.resident_bytes for a in self._arenas.values())

    def fast_tier_bytes(self) -> int:
        """Bytes currently on the fast tier (private pool is always fast)."""
        return self.private_pool_bytes + sum(a.fast_bytes for a in self._arenas.values())

    def reset_access_counters(self) -> None:
        for a in self._arenas.values():
            a.accesses = 0

    def scale_access_counters(self, factor: float) -> None:
        """Profile reweighting hook (Algorithm 1's optional ReweightProfile)."""
        for a in self._arenas.values():
            a.accesses = int(a.accesses * factor)
