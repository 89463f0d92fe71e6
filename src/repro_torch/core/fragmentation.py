"""Site fragmentation (beyond-paper; the paper's Sec. 6.3 / Sec. 7 future work).

The paper's QMCPACK pathology: one allocation site owns 60-63% of resident
data and is the hottest site *on average*, so site-granularity guidance pins
all of it to the fast tier even when much of it is momentarily cold — and
hardware caching wins.  The authors propose "fragmenting large sets of data
created from the same site into separate sets based on different data
features, such as the age of the data".

This module implements exactly that: an arena with per-chunk telemetry
(chunk = KV page, array, or simulated page run) is *exploded* into
age-quantile sub-arenas that the recommendation engines see as independent
rows, then the resulting fractions are *collapsed* back into per-chunk
placements (hottest chunks first within each fragment).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from .profiler import ArenaProfile, IntervalProfile

# Synthetic arena-id space for fragments; real arena ids stay well below this.
FRAGMENT_ID_BASE = 1 << 30


@dataclasses.dataclass
class ChunkStats:
    """Telemetry for one migratable chunk of a big arena."""

    chunk_id: int
    nbytes: int
    accesses: int
    age: int            # intervals since allocation (larger = older)
    fast: bool = True   # current placement


@dataclasses.dataclass
class Fragment:
    fragment_id: int
    parent_arena_id: int
    chunks: List[ChunkStats]

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.chunks)

    @property
    def accesses(self) -> int:
        return sum(c.accesses for c in self.chunks)

    @property
    def fast_fraction(self) -> float:
        total = self.nbytes
        if total == 0:
            return 1.0
        return sum(c.nbytes for c in self.chunks if c.fast) / total

    def to_row(self) -> ArenaProfile:
        return ArenaProfile(
            arena_id=self.fragment_id,
            site_id=-1,
            label=f"frag:{self.parent_arena_id}:{self.fragment_id - FRAGMENT_ID_BASE}",
            accesses=self.accesses,
            resident_bytes=self.nbytes,
            fast_fraction=self.fast_fraction,
        )


def fragment_by_age(
    parent_arena_id: int,
    chunks: Sequence[ChunkStats],
    num_fragments: int,
    id_offset: int = 0,
) -> List[Fragment]:
    """Split chunks into up to ``num_fragments`` age-quantile groups."""
    if num_fragments < 1:
        raise ValueError("num_fragments must be >= 1")
    ordered = sorted(chunks, key=lambda c: (c.age, c.chunk_id))
    n = len(ordered)
    k = min(num_fragments, n) if n else 0
    fragments: List[Fragment] = []
    for j in range(k):
        lo = (n * j) // k
        hi = (n * (j + 1)) // k
        fragments.append(
            Fragment(
                fragment_id=FRAGMENT_ID_BASE + id_offset + j,
                parent_arena_id=parent_arena_id,
                chunks=list(ordered[lo:hi]),
            )
        )
    return fragments


def explode_profile(
    profile: IntervalProfile,
    telemetry: Dict[int, Sequence[ChunkStats]],
    num_fragments: int = 4,
    min_bytes_to_fragment: int = 0,
) -> Tuple[IntervalProfile, List[Fragment]]:
    """Replace rows that have chunk telemetry with their fragments."""
    rows: List[ArenaProfile] = []
    fragments: List[Fragment] = []
    offset = 0
    for row in profile.rows:
        chunks = telemetry.get(row.arena_id)
        if not chunks or row.resident_bytes < min_bytes_to_fragment:
            rows.append(row)
            continue
        frags = fragment_by_age(row.arena_id, chunks, num_fragments, id_offset=offset)
        offset += len(frags)
        fragments.extend(frags)
        rows.extend(f.to_row() for f in frags)
    exploded = IntervalProfile(
        interval_index=profile.interval_index,
        rows=rows,
        private_pool_bytes=profile.private_pool_bytes,
        collection_seconds=profile.collection_seconds,
    )
    return exploded, fragments


def collapse_to_chunks(
    fragments: Sequence[Fragment],
    fractions: Dict[int, float],
) -> Dict[int, bool]:
    """Map fragment fast-fractions back to per-chunk placement.

    Within a fragment the hottest chunks claim the fast bytes first.  Returns
    chunk_id -> should-be-fast.
    """
    placement: Dict[int, bool] = {}
    for frag in fragments:
        frac = fractions.get(frag.fragment_id, 0.0)
        budget = int(frac * frag.nbytes)
        for c in sorted(
            frag.chunks,
            key=lambda c: (-(c.accesses / c.nbytes if c.nbytes else 0.0), c.chunk_id),
        ):
            if budget >= c.nbytes and c.nbytes > 0:
                placement[c.chunk_id] = True
                budget -= c.nbytes
            else:
                placement[c.chunk_id] = False
    return placement


def parent_fractions(
    fragments: Sequence[Fragment], placement: Dict[int, bool]
) -> Dict[int, float]:
    """Aggregate chunk placement back to per-parent-arena fast fractions."""
    by_parent: Dict[int, Tuple[int, int]] = {}
    for frag in fragments:
        fast_b, tot_b = by_parent.get(frag.parent_arena_id, (0, 0))
        for c in frag.chunks:
            tot_b += c.nbytes
            if placement.get(c.chunk_id, c.fast):
                fast_b += c.nbytes
        by_parent[frag.parent_arena_id] = (fast_b, tot_b)
    return {
        pid: (fast / tot if tot else 1.0) for pid, (fast, tot) in by_parent.items()
    }
