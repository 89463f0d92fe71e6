"""Online memory-usage profiling (paper Sec. 4.1).

The profiler produces, at each decision interval, a snapshot of every shared
arena: its access count since profiling began (the paper never reweights by
default, Sec. 4.2) and its exact resident bytes per tier.  Access counts come
from the runtime's access model / device counters rather than PEBS samples —
see DESIGN.md Sec. 2 — but the downstream interface is identical to the
paper's: ``(site, cur_tier, accs, pages)`` tuples.

The profiler also times its own aggregation work so the framework can report
the per-interval profiling cost (the Table 2 measurement).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from .arenas import Arena, ArenaManager
from .hwmodel import HardwareModel


@dataclasses.dataclass(frozen=True)
class ArenaProfile:
    """One row of an interval profile — mirrors Algorithm 1's tuple."""

    arena_id: int
    site_id: int
    label: str
    accesses: int
    resident_bytes: int
    fast_fraction: float

    @property
    def fast_bytes(self) -> int:
        return int(round(self.resident_bytes * self.fast_fraction))

    @property
    def slow_bytes(self) -> int:
        return self.resident_bytes - self.fast_bytes

    def density(self) -> float:
        """Accesses per byte — the sort key for hotset/thermos."""
        return self.accesses / self.resident_bytes if self.resident_bytes else 0.0


@dataclasses.dataclass
class IntervalProfile:
    """Snapshot of all shared arenas at one decision interval."""

    interval_index: int
    rows: List[ArenaProfile]
    private_pool_bytes: int
    collection_seconds: float

    def by_arena(self) -> Dict[int, ArenaProfile]:
        return {r.arena_id: r for r in self.rows}

    @property
    def total_bytes(self) -> int:
        return sum(r.resident_bytes for r in self.rows)

    @property
    def total_accesses(self) -> int:
        return sum(r.accesses for r in self.rows)


class OnlineProfiler:
    """Aggregates arena state into interval profiles.

    ``decay`` implements the optional ReweightProfile step of Algorithm 1:
    after every snapshot the accumulated access counters are multiplied by
    ``decay``.  The paper's evaluated configuration never reweights
    (``decay=1.0``), which is our default too.
    """

    def __init__(
        self,
        arenas: ArenaManager,
        hw: HardwareModel,
        decay: float = 1.0,
    ):
        if not (0.0 <= decay <= 1.0):
            raise ValueError("decay must be in [0, 1]")
        self.arenas = arenas
        self.hw = hw
        self.decay = decay
        self._interval = 0
        self.collection_times: List[float] = []

    def snapshot(self) -> IntervalProfile:
        t0 = time.perf_counter()
        rows = [
            ArenaProfile(
                arena_id=a.arena_id,
                site_id=a.site.site_id,
                label=a.site.label,
                accesses=a.accesses,
                resident_bytes=a.resident_bytes,
                fast_fraction=a.fast_fraction,
            )
            for a in self.arenas
        ]
        prof = IntervalProfile(
            interval_index=self._interval,
            rows=rows,
            private_pool_bytes=self.arenas.private_pool_bytes,
            collection_seconds=0.0,
        )
        if self.decay < 1.0:
            self.arenas.scale_access_counters(self.decay)
        elapsed = time.perf_counter() - t0
        prof = dataclasses.replace(prof, collection_seconds=elapsed)
        self.collection_times.append(elapsed)
        self._interval += 1
        return prof

    @property
    def mean_collection_seconds(self) -> float:
        return (
            sum(self.collection_times) / len(self.collection_times)
            if self.collection_times
            else 0.0
        )

    @property
    def max_collection_seconds(self) -> float:
        return max(self.collection_times) if self.collection_times else 0.0
