"""Tier-recommendation engines (paper Sec. 3.2.1, from MemBrain).

Three strategies convert an interval profile into per-arena tier
recommendations for the fast tier of capacity ``C``:

* ``knapsack`` — 0/1 knapsack: value = access count, weight = resident bytes,
  capacity = C.  Exact DP when the scaled problem is small enough, otherwise
  the classical greedy-by-density approximation (which is also what makes
  knapsack's known weakness — rejecting a huge, hot site outright — visible).

* ``hotset``  — sort by accesses-per-byte, select until the aggregate size
  *first exceeds* C (intentional over-prescription).

* ``thermos`` — hotset that admits a capacity-crossing site only when the
  value it contributes exceeds the aggregate value of the hottest bytes it
  may displace; big high-bandwidth sites may keep a *portion* of their data
  in the fast tier.

Recommendations are expressed as ``TierAssignment``: arena_id -> fraction of
that arena's bytes recommended for the fast tier.  ``raw`` keeps the
un-clipped (possibly over-prescribed) 0/1 selection for analysis; ``fractions``
is clipped so that recommended fast bytes never exceed C — that is what
enforcement and the ski-rental cost model consume.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

from .profiler import ArenaProfile, IntervalProfile

Fraction = float


@dataclasses.dataclass(frozen=True)
class TierAssignment:
    capacity_bytes: int
    fractions: Dict[int, Fraction]   # arena_id -> fraction on fast tier
    raw: Dict[int, Fraction]         # pre-clip selection (may over-prescribe)
    strategy: str

    def fast_fraction(self, arena_id: int) -> Fraction:
        return self.fractions.get(arena_id, 0.0)

    def fast_bytes(self, profile_rows: Sequence[ArenaProfile]) -> int:
        return int(
            sum(r.resident_bytes * self.fast_fraction(r.arena_id) for r in profile_rows)
        )


def _sorted_by_density(rows: Sequence[ArenaProfile]) -> List[ArenaProfile]:
    # Hot first; break ties toward smaller sites (cheaper to keep fast).
    return sorted(rows, key=lambda r: (-r.density(), r.resident_bytes, r.arena_id))


def _clip_to_capacity(
    rows: Sequence[ArenaProfile],
    selection: Dict[int, Fraction],
    capacity: int,
) -> Dict[int, Fraction]:
    """Turn a possibly over-prescribed 0/1 selection into fractions whose
    fast-tier bytes fit in ``capacity``: hottest sites keep full residency,
    the site that crosses the boundary keeps the remaining portion."""
    out: Dict[int, Fraction] = {}
    free = capacity
    for r in _sorted_by_density(rows):
        frac = selection.get(r.arena_id, 0.0)
        if frac <= 0.0 or r.resident_bytes == 0:
            continue
        want = int(r.resident_bytes * frac)
        take = min(want, max(free, 0))
        if take > 0:
            out[r.arena_id] = take / r.resident_bytes
            free -= take
        if free <= 0:
            break
    return out


# ----------------------------------------------------------------- knapsack
_DP_MAX_CELLS = 4_000_000


def knapsack(profile: IntervalProfile, capacity_bytes: int) -> TierAssignment:
    rows = [r for r in profile.rows if r.resident_bytes > 0]
    raw: Dict[int, Fraction] = {}
    if rows and capacity_bytes > 0 and sum(r.resident_bytes for r in rows) <= capacity_bytes:
        raw = {r.arena_id: 1.0 for r in rows}   # everything fits
    elif rows and capacity_bytes > 0:
        # Scale weights so an exact DP stays tractable; fall back to greedy.
        unit = max(1, -(-capacity_bytes // max(1, _DP_MAX_CELLS // max(1, len(rows)))))
        cap_units = capacity_bytes // unit
        if cap_units >= 1 and len(rows) * (cap_units + 1) <= _DP_MAX_CELLS:
            raw = _knapsack_dp(rows, unit, cap_units)
        else:
            raw = _knapsack_greedy(rows, capacity_bytes)
    return TierAssignment(
        capacity_bytes=capacity_bytes,
        fractions=_clip_to_capacity(profile.rows, raw, capacity_bytes),
        raw=raw,
        strategy="knapsack",
    )


def _knapsack_dp(
    rows: Sequence[ArenaProfile], unit: int, cap_units: int
) -> Dict[int, Fraction]:
    n = len(rows)
    weights = [-(-r.resident_bytes // unit) for r in rows]  # ceil: never overfill
    values = [r.accesses for r in rows]
    # dp[c] = best value with capacity c; keep[i][c] via parent pointers.
    dp = [0] * (cap_units + 1)
    keep = [[False] * (cap_units + 1) for _ in range(n)]
    for i in range(n):
        w, v = weights[i], values[i]
        if w > cap_units:
            continue
        for c in range(cap_units, w - 1, -1):
            cand = dp[c - w] + v
            if cand > dp[c]:
                dp[c] = cand
                keep[i][c] = True
    out: Dict[int, Fraction] = {}
    c = cap_units
    for i in range(n - 1, -1, -1):
        if keep[i][c]:
            out[rows[i].arena_id] = 1.0
            c -= weights[i]
    return out


def _knapsack_greedy(
    rows: Sequence[ArenaProfile], capacity_bytes: int
) -> Dict[int, Fraction]:
    out: Dict[int, Fraction] = {}
    free = capacity_bytes
    for r in _sorted_by_density(rows):
        if r.resident_bytes <= free:   # 0/1: whole site or nothing
            out[r.arena_id] = 1.0
            free -= r.resident_bytes
    return out


# ------------------------------------------------------------------- hotset
def hotset(profile: IntervalProfile, capacity_bytes: int) -> TierAssignment:
    rows = [r for r in profile.rows if r.resident_bytes > 0]
    raw: Dict[int, Fraction] = {}
    used = 0
    for r in _sorted_by_density(rows):
        if used > capacity_bytes:
            break                       # stop after first crossing (Sec. 3.2.1)
        raw[r.arena_id] = 1.0
        used += r.resident_bytes
    return TierAssignment(
        capacity_bytes=capacity_bytes,
        fractions=_clip_to_capacity(profile.rows, raw, capacity_bytes),
        raw=raw,
        strategy="hotset",
    )


# ------------------------------------------------------------------ thermos
def thermos(profile: IntervalProfile, capacity_bytes: int) -> TierAssignment:
    rows = [r for r in profile.rows if r.resident_bytes > 0]
    raw: Dict[int, Fraction] = {}
    used = 0
    selected: List[ArenaProfile] = []
    for r in _sorted_by_density(rows):
        free = capacity_bytes - used
        if r.resident_bytes <= free:
            raw[r.arena_id] = 1.0
            selected.append(r)
            used += r.resident_bytes
            continue
        # Crossing the cap: admitting r may displace up to ``overflow`` bytes
        # of already-selected (hotter) data.  Admit only if r's contribution
        # beats the hottest bytes it could crowd out.
        overflow = r.resident_bytes - max(free, 0)
        displaced_value = _hottest_bytes_value(selected, overflow)
        if r.accesses > displaced_value:
            raw[r.arena_id] = 1.0
            selected.append(r)
            used += r.resident_bytes
        # else: skip r; colder-but-smaller sites may still fit the free space.
    return TierAssignment(
        capacity_bytes=capacity_bytes,
        fractions=_clip_to_capacity(profile.rows, raw, capacity_bytes),
        raw=raw,
        strategy="thermos",
    )


def _hottest_bytes_value(selected: Sequence[ArenaProfile], nbytes: int) -> float:
    """Aggregate access-value of the hottest ``nbytes`` among selected rows."""
    if nbytes <= 0:
        return 0.0
    total = 0.0
    remaining = nbytes
    for r in sorted(selected, key=lambda r: -r.density()):
        take = min(remaining, r.resident_bytes)
        total += take * r.density()
        remaining -= take
        if remaining <= 0:
            break
    return total


STRATEGIES: Dict[str, Callable[[IntervalProfile, int], TierAssignment]] = {
    "knapsack": knapsack,
    "hotset": hotset,
    "thermos": thermos,
}


def recommend(
    profile: IntervalProfile, capacity_bytes: int, strategy: str = "thermos"
) -> TierAssignment:
    try:
        fn = STRATEGIES[strategy]
    except KeyError:
        raise ValueError(
            f"unknown strategy {strategy!r}; expected one of {sorted(STRATEGIES)}"
        ) from None
    return fn(profile, capacity_bytes)
