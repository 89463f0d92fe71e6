"""Ski-rental migration decision (paper Sec. 4.2, Algorithm 1).

At each interval the runtime compares:

* **rental cost** — the recurring cost of keeping the current placement:
  ``(a - b) * EXTRA_NS_PER_SLOWER_ACCESS`` where ``a`` counts accesses served
  by the slow tier that the recommended placement would serve from the fast
  tier, and ``b`` the converse.  Because access counters accumulate from the
  start of execution (no reweighting by default), this *is* the cumulative
  rental cost the break-even algorithm requires.

* **purchase cost** — the one-time cost of enforcing the recommendation:
  pages that would move (either direction) times ``NS_PER_PAGE_MOVED``.

Migration happens iff rental > purchase — the deterministic break-even rule,
which is 2-competitive for ski rental.

Fractional residency generalizes the paper's 0/1 tiers: an arena with
``fast_fraction`` f serves accesses from the fast tier with probability f
(accesses are assumed uniform over the arena's bytes, which is exactly the
assumption site-granularity management makes in the paper).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .hwmodel import HardwareModel
from .profiler import IntervalProfile
from .recommend import TierAssignment


@dataclasses.dataclass(frozen=True)
class MigrationDecision:
    rental_cost_ns: float
    purchase_cost_ns: float
    bytes_to_move: int
    pages_to_move: int
    migrate: bool

    @property
    def ratio(self) -> float:
        return (
            self.rental_cost_ns / self.purchase_cost_ns
            if self.purchase_cost_ns > 0
            else float("inf")
        )


def get_rental_cost(
    profile: IntervalProfile, recs: TierAssignment, hw: HardwareModel
) -> float:
    a = 0.0  # slow-tier accesses that recs would serve from fast
    b = 0.0  # fast-tier accesses that recs would push to slow
    for r in profile.rows:
        rec = recs.fast_fraction(r.arena_id)
        cur = r.fast_fraction
        if rec > cur:
            a += r.accesses * (rec - cur)
        elif cur > rec:
            b += r.accesses * (cur - rec)
    if a > b:
        return (a - b) * hw.extra_ns_per_slow_access
    return 0.0


def get_purchase_cost(
    profile: IntervalProfile, recs: TierAssignment, hw: HardwareModel
) -> float:
    return _move_cost_ns(profile, recs, hw)


def _move_cost_ns(
    profile: IntervalProfile, recs: TierAssignment, hw: HardwareModel
) -> float:
    total_pages = 0
    for r in profile.rows:
        delta = abs(recs.fast_fraction(r.arena_id) - r.fast_fraction)
        nbytes = int(delta * r.resident_bytes)
        if nbytes:
            total_pages += hw.pages(nbytes)
    return total_pages * hw.ns_per_page_moved


def get_move_bytes(profile: IntervalProfile, recs: TierAssignment) -> int:
    total = 0
    for r in profile.rows:
        delta = abs(recs.fast_fraction(r.arena_id) - r.fast_fraction)
        total += int(delta * r.resident_bytes)
    return total


def decide(
    profile: IntervalProfile,
    recs: TierAssignment,
    hw: HardwareModel,
    min_move_bytes: int = 0,
) -> MigrationDecision:
    """Algorithm 1's MaybeMigrate comparison (without the enforcement)."""
    rental = get_rental_cost(profile, recs, hw)
    bytes_to_move = get_move_bytes(profile, recs)
    purchase = _move_cost_ns(profile, recs, hw)
    migrate = rental > purchase and bytes_to_move > min_move_bytes
    return MigrationDecision(
        rental_cost_ns=rental,
        purchase_cost_ns=purchase,
        bytes_to_move=bytes_to_move,
        pages_to_move=hw.pages(bytes_to_move) if bytes_to_move else 0,
        migrate=migrate,
    )
