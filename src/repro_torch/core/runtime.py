"""GuidanceRuntime — the single owner of Algorithm 1 (paper Sec. 4.2-4.3).

One online loop drives every workload in the framework:

    profile -> (optional) fragment -> recommend -> ski-rental decide
            -> enforce -> record

Consumers plug in through the ``TierBackend`` protocol instead of
re-implementing the loop:

* ``snapshot() -> IntervalProfile`` — per-arena access/residency rows,
* ``telemetry() -> {arena_id: [ChunkStats]}`` — *optional* per-chunk stats;
  when present, the runtime explodes big arenas into age-quantile fragments
  (Sec. 6.3 fix) and collapses the recommendation back to chunk placement —
  fragmentation lives in the core loop, not in callers,
* ``enforce(plan) -> MoveStats`` — realize a ``MigrationPlan`` physically,
* ``reweight(decay)`` — Algorithm 1's optional ReweightProfile step.

Three backends ship with the framework: ``ArenaBackend`` (trainer path:
``FractionPlacer`` over an ``ArenaManager``),
``serve.engine.PagedKVBackend`` (KV pages of the serving engine) and
``mem.simulator.SimArenaBackend`` (the calibrated reproduction rig).

All telemetry that used to be scattered across consumers (per-interval
record history, ``Engine.decisions``, swap-in counters) flows into one
structured event stream (``events``: ``IntervalEvent`` / ``RentalEvent``)
consumed by ``launch.analysis.guidance_summary`` and the benchmarks.

The seed controller's deprecated alias (DESIGN.md §8) is gone: construct
``GuidanceRuntime`` over the backend you need.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Protocol, Sequence

from .arenas import ArenaManager
from .fragmentation import (
    FRAGMENT_ID_BASE,
    ChunkStats,
    Fragment,
    collapse_to_chunks,
    explode_profile,
    parent_fractions,
)
from .hwmodel import HardwareModel
from .profiler import IntervalProfile, OnlineProfiler
from .recommend import TierAssignment, recommend
from .skirental import MigrationDecision, decide


# ------------------------------------------------------------------ config
@dataclasses.dataclass
class GuidanceConfig:
    """Knobs of Algorithm 1."""

    strategy: str = "thermos"           # paper default (Sec. 5.3)
    fast_capacity_bytes: int = 0        # budget for the fast tier
    interval_steps: int = 10            # decision interval, in runtime steps
    decay: float = 1.0                  # ReweightProfile factor (1.0 = paper)
    min_move_bytes: int = 0             # ignore micro-migrations
    promotion_threshold: int = 4 * 2**20  # hybrid-arena threshold (Sec. 5.3)
    enabled: bool = True
    num_fragments: int = 4              # age quantiles when telemetry exists
    skip_empty_intervals: bool = False  # no event when the profile is empty

    def __post_init__(self):
        if not (0.0 <= self.decay <= 1.0):
            raise ValueError("decay must be in [0, 1]")


# ------------------------------------------------------------------- stats
@dataclasses.dataclass
class MoveStats:
    """What one enforcement actually moved."""

    bytes_demoted: int = 0       # fast -> slow
    bytes_promoted: int = 0      # slow -> fast
    dropped_promotions: int = 0  # planned promotions refused for capacity

    @property
    def bytes_moved(self) -> int:
        return self.bytes_demoted + self.bytes_promoted


# -------------------------------------------------------------------- plan
@dataclasses.dataclass
class MigrationPlan:
    """Everything a backend needs to realize one interval's decision.

    ``fractions`` is the per-(parent-)arena fast-fraction target; for
    backends with chunk telemetry, ``chunk_placement`` maps each chunk id to
    its recommended tier (hottest chunks claim the fast bytes first).
    """

    profile: IntervalProfile            # the raw (unexploded) snapshot
    exploded: IntervalProfile           # post-fragmentation view
    fragments: List[Fragment]
    assignment: TierAssignment          # recommendation over ``exploded``
    decision: MigrationDecision
    fractions: Dict[int, float]         # arena_id -> target fast fraction
    chunk_placement: Dict[int, bool]    # chunk_id -> should-be-fast
    capacity_bytes: int
    strategy: str

    def fast_fraction(self, arena_id: int) -> float:
        """Target fraction for one arena (0.0 when not recommended) — the
        same accessor ``TierAssignment`` offers, so placers accept either."""
        return self.fractions.get(arena_id, 0.0)


# ------------------------------------------------------------------ events
@dataclasses.dataclass
class IntervalEvent:
    """One MaybeMigrate invocation of the controller loop."""

    interval_index: int
    decision: MigrationDecision
    migrated: bool
    bytes_moved: int
    fast_bytes_after: int
    profile_seconds: float
    step: int = -1                      # backend step clock, if provided
    backend: str = ""
    dropped_promotions: int = 0
    # The full plan (profiles, fragments, chunk placement) is retained only
    # on the MOST RECENT interval event; the runtime strips it from older
    # events so a long-lived stream stays scalar-sized.
    plan: Optional[MigrationPlan] = None
    kind: str = "interval"


@dataclasses.dataclass
class RentalEvent:
    """A between-intervals rental payment (e.g. a demand swap-in)."""

    step: int
    nbytes: int
    source: str = "swap_in"
    kind: str = "rental"


GuidanceEvent = object  # IntervalEvent | RentalEvent (discriminated by .kind)


# ---------------------------------------------------------------- protocol
class TierBackend(Protocol):
    """What a consumer implements to be driven by ``GuidanceRuntime``."""

    def snapshot(self) -> IntervalProfile:  # pragma: no cover - protocol
        ...

    def telemetry(self) -> Mapping[int, Sequence[ChunkStats]]:  # pragma: no cover
        """Per-arena chunk stats; empty mapping disables fragmentation."""
        ...

    def enforce(self, plan: MigrationPlan) -> MoveStats:  # pragma: no cover
        ...

    def reweight(self, decay: float) -> None:  # pragma: no cover - protocol
        ...


class TierPlacer(Protocol):
    """Arena-granularity enforcement primitive (``FractionPlacer`` family)."""

    def enforce(self, profile: IntervalProfile, recs) -> MoveStats:  # pragma: no cover
        ...


# ---------------------------------------------------------------- placers
class FractionPlacer:
    """Bookkeeping-only placer: updates arena fast fractions.

    Used by the simulator (which charges migration time itself) and as the
    base class for real placers.  Enforcement order follows the paper:
    demotions (fast->slow) first to free space, then promotions.  ``recs``
    may be a ``TierAssignment`` or a ``MigrationPlan`` — anything with a
    ``fast_fraction(arena_id)`` accessor.
    """

    def __init__(self, arenas: ArenaManager):
        self.arenas = arenas

    def _apply(self, arena_id: int, new_fraction: float) -> None:
        # Subclasses move real data here.
        pass

    def enforce(self, profile: IntervalProfile, recs) -> MoveStats:
        stats = MoveStats()
        by_id = {a.arena_id: a for a in self.arenas}
        demotions = []
        promotions = []
        for row in profile.rows:
            arena = by_id.get(row.arena_id)
            if arena is None:
                continue
            target = recs.fast_fraction(row.arena_id)
            delta = target - arena.fast_fraction
            moved = abs(int(delta * arena.resident_bytes))
            if moved == 0:
                continue
            (demotions if delta < 0 else promotions).append((arena, target, moved))
        for arena, target, moved in demotions:     # free space first
            self._apply(arena.arena_id, target)
            arena.fast_fraction = target
            stats.bytes_demoted += moved
        for arena, target, moved in promotions:
            self._apply(arena.arena_id, target)
            arena.fast_fraction = target
            stats.bytes_promoted += moved
        return stats


# ---------------------------------------------------------------- backends
class ArenaBackend:
    """TierBackend over an ``ArenaManager`` + ``TierPlacer`` (trainer path).

    ``FractionPlacer`` keeps it bookkeeping-only; a placer that moves real
    tensors between tiers plugs in through ``TierPlacer``.
    """

    name = "arena"

    def __init__(
        self,
        arenas: ArenaManager,
        hw: HardwareModel,
        placer: Optional[TierPlacer] = None,
    ):
        self.arenas = arenas
        self.placer: TierPlacer = placer if placer is not None else FractionPlacer(arenas)
        # Decay is owned by the runtime (reweight); the profiler never decays.
        self.profiler = OnlineProfiler(arenas, hw, decay=1.0)

    def snapshot(self) -> IntervalProfile:
        return self.profiler.snapshot()

    def telemetry(self) -> Mapping[int, Sequence[ChunkStats]]:
        return {}

    def enforce(self, plan: MigrationPlan) -> MoveStats:
        return self.placer.enforce(plan.profile, plan)

    def reweight(self, decay: float) -> None:
        self.arenas.scale_access_counters(decay)

    def fast_bytes(self) -> int:
        return self.arenas.fast_tier_bytes()


# ----------------------------------------------------------------- runtime
class GuidanceRuntime:
    """The online loop of Algorithm 1, driven by runtime step hooks.

    Host-side Python that runs *between* steps (the analogue of the paper's
    runtime thread waking at IntervalTime).  Owns interval gating, profile
    fragmentation, recommendation, the ski-rental break-even rule, the
    enforcement dispatch and the telemetry stream; the backend owns only
    mechanism (how to observe and how to move bytes).
    """

    def __init__(
        self,
        backend: TierBackend,
        hw: HardwareModel,
        config: GuidanceConfig,
        clock: Optional[Callable[[], int]] = None,
    ):
        self.backend = backend
        self.hw = hw
        self.config = config
        self.clock = clock
        self.events: List[object] = []
        self.side_table: Dict[int, float] = {}  # arena_id -> enforced fraction
        self.last_plan: Optional[MigrationPlan] = None
        self._steps_since_interval = 0

    # ------------------------------------------------------------------ hooks
    def on_step(self) -> Optional[IntervalEvent]:
        """Call once per runtime step; fires MaybeMigrate at the interval."""
        if not self.config.enabled:
            return None
        self._steps_since_interval += 1
        if self._steps_since_interval < self.config.interval_steps:
            return None
        self._steps_since_interval = 0
        return self.maybe_migrate()

    # ------------------------------------------------------------ MaybeMigrate
    def maybe_migrate(self) -> Optional[IntervalEvent]:
        profile = self.backend.snapshot()
        if not profile.rows and self.config.skip_empty_intervals:
            return None
        telemetry = self._collect_telemetry()
        if telemetry:
            exploded, fragments = explode_profile(
                profile, telemetry, num_fragments=self.config.num_fragments)
        else:
            exploded, fragments = profile, []
        if self.config.decay < 1.0:       # ReweightProfile (Sec. 4.2)
            self.backend.reweight(self.config.decay)
        recs = recommend(exploded, self.config.fast_capacity_bytes,
                         self.config.strategy)
        decision = decide(exploded, recs, self.hw, self.config.min_move_bytes)
        plan = self._build_plan(profile, exploded, fragments, recs, decision)
        self.last_plan = plan
        on_plan = getattr(self.backend, "on_plan", None)
        if on_plan is not None:           # optional backend hook (every interval)
            on_plan(plan)
        stats = MoveStats()
        if decision.migrate:
            stats = self.backend.enforce(plan)
            self.side_table.update(plan.fractions)
        event = IntervalEvent(
            interval_index=profile.interval_index,
            decision=decision,
            migrated=decision.migrate,
            bytes_moved=stats.bytes_moved,
            fast_bytes_after=self._fast_bytes(),
            profile_seconds=profile.collection_seconds,
            step=self.clock() if self.clock is not None else -1,
            backend=getattr(self.backend, "name", type(self.backend).__name__),
            dropped_promotions=stats.dropped_promotions,
            plan=plan,
        )
        # Keep the heavy plan payload only on the newest event: an engine
        # firing every interval for hours must not accumulate per-chunk
        # telemetry in the history (scalar fields are kept forever).
        for prior in reversed(self.events):
            if getattr(prior, "kind", "") == "interval":
                prior.plan = None
                break
        self.events.append(event)
        return event

    def _collect_telemetry(self) -> Mapping[int, Sequence[ChunkStats]]:
        fn = getattr(self.backend, "telemetry", None)
        if fn is None or self.config.num_fragments < 1:
            return {}
        return fn() or {}

    def _build_plan(self, profile, exploded, fragments, recs, decision) -> MigrationPlan:
        if fragments:
            chunk_placement = collapse_to_chunks(fragments, recs.fractions)
            fractions = {aid: f for aid, f in recs.fractions.items()
                         if aid < FRAGMENT_ID_BASE}
            fractions.update(parent_fractions(fragments, chunk_placement))
        else:
            chunk_placement = {}
            fractions = dict(recs.fractions)
        return MigrationPlan(
            profile=profile, exploded=exploded, fragments=list(fragments),
            assignment=recs, decision=decision, fractions=fractions,
            chunk_placement=chunk_placement,
            capacity_bytes=self.config.fast_capacity_bytes,
            strategy=self.config.strategy,
        )

    def _fast_bytes(self) -> int:
        fn = getattr(self.backend, "fast_bytes", None)
        return int(fn()) if fn is not None else 0

    # ------------------------------------------------------------- telemetry
    def record_rental(self, nbytes: int, source: str = "swap_in",
                      step: Optional[int] = None) -> None:
        """Log a between-intervals rental payment (demand swap-in etc.)."""
        if step is None:
            step = self.clock() if self.clock is not None else -1
        self.events.append(RentalEvent(step=step, nbytes=nbytes, source=source))

    @property
    def history(self) -> List[IntervalEvent]:
        return [e for e in self.events if getattr(e, "kind", "") == "interval"]

    @property
    def decisions(self) -> List[MigrationDecision]:
        return [e.decision for e in self.history]

    @property
    def rentals(self) -> List[RentalEvent]:
        return [e for e in self.events if getattr(e, "kind", "") == "rental"]

    @property
    def total_bytes_migrated(self) -> int:
        return sum(e.bytes_moved for e in self.history)

    @property
    def migration_count(self) -> int:
        return sum(1 for e in self.history if e.migrated)


# ------------------------------------------------------------ offline path
def static_plan(
    profile: IntervalProfile, capacity_bytes: int, strategy: str = "thermos"
) -> TierAssignment:
    """Offline MemBrain: one-shot recommendation over a whole-run profile.

    No ski-rental gate and no enforcement — callers (the simulator's offline
    oracle, dry-run planners) apply the returned fractions statically.  This
    is the only sanctioned entry to the recommendation engines outside the
    online loop.
    """
    return recommend(profile, capacity_bytes, strategy)
