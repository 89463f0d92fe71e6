"""repro_torch.core — the paper's contribution: online application guidance
for heterogeneous memory.  A framework-free copy of ``repro.core``, so the
PyTorch port imports without JAX; it adds the ``H100`` hardware model, and
``placement.TorchArenaPlacer`` takes the place of ``JaxArenaPlacer``
(import it from ``core.placement``).

The online loop (Algorithm 1) is owned by a single controller,
``runtime.GuidanceRuntime``, which drives pluggable ``TierBackend``
implementations — arenas, paged KV pools, the calibrated simulator.  See DESIGN.md at the repository root for the architecture and
the backend contract.
"""

from .arenas import Arena, ArenaManager, DEFAULT_PROMOTION_THRESHOLD
from .fragmentation import (
    ChunkStats,
    Fragment,
    collapse_to_chunks,
    explode_profile,
    fragment_by_age,
    parent_fractions,
)
from .hwmodel import CLX, H100, TPU_V5E, HardwareModel, TierSpec, h100
from .profiler import ArenaProfile, IntervalProfile, OnlineProfiler
from .recommend import TierAssignment, hotset, knapsack, recommend, thermos
from .runtime import (
    ArenaBackend,
    FractionPlacer,
    GuidanceConfig,
    GuidanceRuntime,
    IntervalEvent,
    MigrationPlan,
    MoveStats,
    RentalEvent,
    TierBackend,
    TierPlacer,
    static_plan,
)
from .sites import Site, SiteKind, SiteRegistry
from .skirental import MigrationDecision, decide, get_purchase_cost, get_rental_cost

__all__ = [
    "Arena",
    "ArenaBackend",
    "ArenaManager",
    "ArenaProfile",
    "CLX",
    "ChunkStats",
    "DEFAULT_PROMOTION_THRESHOLD",
    "FractionPlacer",
    "H100",
    "Fragment",
    "GuidanceConfig",
    "GuidanceRuntime",
    "HardwareModel",
    "IntervalEvent",
    "IntervalProfile",
    "MigrationDecision",
    "MigrationPlan",
    "MoveStats",
    "OnlineProfiler",
    "RentalEvent",
    "Site",
    "SiteKind",
    "SiteRegistry",
    "TPU_V5E",
    "TierAssignment",
    "TierBackend",
    "TierPlacer",
    "TierSpec",
    "collapse_to_chunks",
    "decide",
    "explode_profile",
    "fragment_by_age",
    "get_purchase_cost",
    "get_rental_cost",
    "h100",
    "hotset",
    "knapsack",
    "parent_fractions",
    "recommend",
    "static_plan",
    "thermos",
]
