"""Trace-driven two-tier memory simulator — the faithful-reproduction rig
(``repro/mem/simulator.py``, a framework-free copy: the port imports
nothing of ``repro``).

The paper's evaluation platform (Sec. 5.1, Optane DIMMs behind DRAM) is
reproduced as a calibrated discrete-time model.  The *policies* under test
are the real framework code: the online policy runs the port's own
``repro_torch.core`` stack (hybrid arenas -> online profiler -> thermos ->
ski-rental -> enforcement); the simulator only supplies the timing model that
real hardware would.

Timing model (per phase of nominal ``phase_seconds`` compute):

  wall = max(compute, mem_stall) + migration_stall + profile_overhead

  mem_stall  = sum over sites of   read_f/BWr_f + read_s/BWr_s
                                 + write_f/BWw_f + write_s/BWw_s
                                 + slow_rand_reads * extra_latency / MLP

where the fast/slow traffic split follows the site's current placement at
*page-group* granularity: each site divides into a hot page group
(``hot_page_frac`` of bytes receiving ``hot_traffic_frac`` of traffic) and a
cold group.  Site-granularity policies place bytes without seeing the groups
(fast fraction f covers the hot group first only by luck of fraction size —
we model placement as byte-uniform: traffic served fast = f-weighted mix);
page-granularity mechanisms (hardware caching, fragmentation) exploit them.

The numbers in ``hwmodel.CLX`` come straight from the paper: +300 ns Optane
read latency, 2 us per 4 KB page moved, 30-40 % read bandwidth, 5-10x lower
write bandwidth.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..core import (
    ArenaBackend,
    ArenaManager,
    ChunkStats,
    FractionPlacer,
    GuidanceConfig,
    GuidanceRuntime,
    HardwareModel,
    SiteKind,
    SiteRegistry,
    static_plan,
)
from ..core.profiler import ArenaProfile, IntervalProfile

GB = float(2**30)
LINE = 64  # bytes per sampled access (LLC line)
MLP = 6.0  # memory-level parallelism hiding part of the latency tax


# --------------------------------------------------------------------- sites
@dataclasses.dataclass
class SimSite:
    """One allocation site of a simulated workload."""

    name: str
    nbytes: int
    read_GBps: float            # read traffic at full speed
    write_GBps: float = 0.0     # write traffic at full speed
    rand_frac: float = 0.3      # fraction of reads that are latency-bound
    hot_page_frac: float = 1.0  # fraction of bytes that are "hot pages"
    hot_traffic_frac: float = 1.0  # fraction of traffic hitting hot pages
    alloc_phase: int = 0        # phase at which the site is allocated
    phase_mult: Optional[Sequence[float]] = None  # per-phase intensity scale
    # The QMCPACK pathology (Sec. 6.3): the hot pages are the *youngest*
    # (fresh walker data), but site-granularity placement fills the fast
    # tier with the site's oldest bytes first.  Age-aware mechanisms
    # (hardware caching, our fragmentation) still find the hot pages.
    fill_cold_first: bool = False

    def intensity(self, phase: int) -> float:
        if self.phase_mult is None:
            return 1.0
        return self.phase_mult[min(phase, len(self.phase_mult) - 1)]


@dataclasses.dataclass
class SimWorkload:
    name: str
    sites: List[SimSite]
    phases: int                  # number of nominal-1s compute phases
    compute_seconds: float = 1.0  # pure compute per phase at 16 threads

    @property
    def peak_rss(self) -> int:
        return sum(s.nbytes for s in self.sites)


# -------------------------------------------------------------------- result
@dataclasses.dataclass
class PhaseRecord:
    phase: int
    wall_seconds: float
    mem_seconds: float
    bytes_fast: int
    bytes_migrated: int
    bandwidth_GBps: float


@dataclasses.dataclass
class SimResult:
    workload: str
    policy: str
    cap_bytes: int
    total_seconds: float
    phase_records: List[PhaseRecord]
    bytes_migrated: int
    profile_seconds: float

    @property
    def throughput(self) -> float:
        return len(self.phase_records) / self.total_seconds

    def speedup_over(self, other: "SimResult") -> float:
        return self.throughput / other.throughput


# ------------------------------------------------------------------ backend
class SimArenaBackend(ArenaBackend):
    """``TierBackend`` for the simulator: an ``ArenaBackend`` whose chunk
    telemetry comes from the workload model's hot/cold page groups.

    Beyond-paper (Sec. 6.3 fix): when ``fragmentation`` is on, every site
    with intra-site heterogeneity reports two chunks — the young hot page
    group and the old cold group — so the *core* loop explodes the arena
    into age fragments and places the groups independently.  The simulator
    itself no longer carries any Algorithm-1 logic.
    """

    name = "sim_arena"

    def __init__(self, arenas, hw, placer, workload: SimWorkload,
                 arena_of: Dict[str, object], fragmentation: bool = False):
        super().__init__(arenas, hw, placer=placer)
        self.wl = workload
        self.arena_of = arena_of          # site name -> Arena (caller-owned)
        self.fragmentation = fragmentation
        self._profile: Optional[IntervalProfile] = None

    def snapshot(self) -> IntervalProfile:
        self._profile = super().snapshot()
        return self._profile

    def telemetry(self):
        if not self.fragmentation or self._profile is None:
            return {}
        telemetry: Dict[int, List[ChunkStats]] = {}
        by_arena = self._profile.by_arena()
        for s in self.wl.sites:
            arena = self.arena_of.get(s.name)
            if arena is None or s.hot_page_frac >= 1.0:
                continue
            row = by_arena.get(arena.arena_id)
            if row is None:
                continue
            hot_b = int(s.nbytes * s.hot_page_frac)
            telemetry[arena.arena_id] = [
                ChunkStats(chunk_id=arena.arena_id * 2, nbytes=hot_b,
                           accesses=int(row.accesses * s.hot_traffic_frac),
                           age=0, fast=row.fast_fraction > 0.5),
                ChunkStats(chunk_id=arena.arena_id * 2 + 1,
                           nbytes=s.nbytes - hot_b,
                           accesses=int(row.accesses * (1 - s.hot_traffic_frac)),
                           age=1, fast=False),
            ]
        return telemetry


# ----------------------------------------------------------------- simulator
class MemorySimulator:
    """Executes a workload under a placement policy and the CLX timing model."""

    def __init__(self, hw: HardwareModel, workload: SimWorkload):
        self.hw = hw
        self.wl = workload

    # -- timing -------------------------------------------------------------
    def _site_stall(self, site: SimSite, fast_frac_hot: float,
                    fast_frac_cold: float, phase: int) -> float:
        """Memory stall seconds for one site in one phase, given the fast-tier
        coverage of its hot and cold page groups."""
        hw = self.hw
        scale = site.intensity(phase)
        reads = site.read_GBps * GB * scale * self.wl.compute_seconds
        writes = site.write_GBps * GB * scale * self.wl.compute_seconds
        h, p = site.hot_page_frac, site.hot_traffic_frac
        # Split traffic into (hot, cold) page groups.
        r_hot, r_cold = reads * p, reads * (1 - p)
        w_hot, w_cold = writes * p, writes * (1 - p)
        rf = r_hot * fast_frac_hot + r_cold * fast_frac_cold
        rs = (r_hot + r_cold) - rf
        wf = w_hot * fast_frac_hot + w_cold * fast_frac_cold
        ws = (w_hot + w_cold) - wf
        t = (
            rf / (hw.fast.read_bw_GBps * GB)
            + rs / (hw.slow.read_bw_GBps * GB)
            + wf / (hw.fast.write_bw_GBps * GB)
            + ws / (hw.slow.write_bw_GBps * GB)
        )
        # Latency tax on random slow reads.
        slow_rand_lines = rs * site.rand_frac / LINE
        t += slow_rand_lines * (hw.extra_ns_per_slow_access / MLP) * 1e-9
        return t

    @staticmethod
    def _group_coverage(site: SimSite, fast_fraction: float,
                        page_aware: bool) -> tuple:
        """How much of the site's hot/cold page groups the fast bytes cover.

        Site-granularity placement is byte-uniform (the allocator cannot tell
        hot pages from cold within an arena): both groups get ``fast_fraction``
        coverage.  Page-aware mechanisms (hw cache, fragmentation) fill the hot
        group first.
        """
        h = site.hot_page_frac
        if page_aware:
            # Hot pages claimed first (hw cache / age-fragmented guidance).
            hot_cov = min(1.0, fast_fraction / h) if h > 0 else 1.0
            spare = max(0.0, fast_fraction - h)
            cold_cov = spare / (1.0 - h) if h < 1.0 else 1.0
            return hot_cov, min(1.0, cold_cov)
        if site.fill_cold_first:
            # Oldest (cold) bytes land fast first; the young hot set spills.
            cold_cov = min(1.0, fast_fraction / (1.0 - h)) if h < 1.0 else 1.0
            spare = max(0.0, fast_fraction - (1.0 - h))
            hot_cov = spare / h if h > 0 else 1.0
            return min(1.0, hot_cov), cold_cov
        return fast_fraction, fast_fraction

    # -- policy drivers -------------------------------------------------------
    def run_all_fast(self) -> SimResult:
        """The paper's *default* configuration: everything in DRAM, 16 threads."""
        return self._run_static(
            "default", cap=self.wl.peak_rss, fractions=None, compute_scale=1.0
        )

    def run_first_touch(self, cap: int) -> SimResult:
        """Unguided baseline: allocation-order fill of the fast tier."""
        fractions: Dict[str, float] = {}
        free = cap
        for s in sorted(self.wl.sites, key=lambda s: (s.alloc_phase,)):
            take = min(s.nbytes, max(free, 0))
            fractions[s.name] = take / s.nbytes if s.nbytes else 1.0
            free -= take
        return self._run_static("first_touch", cap, fractions, compute_scale=1.0)

    def run_offline(self, cap: int, strategy: str = "thermos") -> SimResult:
        """Offline MemBrain: oracle whole-run profile -> static placement."""
        prof = self._oracle_profile()
        recs = static_plan(prof, cap, strategy)
        id2name = {i: s.name for i, s in enumerate(self.wl.sites)}
        fractions = {
            id2name[aid]: frac for aid, frac in recs.fractions.items()
        }
        return self._run_static(f"offline_{strategy}", cap, fractions, 1.0)

    def _oracle_profile(self) -> IntervalProfile:
        rows = []
        for i, s in enumerate(self.wl.sites):
            total_phases = self.wl.phases - s.alloc_phase
            scale = sum(s.intensity(p) for p in range(s.alloc_phase, self.wl.phases))
            traffic = (s.read_GBps + s.write_GBps) * GB * self.wl.compute_seconds * scale
            rows.append(
                ArenaProfile(
                    arena_id=i, site_id=i, label=s.name,
                    accesses=int(traffic / LINE),
                    resident_bytes=s.nbytes, fast_fraction=1.0,
                )
            )
        return IntervalProfile(0, rows, 0, 0.0)

    def _run_static(self, policy: str, cap: int,
                    fractions: Optional[Dict[str, float]],
                    compute_scale: float) -> SimResult:
        records = []
        total = 0.0
        for phase in range(self.wl.phases):
            mem = 0.0
            fast_bytes = 0
            for s in self.wl.sites:
                if phase < s.alloc_phase:
                    continue
                f = 1.0 if fractions is None else fractions.get(s.name, 0.0)
                hot_cov, cold_cov = self._group_coverage(s, f, page_aware=False)
                mem += self._site_stall(s, hot_cov, cold_cov, phase)
                fast_bytes += int(f * s.nbytes)
            compute = self.wl.compute_seconds * compute_scale
            wall = max(compute, mem)
            traffic = self._phase_traffic(phase)
            records.append(PhaseRecord(phase, wall, mem, fast_bytes, 0,
                                       traffic / wall / GB if wall else 0.0))
            total += wall
        return SimResult(self.wl.name, policy, cap, total, records, 0, 0.0)

    def _phase_traffic(self, phase: int) -> float:
        return sum(
            (s.read_GBps + s.write_GBps) * GB * s.intensity(phase)
            * self.wl.compute_seconds
            for s in self.wl.sites
            if phase >= s.alloc_phase
        )

    # -- the real thing: online GDT ------------------------------------------
    def run_online(
        self,
        cap: int,
        strategy: str = "thermos",
        interval_seconds: float = 10.0,
        fragmentation: bool = False,
        num_fragments: int = 4,
        profile_cost_per_interval: float = 0.05,
        compute_scale: float = 16.0 / 15.0,
    ) -> SimResult:
        """Online guided data tiering: first-touch start, then Algorithm 1
        at wall-clock intervals, driven by the shared ``GuidanceRuntime``
        over a ``SimArenaBackend`` (the same controller that drives the
        trainer and the serving engine)."""
        reg = SiteRegistry()
        mgr = ArenaManager(reg, fast_capacity_bytes=cap)
        # Register sites; allocation happens at alloc_phase.
        core_sites = {s.name: reg.register([s.name], SiteKind.OTHER) for s in self.wl.sites}
        arena_of: Dict[str, object] = {}
        backend = SimArenaBackend(mgr, self.hw, FractionPlacer(mgr),
                                  self.wl, arena_of,
                                  fragmentation=fragmentation)
        runtime = GuidanceRuntime(
            backend, self.hw,
            GuidanceConfig(strategy=strategy, fast_capacity_bytes=cap,
                           interval_steps=1,
                           num_fragments=max(2, num_fragments)))

        records: List[PhaseRecord] = []
        total = 0.0
        total_migrated = 0
        profile_time = 0.0
        next_decision = interval_seconds
        for phase in range(self.wl.phases):
            # Allocations due this phase (first-touch placement inside mgr).
            for s in self.wl.sites:
                if s.alloc_phase == phase:
                    arena_of[s.name] = mgr.allocate(core_sites[s.name], s.nbytes)
            # Account accesses + compute stall under *current* placement.
            mem = 0.0
            migrated = 0
            for s in self.wl.sites:
                if phase < s.alloc_phase:
                    continue
                arena = arena_of[s.name]
                f = arena.fast_fraction if arena is not None else 1.0
                hot_cov, cold_cov = self._group_coverage(
                    s, f, page_aware=fragmentation
                )
                mem += self._site_stall(s, hot_cov, cold_cov, phase)
                traffic = (
                    (s.read_GBps + s.write_GBps) * GB
                    * s.intensity(phase) * self.wl.compute_seconds
                )
                mgr.touch(core_sites[s.name], int(traffic / LINE))
            compute = self.wl.compute_seconds * compute_scale
            wall = max(compute, mem)
            # Decision interval(s) that elapse during this phase.
            if total + wall >= next_decision:
                next_decision += interval_seconds
                rec = runtime.on_step()
                profile_time += profile_cost_per_interval
                wall += profile_cost_per_interval
                if rec is not None and rec.migrated:
                    migrated = rec.bytes_moved
                    total_migrated += migrated
                    wall += self.hw.move_cost_ns(migrated) * 1e-9
            traffic = self._phase_traffic(phase)
            records.append(PhaseRecord(phase, wall, mem,
                                       mgr.fast_tier_bytes(), migrated,
                                       traffic / wall / GB if wall else 0.0))
            total += wall
        return SimResult(self.wl.name, f"online_{strategy}", cap, total,
                         records, total_migrated, profile_time)

    # -- hardware-managed DRAM cache ("memory mode") ---------------------------
    def run_hw_cache(self, cap: int) -> SimResult:
        """Intel memory mode: DRAM is a direct-mapped page-granularity cache
        of Optane.  Page-aware (hot groups cached first, globally by density)
        but pays cache-management traffic on misses/evictions."""
        # Global page-group list: (density, site, group) with group hot/cold.
        groups = []
        for s in self.wl.sites:
            hot_b = int(s.nbytes * s.hot_page_frac)
            cold_b = s.nbytes - hot_b
            traffic = (s.read_GBps + s.write_GBps) * GB * self.wl.compute_seconds
            if hot_b:
                groups.append((traffic * s.hot_traffic_frac / hot_b, s, "hot", hot_b))
            if cold_b:
                groups.append((traffic * (1 - s.hot_traffic_frac) / cold_b, s,
                               "cold", cold_b))
        groups.sort(key=lambda g: -g[0])
        cached: Dict[tuple, float] = {}
        free = cap
        for dens, s, kind, nb in groups:
            take = min(nb, max(free, 0))
            cached[(s.name, kind)] = take / nb if nb else 1.0
            free -= take
        # Direct-mapped conflicts: real caches do not achieve perfect
        # hot-first packing; degrade coverage by a conflict factor.
        conflict = 0.85
        records = []
        total = 0.0
        mgmt_traffic_total = 0.0
        for phase in range(self.wl.phases):
            mem = 0.0
            for s in self.wl.sites:
                if phase < s.alloc_phase:
                    continue
                hot_cov = cached.get((s.name, "hot"), 0.0) * conflict
                cold_cov = cached.get((s.name, "cold"), 0.0) * conflict
                mem += self._site_stall(s, hot_cov, cold_cov, phase)
                # Cache management: misses pull lines from Optane AND write
                # them to DRAM; dirty evictions write back.  Model as extra
                # slow-tier traffic proportional to miss traffic.
                traffic = ((s.read_GBps + s.write_GBps) * GB
                           * s.intensity(phase) * self.wl.compute_seconds)
                h, p = s.hot_page_frac, s.hot_traffic_frac
                miss = traffic * (p * (1 - hot_cov) + (1 - p) * (1 - cold_cov))
                mgmt = 0.5 * miss   # fill + eviction overhead
                mem += mgmt / (self.hw.slow.read_bw_GBps * GB)
                mgmt_traffic_total += mgmt
            compute = self.wl.compute_seconds
            wall = max(compute, mem)
            records.append(PhaseRecord(phase, wall, mem, cap, 0,
                                       self._phase_traffic(phase) / wall / GB))
            total += wall
        return SimResult(self.wl.name, "hw_cache", cap, total, records,
                         int(mgmt_traffic_total), 0.0)
