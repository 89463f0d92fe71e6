"""Synthetic workloads shaped on the paper's Table 1 (``repro/mem/workloads.py``,
copied: numpy only, so a seed gives the JAX package's workloads exactly).

Each constructor returns a ``SimWorkload`` whose aggregate statistics match
the corresponding benchmark: resident set size, allocation-site count, and a
memory-traffic profile calibrated so the *default / first-touch / guided*
throughput ratios land where the paper's Figures 5-8 put them.  The
calibration knobs are physical (traffic volume, read/write split, traffic
concentration across sites, latency-bound fraction) — the policies never see
them, only the resulting access counts.

Site-size and heat distributions are deterministic (seeded) lognormal/Zipf,
interleaved in allocation order so first-touch cannot accidentally capture
the hot set.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .simulator import GB, SimSite, SimWorkload


def _sizes(total_bytes: int, n: int, rng: np.random.Generator,
           sigma: float = 1.6) -> np.ndarray:
    raw = rng.lognormal(mean=0.0, sigma=sigma, size=n)
    sizes = raw / raw.sum() * total_bytes
    return np.maximum(sizes.astype(np.int64), 4096)


def _heat(n: int, rng: np.random.Generator, zipf_s: float) -> np.ndarray:
    """Traffic share per site: Zipf over a random permutation of sites."""
    ranks = rng.permutation(n) + 1
    w = 1.0 / ranks.astype(np.float64) ** zipf_s
    return w / w.sum()


def build_hpc(
    name: str,
    total_gb: float,
    n_sites: int,
    read_GBps: float,
    write_GBps: float,
    zipf_s: float = 1.1,
    rand_frac: float = 0.08,
    phases: int = 60,
    seed: int = 7,
    compute_seconds: float = 1.0,
    dominant_site: Optional[dict] = None,
    size_heat_corr: float = 0.0,
    hot_alloc_late: float = 0.0,
) -> SimWorkload:
    """Generic memory-intensive HPC workload.

    ``dominant_site``: optional dict(frac_bytes, frac_traffic, hot_page_frac,
    hot_traffic_frac) — the QMCPACK pathology generator.
    ``size_heat_corr``: 0 = site size independent of heat; >0 biases heat
    toward *smaller* sites (stencil codes: small hot workset + big cold
    arrays), which is what makes guidance so profitable.
    """
    rng = np.random.default_rng(seed)
    total_bytes = int(total_gb * GB)
    sites: List[SimSite] = []

    dom_bytes = 0
    dom_traffic = 0.0
    if dominant_site is not None:
        dom_bytes = int(total_bytes * dominant_site["frac_bytes"])
        dom_traffic = dominant_site["frac_traffic"]
        n_rest = n_sites - 1
    else:
        n_rest = n_sites

    sizes = _sizes(total_bytes - dom_bytes, n_rest, rng)
    heat = _heat(n_rest, rng, zipf_s)
    if size_heat_corr > 0.0:
        # Re-rank: give the largest heat weights to the smallest sites with
        # probability proportional to corr.
        order_small = np.argsort(sizes)                # small first
        order_hot = np.argsort(-heat)
        mixed = np.empty(n_rest, dtype=np.int64)
        take_corr = rng.random(n_rest) < size_heat_corr
        pool_sorted = list(order_small)
        pool_rand = list(rng.permutation(n_rest))
        used = set()
        slots = []
        for i in range(n_rest):
            src = pool_sorted if take_corr[i] else pool_rand
            while src and src[0] in used:
                src.pop(0)
            if not src:
                src = pool_rand if take_corr[i] else pool_sorted
                while src and src[0] in used:
                    src.pop(0)
            pick = src.pop(0)
            used.add(pick)
            slots.append(pick)
        mixed[np.array(slots)] = order_hot[:n_rest]
        heat = heat[mixed]

    rest_traffic = 1.0 - dom_traffic
    for i in range(n_rest):
        share = heat[i] * rest_traffic
        sites.append(
            SimSite(
                name=f"{name}_site{i}",
                nbytes=int(sizes[i]),
                read_GBps=read_GBps * share,
                write_GBps=write_GBps * share,
                rand_frac=rand_frac,
                alloc_phase=0,
            )
        )
    if dominant_site is not None:
        sites.append(
            SimSite(
                name=f"{name}_dominant",
                nbytes=dom_bytes,
                read_GBps=read_GBps * dom_traffic,
                write_GBps=write_GBps * dom_traffic,
                rand_frac=rand_frac,
                hot_page_frac=dominant_site.get("hot_page_frac", 1.0),
                hot_traffic_frac=dominant_site.get("hot_traffic_frac", 1.0),
                fill_cold_first=dominant_site.get("fill_cold_first", True),
                alloc_phase=0,
            )
        )
    # Allocation order: ``hot_alloc_late`` biases hot sites toward late
    # allocation (HPC codes allocate big cold domain arrays at init and the
    # hot worksets later) — this is what starves first-touch.
    n = len(sites)
    traffic = np.array([s.read_GBps + s.write_GBps for s in sites])
    dens = traffic / np.maximum(np.array([s.nbytes for s in sites]), 1)
    dens_rank = np.argsort(np.argsort(dens)) / max(n - 1, 1)  # 1.0 = hottest
    key = rng.random(n) * (1.0 - hot_alloc_late) + dens_rank * hot_alloc_late
    order = np.argsort(key)  # cold first, hot last (to the chosen degree)
    sites = [sites[i] for i in order]
    return SimWorkload(name=name, sites=sites, phases=phases,
                       compute_seconds=compute_seconds)


# ---------------------------------------------------------------- CORAL set
# Traffic calibration targets (paper Fig. 6, medium inputs):
#   LULESH: guided up to ~7.3x over first-touch at 20% DRAM.
#   AMG/SNAP: 1.4x-4x range.  QMCPACK: up to ~7.1x at 50%.
# Write-heavy hot sites are what make first-touch so bad on Optane
# (5-10x lower write bandwidth, Sec. 5.1).

def lulesh(input_size: str = "medium") -> SimWorkload:
    gb = {"medium": 66.2, "large": 522.9, "huge": 627.3}[input_size]
    return build_hpc(
        f"lulesh_{input_size}", gb, n_sites=87,
        read_GBps=180.0, write_GBps=120.0,
        zipf_s=1.2, rand_frac=0.12, size_heat_corr=0.2, hot_alloc_late=0.3,
        phases=60, seed=11,
    )


def amg(input_size: str = "medium") -> SimWorkload:
    gb = {"medium": 72.2, "large": 260.4, "huge": 392.4}[input_size]
    return build_hpc(
        f"amg_{input_size}", gb, n_sites=209,
        read_GBps=150.0, write_GBps=40.0,
        zipf_s=0.8, rand_frac=0.15, size_heat_corr=0.1, hot_alloc_late=0.1,
        phases=60, seed=13,
    )


def snap(input_size: str = "medium") -> SimWorkload:
    gb = {"medium": 61.4, "large": 288.8, "huge": 462.1}[input_size]
    return build_hpc(
        f"snap_{input_size}", gb, n_sites=90,
        read_GBps=130.0, write_GBps=45.0,
        zipf_s=0.7, rand_frac=0.05, size_heat_corr=0.0, hot_alloc_late=0.15,
        phases=60, seed=17,
    )


def qmcpack(input_size: str = "medium") -> SimWorkload:
    gb = {"medium": 16.5, "large": 357.0, "huge": 375.9}[input_size]
    # Large/huge inputs: one site allocates 60-63% of resident data and is
    # the hottest per byte on average, but only ~1/3 of its pages are hot at
    # any time (Sec. 6.3) — the site-granularity pathology.
    dom = None
    read, write, rand = 60.0, 15.0, 0.10
    if input_size in ("large", "huge"):
        dom = dict(frac_bytes=0.62, frac_traffic=0.85,
                   hot_page_frac=0.25, hot_traffic_frac=0.97)
        read, write, rand = 130.0, 25.0, 0.15
    return build_hpc(
        f"qmcpack_{input_size}", gb, n_sites=1408,
        read_GBps=read, write_GBps=write,
        zipf_s=1.0, rand_frac=rand, size_heat_corr=0.1, hot_alloc_late=0.3,
        phases=60, seed=19, dominant_site=dom,
    )


CORAL = {"lulesh": lulesh, "amg": amg, "snap": snap, "qmcpack": qmcpack}


# ----------------------------------------------------------------- SPEC set
# SPEC CPU 2017 FP (OpenMP subset).  Far smaller footprints; several are
# compute-bound and get little or no benefit from guidance (Fig. 6 bottom).

def spec_workload(name: str, gb: float, n_sites: int, read_GBps: float,
                  write_GBps: float, zipf_s: float, rand_frac: float,
                  memory_bound: float, seed: int,
                  hot_alloc_late: float = 0.0) -> SimWorkload:
    """``memory_bound``: ratio of nominal memory stall to compute at default
    placement — <1 means guidance has little to win."""
    wl = build_hpc(
        name, gb, n_sites=n_sites,
        read_GBps=read_GBps * memory_bound,
        write_GBps=write_GBps * memory_bound,
        zipf_s=zipf_s, rand_frac=rand_frac, size_heat_corr=0.1,
        hot_alloc_late=hot_alloc_late,
        phases=40, seed=seed,
    )
    return wl


SPEC = {
    # (Fig. 6 bottom) bwaves/pop2/fotonik3d/roms benefit modestly;
    # cactuBSSN, wrf, imagick, nab are compute-bound and see little or none
    # (the online runs there pay the profiling thread for nothing).
    "bwaves": lambda: spec_workload("bwaves", 11.4, 34, 110, 25, 0.7, 0.01, 0.33, 23, 0.1),
    "cactuBSSN": lambda: spec_workload("cactuBSSN", 6.6, 809, 40, 10, 0.7, 0.01, 0.2, 29),
    "wrf": lambda: spec_workload("wrf", 0.2, 4869, 30, 8, 0.7, 0.01, 0.15, 31),
    "cam4": lambda: spec_workload("cam4", 1.2, 1691, 35, 10, 0.8, 0.01, 0.25, 37),
    "pop2": lambda: spec_workload("pop2", 1.5, 1107, 120, 24, 0.9, 0.01, 0.32, 41, 0.25),
    "imagick": lambda: spec_workload("imagick", 6.9, 4, 25, 8, 0.5, 0.01, 0.12, 43),
    "nab": lambda: spec_workload("nab", 0.6, 88, 25, 6, 0.6, 0.01, 0.12, 47),
    "fotonik3d": lambda: spec_workload("fotonik3d", 9.5, 127, 100, 20, 0.7, 0.01, 0.35, 53, 0.1),
    "roms": lambda: spec_workload("roms", 10.2, 395, 115, 28, 0.8, 0.01, 0.36, 59, 0.15),
}
