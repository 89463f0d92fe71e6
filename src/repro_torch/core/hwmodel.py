"""Hardware models for heterogeneous memory tiers.

The paper's ski-rental constants (EXTRA_NS_PER_SLOWER_ACCESS, NS_PER_PAGE_MOVED)
are properties of the platform.  We keep three calibrations:

* ``CLX``      — the paper's evaluation box (Cascade Lake, DDR4 + Optane DC).
                 Constants straight from the paper (Secs. 4.2, 5.1).
* ``TPU_V5E``  — the TPU target this framework adapts the technique to:
                 fast tier = on-chip HBM, slow tier = host DRAM over PCIe.
* ``H100``     — the PyTorch port's card: fast tier = HBM3, slow tier =
                 pinned host DRAM over PCIe Gen5 x16 (``h100(page_bytes)``
                 derives the page constants from the KV page in use).

All byte-rate constants are in GB/s (1e9 bytes/s); latencies in ns.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One memory tier as seen by a single processor/chip."""

    name: str
    memory_kind: str          # memory kind used for enforcement
    capacity_bytes: int
    read_bw_GBps: float       # sustained read bandwidth
    write_bw_GBps: float      # sustained write bandwidth
    read_latency_ns: float    # average loaded read latency


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Two-tier memory platform + the Algorithm-1 cost constants.

    ``extra_ns_per_slow_access`` is the paper's EXTRA_NS_PER_SLOWER_ACCESS: the
    average *additional* latency paid when an access that could have been served
    by the fast tier is served by the slow tier.

    ``ns_per_page_moved`` is NS_PER_PAGE_MOVED: the cost of remapping one
    ``page_bytes`` page between tiers.
    """

    name: str
    fast: TierSpec
    slow: TierSpec
    extra_ns_per_slow_access: float
    ns_per_page_moved: float
    page_bytes: int = 4096
    # Typical bytes touched per sampled "access"; the paper samples LLC-miss
    # loads (64 B lines).  The TPU model counts whole-arena touches, so its
    # access unit is 1 byte and access counts carry the byte volume.
    bytes_per_access: int = 64

    def pages(self, nbytes: int) -> int:
        return -(-int(nbytes) // self.page_bytes)

    def move_cost_ns(self, nbytes: int) -> float:
        return self.pages(nbytes) * self.ns_per_page_moved

    @property
    def slowdown_ratio(self) -> float:
        """Read-bandwidth ratio fast/slow (used by the simulator)."""
        return self.fast.read_bw_GBps / self.slow.read_bw_GBps


# ---------------------------------------------------------------------------
# The paper's platform: Intel Cascade Lake, 192 GB DDR4 + 768 GB Optane DC.
# DDR4: 6x32 GB 2933 MT/s  => ~100 GB/s sustained (paper Fig. 7 y-axis max).
# Optane: 30-40% of DDR4 read bw, +300 ns average extra read latency (Sec. 4.2),
# write bw 5-10x lower than DDR4 (Sec. 5.1).  move_pages ~= 2 us / 4 KB page.
# ---------------------------------------------------------------------------
CLX = HardwareModel(
    name="clx-ddr4-optane",
    fast=TierSpec(
        name="DRAM",
        memory_kind="device",
        capacity_bytes=192 * 2**30,
        read_bw_GBps=100.0,
        write_bw_GBps=80.0,
        read_latency_ns=90.0,
    ),
    slow=TierSpec(
        name="OPTANE",
        memory_kind="pinned_host",
        capacity_bytes=768 * 2**30,
        read_bw_GBps=35.0,          # 30-40% of DDR4
        write_bw_GBps=10.0,         # 5-10x lower than DDR4
        read_latency_ns=390.0,      # +300 ns over DDR4
    ),
    extra_ns_per_slow_access=300.0,  # Sec. 4.2
    ns_per_page_moved=2000.0,        # Sec. 4.2: ~2 us per 4 KB page
)


# ---------------------------------------------------------------------------
# The TPU adaptation target: one v5e chip.
#   fast tier  = HBM  (16 GB, 819 GB/s)
#   slow tier  = host DRAM reached over PCIe gen4 x8-ish (~16 GB/s effective
#                per chip on a 4-chip host; latency in the microseconds).
# The "access" unit for tier decisions is one byte of arena traffic, so
# extra_ns_per_slow_access is the per-byte bandwidth tax:
#   1/16 GB/s - 1/819 GB/s  =  0.0613 - 0.0012 ns/B  ~= 0.060 ns per byte.
# Page = 2 MiB arena block; moving it over PCIe at ~16 GB/s ~= 131 us, plus
# fixed descriptor overhead.
# ---------------------------------------------------------------------------
_TPU_PCIE_GBPS = 16.0
_TPU_HBM_GBPS = 819.0
_TPU_PAGE = 2 * 2**20

TPU_V5E = HardwareModel(
    name="tpu-v5e-hbm-host",
    fast=TierSpec(
        name="HBM",
        memory_kind="device",
        capacity_bytes=16 * 2**30,
        read_bw_GBps=_TPU_HBM_GBPS,
        write_bw_GBps=_TPU_HBM_GBPS,
        read_latency_ns=500.0,
    ),
    slow=TierSpec(
        name="HOST",
        memory_kind="pinned_host",
        capacity_bytes=512 * 2**30,
        read_bw_GBps=_TPU_PCIE_GBPS,
        write_bw_GBps=_TPU_PCIE_GBPS,
        read_latency_ns=2500.0,
    ),
    extra_ns_per_slow_access=(1.0 / _TPU_PCIE_GBPS - 1.0 / _TPU_HBM_GBPS),
    ns_per_page_moved=_TPU_PAGE / _TPU_PCIE_GBPS + 5000.0,
    page_bytes=_TPU_PAGE,
    bytes_per_access=1,
)


# Roofline constants for the target chip (used by benchmarks/roofline.py).
TPU_V5E_PEAK_BF16_FLOPS = 197e12     # per chip
TPU_V5E_HBM_GBPS = 819.0             # per chip
TPU_V5E_ICI_GBPS_PER_LINK = 50.0     # per link


# ---------------------------------------------------------------------------
# The PyTorch port's card: one NVIDIA H100 SXM.
#   fast tier = HBM3: 80 GB at 3.35 TB/s (NVIDIA H100 Tensor Core GPU
#               datasheet, SXM column).
#   slow tier = pinned host DRAM reached over PCIe Gen5 x16: 32 GT/s per
#               lane, 16 lanes, 128b/130b encoding = 63 GB/s per direction
#               (PCI-SIG PCIe 5.0 base specification; the H100 datasheet
#               quotes "PCIe Gen5: 128 GB/s" for both directions together).
# As for the TPU, an "access" is one byte of page traffic, so
# extra_ns_per_slow_access is the per-byte bandwidth tax
#   1/63 GB/s - 1/3350 GB/s ~= 0.0156 ns per byte.
# A page is one KV page of the serving engine (all layers, K and V), so the
# move cost is its bytes over the PCIe rate plus a fixed per-transfer cost:
# the CUDA runtime's launch overhead for an async copy plus the gather
# kernel, about 5 us (NVIDIA CUDA C++ Best Practices Guide, "Asynchronous
# and Overlapping Transfers with Computation": transfers are latency-bound
# below a few hundred KB).
# The read latencies (HBM ~500 ns loaded, a PCIe round trip ~1 us) are
# estimates: no datasheet gives them, and nothing in the port reads them.
# ---------------------------------------------------------------------------
_H100_PCIE_GBPS = 63.0
_H100_HBM_GBPS = 3350.0
_H100_MOVE_FIXED_NS = 5000.0
# The serving engine's KV page at llama3_2_1b's published widths:
# 16 layers x page_size 16 x 8 KV heads x head_dim 64 x (K, V) x 2 B (bf16).
_H100_DEFAULT_PAGE = 16 * 16 * 8 * 64 * 2 * 2


def h100(page_bytes: int = _H100_DEFAULT_PAGE) -> HardwareModel:
    """The H100 model with ``page_bytes`` = the KV page the engine moves
    (one page of every layer's K and V) and the matching move cost."""
    return HardwareModel(
        name="h100-hbm3-pinned-host",
        fast=TierSpec(
            name="HBM3",
            memory_kind="device",
            capacity_bytes=80 * 10**9,
            read_bw_GBps=_H100_HBM_GBPS,
            write_bw_GBps=_H100_HBM_GBPS,
            read_latency_ns=500.0,
        ),
        slow=TierSpec(
            name="PINNED_HOST",
            memory_kind="pinned_host",
            capacity_bytes=512 * 2**30,
            read_bw_GBps=_H100_PCIE_GBPS,
            write_bw_GBps=_H100_PCIE_GBPS,
            read_latency_ns=1000.0,
        ),
        extra_ns_per_slow_access=(1.0 / _H100_PCIE_GBPS
                                  - 1.0 / _H100_HBM_GBPS),
        ns_per_page_moved=page_bytes / _H100_PCIE_GBPS + _H100_MOVE_FIXED_NS,
        page_bytes=page_bytes,
        bytes_per_access=1,
    )


H100 = h100()
