"""repro_torch.mem — the calibrated two-tier memory simulator and workload
models of the paper's reproduction experiments (``repro.mem``, DESIGN.md
Sec. 9), copied framework-free: numpy and ``repro_torch.core``.  The
simulator's hardware model stays ``core.CLX`` (DRAM over Optane), as in the
reference."""

from .simulator import (
    GB,
    MemorySimulator,
    PhaseRecord,
    SimArenaBackend,
    SimResult,
    SimSite,
    SimWorkload,
)
from . import workloads

__all__ = [
    "GB",
    "MemorySimulator",
    "PhaseRecord",
    "SimArenaBackend",
    "SimResult",
    "SimSite",
    "SimWorkload",
    "workloads",
]
