"""Capacity-profiling backends (paper Sec. 4.1.2 / Table 2;
``repro/mem/rss_backends.py``, copied).

Two real implementations of per-arena resident-set-size accounting whose
*collection* cost we measure:

* ``PagemapWalkRSS`` — the offline-style mechanism: residency is stored per
  4 KB page and collection *walks every page record* (the analogue of seek +
  read over /proc/pid/pagemap), locking each arena while it walks.

* ``VMACounterRSS`` — the paper's online mechanism: page-fault/release paths
  maintain a per-VMA counter, so collection reads one record per arena (the
  analogue of reading the custom proc interface).  A small format/parse
  round-trip per arena models the proc-file read.

Table 2's claim — >11x faster profile intervals — is validated by timing
``collect()`` on arenas shaped like the paper's benchmarks (same site counts
and resident GBs).
"""

from __future__ import annotations

import time
from typing import Dict, List

PAGE = 4096


class PagemapWalkRSS:
    """Offline-style: walk per-page residency records at collection time."""

    def __init__(self):
        self._pages: Dict[int, bytearray] = {}
        self.lock_events = 0

    def allocate(self, arena_id: int, nbytes: int) -> None:
        n_pages = -(-nbytes // PAGE)
        self._pages.setdefault(arena_id, bytearray()).extend(b"\x01" * n_pages)

    def release(self, arena_id: int, nbytes: int) -> None:
        pages = self._pages.get(arena_id)
        if pages is None:
            return
        n = -(-nbytes // PAGE)
        for i in range(len(pages) - 1, -1, -1):
            if n == 0:
                break
            if pages[i]:
                pages[i] = 0
                n -= 1

    def collect(self) -> Dict[int, int]:
        """Walk every page record (per-page Python work mimics the per-page
        syscall/parse cost of the pagemap approach)."""
        out: Dict[int, int] = {}
        for arena_id, pages in self._pages.items():
            self.lock_events += 1  # profiling thread must lock the arena
            count = 0
            for flag in pages:     # O(pages): the Sec. 4.1.2 drawback
                if flag:
                    count += 1
            out[arena_id] = count * PAGE
        return out


class VMACounterRSS:
    """Online: fault/release instrumentation keeps counters current; collect
    is one proc-interface read per arena."""

    def __init__(self):
        self._resident: Dict[int, int] = {}

    def allocate(self, arena_id: int, nbytes: int) -> None:
        n_pages = -(-nbytes // PAGE)
        self._resident[arena_id] = self._resident.get(arena_id, 0) + n_pages

    def release(self, arena_id: int, nbytes: int) -> None:
        n_pages = -(-nbytes // PAGE)
        cur = self._resident.get(arena_id, 0)
        self._resident[arena_id] = max(0, cur - n_pages)

    def collect(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for arena_id, n_pages in self._resident.items():
            # Model the proc read: format + parse one line per VMA.
            line = f"{arena_id} {n_pages}\n"
            fields = line.split()
            out[int(fields[0])] = int(fields[1]) * PAGE
        return out


def time_collect(backend, repeats: int = 3) -> Dict[str, float]:
    times: List[float] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        backend.collect()
        times.append(time.perf_counter() - t0)
    return {
        "mean_s": sum(times) / len(times),
        "max_s": max(times),
    }
