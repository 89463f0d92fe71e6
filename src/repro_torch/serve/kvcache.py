"""Paged KV cache with two memory tiers — the port of
``repro/serve/kvcache.py``.

Layout: one pool of pages per tier; a page holds ``page_size`` tokens of K
and V for *all* layers, so each tier is a pair of tensors shaped
``(L, N, P, K, dh)``.  On the card the HBM tier is CUDA tensors and the host
tier ``pin_memory()`` CPU tensors; on the CPU both are plain CPU tensors.
Pages migrate between the tiers as whole blocks — they are the
``ChunkStats`` chunks the fragmentation engine reasons about, and each
*request* is an allocation site whose arena is its page list.

Attention reads only the HBM tier; a page on the host tier is swapped in
before its sequence can decode (the swap is the rental the ski-rental
controller weighs).  The serving engine writes K/V into the HBM tensors in
place.

Migrations are batched: ``swap_in_many`` / ``swap_out_many`` / ``exchange``
move a whole direction of a plan as one ``index_select`` (gather), one
``copy_(non_blocking=True)`` across the tiers and one ``index_copy_``
(scatter) per pool array, so an N-page migration costs a constant number of
host<->device transfers (``transfer_events`` counts them: 2 per direction,
K and V) while the per-page swap/byte counters stay exact.  Every copy runs
on the current stream.  A device-to-host copy is waited for before the host
tier is written, so host data is always current when read; a host-to-device
copy reads a pinned staging buffer, never a host slot, so a host slot can be
reused as soon as it is freed.

Pages are REFCOUNTED, not single-owner: ``Page.request_id`` is provenance
only; the request->pages association lives in the pool's per-request
sequence table (``request_pages``/``attach``/``release_request``), and
``free`` releases physical slots only at refcount zero.  A page with
refcount > 1 is immutable (``copy_page`` gives a writer a private copy).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .._device import DeviceLike, resolve_device


@dataclasses.dataclass
class PageExport:
    """KV pages staged out of one pool for import into another.  Data is
    host-side (CPU tensors, one batched gather per source tier) and
    bitwise-exact.  ``fast`` keeps the source tier of each page."""

    page_ids: List[int]
    index_in_seq: List[int]
    tokens_used: List[int]
    accesses: List[float]
    fast: List[bool]              # source-tier residency (True = HBM)
    k: torch.Tensor               # (L, n, P, K, dh) on the CPU
    v: torch.Tensor
    n_layers: int
    shape: Tuple[int, ...]        # (page_size, kv_heads, head_dim)

    def __len__(self) -> int:
        return len(self.page_ids)


@dataclasses.dataclass
class Page:
    page_id: int                 # global logical id
    request_id: int              # ALLOCATOR provenance, not ownership
    index_in_seq: int            # page number within the sequence
    birth_step: int
    hbm_slot: Optional[int]      # slot in HBM pool, None if on host
    host_slot: Optional[int]
    # Float: ReweightProfile decays counters every interval.
    accesses: float = 0.0
    tokens_used: int = 0
    refcount: int = 1
    last_used: int = 0


class PagedKVPool:
    """Two-tier physical page pools + logical page bookkeeping."""

    def __init__(self, n_layers: int, page_size: int, kv_heads: int,
                 head_dim: int, hbm_pages: int, host_pages: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.shape = (page_size, kv_heads, head_dim)
        self.page_size = page_size
        self.n_layers = n_layers
        self._pinned = self.device.type == "cuda"
        self.k_hbm = torch.zeros((n_layers, hbm_pages) + self.shape,
                                 dtype=dtype, device=self.device)
        self.v_hbm = torch.zeros_like(self.k_hbm)
        self.k_host = torch.zeros((n_layers, host_pages) + self.shape,
                                  dtype=dtype, pin_memory=self._pinned)
        self.v_host = torch.zeros_like(self.k_host,
                                       pin_memory=self._pinned)

        self.hbm_pages = hbm_pages
        self.host_pages = host_pages
        self.free_hbm: List[int] = list(range(hbm_pages))
        self.free_host: List[int] = list(range(host_pages))
        self.pages: Dict[int, Page] = {}
        # request_id -> ordered page list (the authoritative association).
        self._seq: Dict[int, List[Page]] = {}
        self._next_id = 0
        self.swaps_in = 0
        self.swaps_out = 0
        self.bytes_moved = 0
        # Host<->device transfer probe: one event per pool-array transfer
        # (K and V count separately), so a batched N-page migration costs
        # 2 events per direction whatever N is.
        self.transfer_events = 0
        # Cross-pool handoff counters (replica migration, not tier traffic).
        self.exported_pages = 0
        self.imported_pages = 0

    # ------------------------------------------------------------ alloc
    @property
    def page_bytes(self) -> int:
        n = self.n_layers
        for s in self.shape:
            n *= s
        return 2 * n * self.k_hbm.dtype.itemsize  # K and V

    def allocate(self, request_id: int, index_in_seq: int,
                 step: int) -> Page:
        if not self.free_hbm:
            raise MemoryError(
                f"HBM pool exhausted: all {self.hbm_pages} pages "
                f"(ServeConfig.hbm_pages) hold live KV; evict or free pages "
                f"first, or raise ServeConfig.hbm_pages")
        slot = self.free_hbm.pop()
        page = Page(page_id=self._next_id, request_id=request_id,
                    index_in_seq=index_in_seq, birth_step=step,
                    hbm_slot=slot, host_slot=None, last_used=step)
        self._next_id += 1
        self.pages[page.page_id] = page
        self._seq.setdefault(request_id, []).append(page)
        return page

    def free(self, page_id: int):
        """Drop ONE reference; physical slots release only at refcount
        zero.  Unknown or already-freed ids raise."""
        page = self.pages.get(page_id)
        if page is None:
            raise ValueError(
                f"cannot free page {page_id}: unknown or already-freed id "
                f"(a page dies when its refcount reaches zero — freeing it "
                f"again, or freeing an id this pool never allocated, is a "
                f"lifecycle bug in the caller)")
        page.refcount -= 1
        if page.refcount > 0:
            return
        self.pages.pop(page_id)
        if page.hbm_slot is not None:
            self.free_hbm.append(page.hbm_slot)
        if page.host_slot is not None:
            self.free_host.append(page.host_slot)

    # ----------------------------------------------------------- sharing
    def attach(self, request_id: int, page_id: int, step: int) -> Page:
        """Reference an existing page from ``request_id``'s sequence, in
        index order."""
        page = self.pages[page_id]
        seq = self._seq.setdefault(request_id, [])
        if len(seq) != page.index_in_seq:
            raise ValueError(
                f"cannot attach page {page_id} (index_in_seq="
                f"{page.index_in_seq}) to request {request_id} holding "
                f"{len(seq)} pages: prefix pages attach in order")
        page.refcount += 1
        page.last_used = step
        seq.append(page)
        return page

    def release_request(self, request_id: int) -> List[int]:
        """Drop every reference ``request_id`` holds.  Returns the ids of
        pages that actually died."""
        freed: List[int] = []
        for page in self._seq.pop(request_id, []):
            self.free(page.page_id)
            if page.page_id not in self.pages:
                freed.append(page.page_id)
        return freed

    def holders(self, page_id: int) -> List[int]:
        """Request ids currently referencing a page."""
        return [rid for rid, seq in self._seq.items()
                if any(p.page_id == page_id for p in seq)]

    def copy_page(self, page_id: int, request_id: int, step: int) -> Page:
        """Copy-on-write: give ``request_id`` a private HBM copy of a shared
        page, swapped into the request's sequence in place.  The source
        must be HBM-resident."""
        src = self.pages[page_id]
        if src.hbm_slot is None:
            raise ValueError(
                f"cannot copy-on-write page {page_id}: not HBM-resident "
                f"(swap it in first)")
        if not self.free_hbm:
            raise MemoryError(
                f"HBM pool exhausted: all {self.hbm_pages} pages "
                f"(ServeConfig.hbm_pages) hold live KV; evict or free pages "
                f"first, or raise ServeConfig.hbm_pages")
        seq = self._seq.get(request_id, [])
        at = next((i for i, p in enumerate(seq) if p.page_id == page_id),
                  None)
        if at is None:
            raise ValueError(
                f"cannot copy-on-write page {page_id}: request "
                f"{request_id} does not reference it")
        slot = self.free_hbm.pop()
        new = Page(page_id=self._next_id, request_id=request_id,
                   index_in_seq=src.index_in_seq, birth_step=step,
                   hbm_slot=slot, host_slot=None, accesses=src.accesses,
                   tokens_used=src.tokens_used, last_used=step)
        self._next_id += 1
        self.pages[new.page_id] = new
        self.k_hbm[:, slot].copy_(self.k_hbm[:, src.hbm_slot])
        self.v_hbm[:, slot].copy_(self.v_hbm[:, src.hbm_slot])
        seq[at] = new
        self.free(page_id)               # drop the request's old reference
        return new

    # ------------------------------------------------------- migrations
    def _gather(self, src_k, src_v, src_idx):
        """Stage M pages out of a tier: ONE ``index_select`` per pool array,
        whatever M.  Out of the host tier the gather lands in pinned memory
        (on the card), so the copy to the device can be asynchronous."""
        if not src_idx:
            return None
        idx = torch.tensor(src_idx, dtype=torch.long, device=src_k.device)
        if src_k.device.type == "cpu" and self._pinned:
            shape = (src_k.shape[0], len(src_idx)) + self.shape
            staged = []
            for t in (src_k, src_v):
                buf = torch.empty(shape, dtype=t.dtype, pin_memory=True)
                torch.index_select(t, 1, idx, out=buf)
                staged.append(buf)
            return tuple(staged)
        return src_k.index_select(1, idx), src_v.index_select(1, idx)

    def _scatter(self, dst_k, dst_v, dst_idx, staged):
        """Land staged pages on a tier: ONE ``copy_(non_blocking=True)``
        across the tiers and ONE ``index_copy_`` per pool array."""
        dev = dst_k.device
        to_host = dev.type == "cpu" and self._pinned
        moved = []
        for src in staged:
            if src.device == dev:
                moved.append(src)
                continue
            buf = torch.empty(src.shape, dtype=src.dtype, device=dev,
                              pin_memory=to_host)
            buf.copy_(src, non_blocking=True)
            moved.append(buf)
        if to_host:
            # The device-to-host copies must land before the CPU reads them.
            torch.cuda.current_stream(self.device).synchronize()
        idx = torch.tensor(dst_idx, dtype=torch.long, device=dev)
        dst_k.index_copy_(1, idx, moved[0])
        dst_v.index_copy_(1, idx, moved[1])
        self.transfer_events += 2            # one per pool array (K, V)

    def swap_out_many(self, page_ids: Sequence[int]):
        """HBM -> host, one batched transfer for the whole id list.
        Already-slow, unknown and duplicate ids are skipped; counters stay
        per-page exact."""
        ids = [pid for pid in dict.fromkeys(page_ids)
               if pid in self.pages and self.pages[pid].hbm_slot is not None]
        if not ids:
            return
        if len(self.free_host) < len(ids):
            raise MemoryError("host pool exhausted")
        src = [self.pages[pid].hbm_slot for pid in ids]
        dst = [self.free_host.pop() for _ in ids]
        self._scatter(self.k_host, self.v_host, dst,
                      self._gather(self.k_hbm, self.v_hbm, src))
        for pid, si, di in zip(ids, src, dst):
            page = self.pages[pid]
            self.free_hbm.append(si)
            page.hbm_slot, page.host_slot = None, di
        self.swaps_out += len(ids)
        self.bytes_moved += self.page_bytes * len(ids)

    def swap_in_many(self, page_ids: Sequence[int]):
        """host -> HBM, one batched transfer for the whole id list (unknown,
        already-fast and duplicate ids are skipped)."""
        ids = [pid for pid in dict.fromkeys(page_ids)
               if pid in self.pages and self.pages[pid].hbm_slot is None]
        if not ids:
            return
        if len(self.free_hbm) < len(ids):
            raise MemoryError(
                f"HBM pool exhausted: {len(ids)} pages to swap in but only "
                f"{len(self.free_hbm)} of {self.hbm_pages} slots "
                f"(ServeConfig.hbm_pages) are free; evict first or raise "
                f"ServeConfig.hbm_pages")
        src = [self.pages[pid].host_slot for pid in ids]
        dst = [self.free_hbm.pop() for _ in ids]
        self._scatter(self.k_hbm, self.v_hbm, dst,
                      self._gather(self.k_host, self.v_host, src))
        for pid, si, di in zip(ids, src, dst):
            page = self.pages[pid]
            self.free_host.append(si)
            page.host_slot, page.hbm_slot = None, di
        self.swaps_in += len(ids)
        self.bytes_moved += self.page_bytes * len(ids)

    def exchange(self, out_ids: Sequence[int], in_ids: Sequence[int]):
        """Atomic bidirectional migration: demote ``out_ids`` and promote
        ``in_ids`` in one batched operation.  Both directions are STAGED
        before any slot is freed, so the exchange succeeds even when both
        free lists are empty (a pure slot swap).  Feasibility: len(out) <=
        len(in) + free_host and len(in) <= len(out) + free_hbm."""
        outs = [pid for pid in dict.fromkeys(out_ids)
                if pid in self.pages and self.pages[pid].hbm_slot is not None]
        ins = [pid for pid in dict.fromkeys(in_ids)
               if pid in self.pages and self.pages[pid].hbm_slot is None]
        if not outs and not ins:
            return
        if len(outs) > len(ins) + len(self.free_host):
            raise MemoryError(
                f"host pool exhausted: {len(outs)} demotions need more than "
                f"the {len(self.free_host)} free of {self.host_pages} host "
                f"slots (ServeConfig.host_pages) plus {len(ins)} freed by "
                f"promotions; raise ServeConfig.host_pages")
        if len(ins) > len(outs) + len(self.free_hbm):
            raise MemoryError(
                f"HBM pool exhausted: {len(ins)} promotions need more than "
                f"the {len(self.free_hbm)} free of {self.hbm_pages} HBM "
                f"slots (ServeConfig.hbm_pages) plus {len(outs)} freed by "
                f"demotions; evict first or raise ServeConfig.hbm_pages")
        out_src = [self.pages[pid].hbm_slot for pid in outs]
        in_src = [self.pages[pid].host_slot for pid in ins]
        # Stage BOTH directions before any scatter: a destination slot may
        # be a just-freed source slot of the opposite direction.
        out_stage = self._gather(self.k_hbm, self.v_hbm, out_src)
        in_stage = self._gather(self.k_host, self.v_host, in_src)
        self.free_hbm.extend(out_src)
        self.free_host.extend(in_src)
        in_dst = [self.free_hbm.pop() for _ in ins]
        out_dst = [self.free_host.pop() for _ in outs]
        if outs:
            self._scatter(self.k_host, self.v_host, out_dst, out_stage)
        if ins:
            self._scatter(self.k_hbm, self.v_hbm, in_dst, in_stage)
        for pid, di in zip(outs, out_dst):
            page = self.pages[pid]
            page.hbm_slot, page.host_slot = None, di
        for pid, di in zip(ins, in_dst):
            page = self.pages[pid]
            page.host_slot, page.hbm_slot = None, di
        self.swaps_out += len(outs)
        self.swaps_in += len(ins)
        self.bytes_moved += self.page_bytes * (len(outs) + len(ins))

    # ------------------------------------------------- cross-pool handoff
    def _to_cpu(self, staged):
        if staged[0].device.type == "cpu":
            return staged
        out = tuple(t.to("cpu") for t in staged)     # waits for the copy
        return out

    def export_pages(self, page_ids: Sequence[int]) -> PageExport:
        """Stage pages out of this pool for import into another: one
        batched gather per source tier; the pool is left untouched."""
        ids = list(dict.fromkeys(page_ids))
        missing = [pid for pid in ids if pid not in self.pages]
        if missing:
            raise ValueError(
                f"cannot export pages {missing}: unknown or freed ids")
        pages = [self.pages[pid] for pid in ids]
        n = len(pages)
        k = torch.zeros((self.n_layers, n) + self.shape,
                        dtype=self.k_hbm.dtype)
        v = torch.zeros_like(k)
        fast_rows = [i for i, p in enumerate(pages) if p.hbm_slot is not None]
        slow_rows = [i for i, p in enumerate(pages) if p.hbm_slot is None]
        if fast_rows:
            sk, sv = self._to_cpu(self._gather(
                self.k_hbm, self.v_hbm,
                [pages[i].hbm_slot for i in fast_rows]))
            k[:, fast_rows], v[:, fast_rows] = sk, sv
        if slow_rows:
            sk, sv = self._gather(self.k_host, self.v_host,
                                  [pages[i].host_slot for i in slow_rows])
            k[:, slow_rows], v[:, slow_rows] = sk, sv
        self.exported_pages += n
        return PageExport(
            page_ids=[p.page_id for p in pages],
            index_in_seq=[p.index_in_seq for p in pages],
            tokens_used=[p.tokens_used for p in pages],
            accesses=[p.accesses for p in pages],
            fast=[p.hbm_slot is not None for p in pages],
            k=k, v=v, n_layers=self.n_layers, shape=self.shape)

    def import_pages(self, export: PageExport, request_id: int,
                     step: int) -> List[Page]:
        """Land an export into THIS pool as fresh private pages attached to
        ``request_id``.  Each page keeps its source tier when the matching
        free list has room, overflows to the other tier otherwise, and the
        whole import raises ``MemoryError`` — before moving any data — when
        the pools together cannot hold it.  One batched scatter per
        destination tier."""
        if (export.n_layers, tuple(export.shape)) != (self.n_layers,
                                                      tuple(self.shape)):
            raise ValueError(
                f"cannot import pages shaped {export.n_layers}x"
                f"{tuple(export.shape)} into a pool shaped "
                f"{self.n_layers}x{tuple(self.shape)}: engines must share "
                f"one model/page geometry")
        n = len(export)
        if n == 0:
            return []
        if n > len(self.free_hbm) + len(self.free_host):
            raise MemoryError(
                f"cannot import {n} pages: only {len(self.free_hbm)} free "
                f"HBM + {len(self.free_host)} free host slots on the "
                f"destination pool (hbm_pages={self.hbm_pages}, "
                f"host_pages={self.host_pages}); recompute instead")
        room_fast, room_slow = len(self.free_hbm), len(self.free_host)
        fast_rows: List[int] = []
        slow_rows: List[int] = []
        for i in range(n):
            to_fast = export.fast[i] if (room_fast and room_slow) \
                else room_fast > 0
            if to_fast:
                fast_rows.append(i)
                room_fast -= 1
            else:
                slow_rows.append(i)
                room_slow -= 1
        new_pages: List[Optional[Page]] = [None] * n
        for rows, free, is_fast in ((fast_rows, self.free_hbm, True),
                                    (slow_rows, self.free_host, False)):
            if not rows:
                continue
            slots = [free.pop() for _ in rows]
            staged = (export.k[:, rows], export.v[:, rows])
            if is_fast:
                self._scatter(self.k_hbm, self.v_hbm, slots, staged)
            else:
                self._scatter(self.k_host, self.v_host, slots, staged)
            for i, slot in zip(rows, slots):
                page = Page(
                    page_id=self._next_id, request_id=request_id,
                    index_in_seq=export.index_in_seq[i], birth_step=step,
                    hbm_slot=slot if is_fast else None,
                    host_slot=None if is_fast else slot,
                    accesses=export.accesses[i],
                    tokens_used=export.tokens_used[i], last_used=step)
                self._next_id += 1
                self.pages[page.page_id] = page
                new_pages[i] = page
        seq = self._seq.setdefault(request_id, [])
        seq.extend(p for p in new_pages if p is not None)
        self.imported_pages += n
        return [p for p in new_pages if p is not None]

    # --------------------------------------------------------- queries
    def resident(self, page_id: int) -> bool:
        return self.pages[page_id].hbm_slot is not None

    def hbm_used(self) -> int:
        return sum(1 for p in self.pages.values() if p.hbm_slot is not None)

    def request_pages(self, request_id: int) -> List[Page]:
        """The request's ordered page list, read from the sequence table."""
        return sorted(self._seq.get(request_id, ()),
                      key=lambda p: p.index_in_seq)
