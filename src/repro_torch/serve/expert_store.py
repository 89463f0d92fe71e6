"""Tiered MoE expert weights: guided expert tiering — the port of
``repro/serve/expert_store.py``.

The third tier object under the paper's online loop, after KV pages and
shared prefixes.  MoE expert FFN blocks are the largest tierable objects
of a serving engine; keeping only a bounded cache of them on the card
opens models larger than the card's memory.

* **ExpertStore** owns the (layer, expert) weight blocks.  The host tier is
  the authoritative, immutable copy of every block, flattened to
  ``(n_layers * n_experts, ...)`` tensors in pinned host memory (plain CPU
  tensors when the store runs on the CPU); the fast tier is a bounded
  ``(cache_slots, ...)`` cache on the device shared by all layers.  Each
  block is one contiguous row of the host tensors, so a fetch is one
  ``copy_(non_blocking=True)`` per block and weight straight from pinned
  memory.  Weights never change, so *demotion is metadata only*: the slot
  is released and the host copy stays authoritative.

* **Double-buffered prefetch.**  While layer L's FFN runs, the forecast
  working set of the next layer is copied into its reserved slots on a
  side CUDA stream (``prefetch``) and the slots are handed over when that
  layer dispatches (``_commit_pending``).  Two fences make this safe with
  a cache written in place while the host runs ahead of the card:
  the side stream first waits on an event recorded on the compute stream
  when the prefetch is issued, so the copy lands only after every launch
  queued before it (the previous readers of a slot the prefetch evicted);
  and the commit makes the compute stream wait on the copy's event, so the
  FFN that reads the slots runs after the copy.  No staging buffer is
  needed, so the card holds nothing beyond the cache.  Demand fetches and
  the controller's promotions copy on the compute stream.  A forecast that
  misses falls back to the demand fetch, so results are bitwise the same
  with the prefetcher on or off.

* **ExpertBackend** is the ``TierBackend`` face: arena = one layer's
  expert population, chunk = one expert block.  Per-dispatch routed-token
  counts are the access profile; ski-rental decides promote/demote; blocks
  named in the most recent dispatch of their layer never demote.

Correctness: the slot indirection rides the grouped FFN's
``group_experts`` map (``models.moe.apply_dropless_flat``), and each row's
bits depend on its expert's weights alone, not on the weight array's row
count or the slot, so a dispatch whose working set fits the cache equals
the resident path bitwise.  A working set that cannot fit raises
``ExpertCacheMissError`` naming ``ServeConfig.expert_cache_size``.

Modeled time: the store keeps the reference's deterministic modeled clock
(round constants): each dispatch adds its weight-read time at fast-tier
bandwidth to ``m_compute_s``; a demand fetch adds transfer time at
slow-tier bandwidth plus a fixed latency to ``m_blocked_s``; a committed
prefetch adds only what the overlap window could not hide.  ``hw`` is the
engine's (the H100 model); there is no default.
"""

from __future__ import annotations

import dataclasses
from typing import (Dict, FrozenSet, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core import MigrationPlan, MoveStats
from ..core.fragmentation import ChunkStats
from ..core.hwmodel import HardwareModel
from ..core.profiler import ArenaProfile, IntervalProfile

# Modeled-time constants (deliberately round, as in the reference).
FETCH_LATENCY_S = 10e-6       # per batched host->device transfer
DISPATCH_OVERHEAD_S = 20e-6   # per dispatch launch

_WEIGHTS = ("w_gate", "w_up", "w_down")


class ExpertCacheMissError(RuntimeError):
    """A dispatch's expert working set cannot fit the expert cache.

    Raised before any grouped FFN runs with an incomplete slot map — the
    tiered path never dispatches against wrong weights.  The message names
    the knob (``ServeConfig.expert_cache_size``)."""


@dataclasses.dataclass
class ExpertBlock:
    """Tier state of one (layer, expert) FFN weight block."""

    layer: int
    expert: int
    slot: Optional[int] = None    # cache row, None = host only
    accesses: float = 0.0         # routed-token count (decayed by reweight)
    birth_step: int = 0
    last_used: int = -1           # step of the last dispatch that read it
    fetches: int = 0


@dataclasses.dataclass
class _PendingFetch:
    """One prefetch in flight: blocks copied into reserved slots, handed
    over when the target layer dispatches."""

    layer: int
    experts: List[int]
    slots: List[int]
    done: Optional[torch.cuda.Event]   # the side-stream copy (None: CPU)
    hide_s: float                      # modeled overlap window at issue


class ExpertStore:
    """Host-authoritative expert weights with a bounded device cache.

    ``moe_params[name][l]`` is layer l's ``(n_experts, ...)`` block stack of
    ``w_gate``/``w_up``/``w_down`` (a stacked ``(L, E, ...)`` tensor or a
    list of per-layer tensors).  The store copies them bitwise into its
    host tier; the caller may drop its own copies afterwards.
    """

    def __init__(self, moe_params: Mapping[str, Sequence[torch.Tensor]],
                 n_layers: int, n_experts: int, cache_slots: int, *,
                 hw: HardwareModel, double_buffer: bool = True,
                 window_bytes: int = 0, device: DeviceLike = None):
        if cache_slots <= 0:
            raise ValueError(
                f"ExpertStore needs at least one cache slot, got "
                f"{cache_slots} (ServeConfig.expert_cache_size)")
        L, E = n_layers, n_experts
        self.n_layers = L
        self.n_experts = E
        self.cache_slots = min(cache_slots, L * E)
        self.double_buffer = double_buffer
        self.hw = hw
        self.window_bytes = int(window_bytes)
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if cuda else None

        # One host allocation for the three weights: pinned memory is
        # allocated in power-of-two sizes, so one buffer wastes least.
        shapes = {name: tuple(moe_params[name][0].shape)
                  for name in _WEIGHTS}
        dtype = moe_params["w_gate"][0].dtype
        item = torch.empty((), dtype=dtype).element_size()
        sizes = {name: L * int(np.prod(shape)) * item
                 for name, shape in shapes.items()}
        buf = torch.empty((sum(sizes.values()),), dtype=torch.uint8,
                          pin_memory=cuda)
        self.block_bytes = 0
        off = 0
        for name in _WEIGHTS:
            layers, shape = moe_params[name], shapes[name]
            assert shape[0] == E, (name, shape, E)
            host = buf[off:off + sizes[name]].view(dtype).view(
                (L * E,) + shape[1:])
            off += sizes[name]
            for l in range(L):
                host[l * E:(l + 1) * E].copy_(layers[l])
            setattr(self, name + "_host", host)
            cache = torch.zeros((self.cache_slots,) + shape[1:],
                                dtype=host.dtype, device=self.device)
            if cuda:
                # The side stream writes the cache: its memory is not
                # reused before that stream's last copy when freed.
                cache.record_stream(self._side)
            setattr(self, name + "_cache", cache)
            self.block_bytes += host[0].numel() * host.element_size()

        self.blocks: Dict[Tuple[int, int], ExpertBlock] = {
            (l, e): ExpertBlock(l, e) for l in range(L) for e in range(E)}
        self._free: List[int] = list(range(self.cache_slots))
        self._owner: List[Optional[Tuple[int, int]]] = (
            [None] * self.cache_slots)
        self._pinned: FrozenSet[int] = frozenset()   # last dispatch's slots
        self._reserved: set = set()                  # pending-prefetch slots
        self._pending: Dict[int, _PendingFetch] = {}
        self._last_prefetched: Dict[int, FrozenSet[int]] = {}
        self.dispatching: Dict[int, FrozenSet[int]] = {}
        self.prev_needed: Dict[int, List[int]] = {}
        self._last_window_s = 0.0
        self._rental_bytes = 0
        self.reset_counters()

    # ------------------------------------------------------------ identity
    def chunk_id(self, layer: int, expert: int) -> int:
        return layer * self.n_experts + expert

    def from_chunk(self, cid: int) -> Tuple[int, int]:
        return divmod(cid, self.n_experts)

    def is_resident(self, layer: int, expert: int) -> bool:
        return self.blocks[(layer, expert)].slot is not None

    def resident_count(self) -> int:
        return self.cache_slots - len(self._free) - len(self._reserved)

    @property
    def cache_bytes(self) -> int:
        return self.cache_slots * self.block_bytes

    def host_weights(self, name: str, layer: int) -> torch.Tensor:
        """Layer ``layer``'s ``(n_experts, ...)`` stack of weight ``name``
        in the host tier (a view)."""
        E = self.n_experts
        return getattr(self, name + "_host")[layer * E:(layer + 1) * E]

    def upload(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the store's device without waiting for
        the card: through pinned memory, asynchronously, on the card."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------------ counters
    def reset_counters(self) -> None:
        self.demand_fetches = 0
        self.prefetch_fetches = 0
        self.prefetch_hits = 0
        self.dropped_prefetches = 0
        self.evictions = 0
        self.bytes_fetched = 0
        self.transfer_events = 0
        self.m_compute_s = 0.0
        self.m_blocked_s = 0.0

    def take_rental_bytes(self) -> int:
        """Drain the bytes demand-fetched since the last drain — the engine
        feeds them to ``GuidanceRuntime.record_rental`` (slow-tier rent
        actually paid), as it does KV swap-ins."""
        nb, self._rental_bytes = self._rental_bytes, 0
        return nb

    # ------------------------------------------------------------ movement
    def _copy(self, pairs: Sequence[Tuple[int, int]],
              slots: Sequence[int]) -> None:
        """Copy blocks from the host tier into cache slots on the current
        stream: one ``copy_`` per block and weight, each from a contiguous
        pinned row.  ``transfer_events`` counts one batched transfer per
        weight array, as the reference does."""
        E = self.n_experts
        for name in _WEIGHTS:
            host = getattr(self, name + "_host")
            cache = getattr(self, name + "_cache")
            for (l, e), s in zip(pairs, slots):
                cache[s].copy_(host[l * E + e], non_blocking=True)
            self.transfer_events += 1
        self.bytes_fetched += self.block_bytes * len(pairs)

    def _install(self, pairs: Sequence[Tuple[int, int]],
                 slots: Sequence[int], step: int, *,
                 prefetched: bool) -> None:
        for (l, e), s in zip(pairs, slots):
            b = self.blocks[(l, e)]
            b.slot = int(s)
            b.last_used = step
            b.fetches += 1
            self._owner[int(s)] = (l, e)
        if prefetched:
            self.prefetch_fetches += len(pairs)
        else:
            self.demand_fetches += len(pairs)
            self._rental_bytes += self.block_bytes * len(pairs)

    def _evict(self, block: ExpertBlock) -> int:
        """Metadata-only demotion: the host copy is authoritative and
        immutable, so no bytes move back."""
        s = block.slot
        assert s is not None
        block.slot = None
        self._owner[s] = None
        self.evictions += 1
        return s

    def _evictable(self, protect: FrozenSet[int]) -> List[ExpertBlock]:
        out = [b for b in self.blocks.values()
               if b.slot is not None and b.slot not in protect
               and b.slot not in self._reserved]
        # LRU with a total deterministic order.
        out.sort(key=lambda b: (b.last_used, b.layer, b.expert))
        return out

    def _acquire_slots(self, n: int, protect: FrozenSet[int]) -> List[int]:
        """Take ``n`` cache slots: the free list first, then LRU eviction of
        unprotected residents.  Returns fewer than ``n`` when the cache is
        too pinned — callers decide whether that is an error."""
        slots: List[int] = []
        while self._free and len(slots) < n:
            slots.append(self._free.pop())
        if len(slots) < n:
            for b in self._evictable(protect)[:n - len(slots)]:
                slots.append(self._evict(b))
        return slots

    # ------------------------------------------------------------ prefetch
    def can_prefetch(self, layer: int) -> bool:
        """Whether ``prefetch(layer, ...)`` may put anything in flight —
        checked before the engine reads a forecast off the card."""
        return self.double_buffer and layer not in self._pending

    def _commit_pending(self, layer: int, step: int) -> None:
        pend = self._pending.pop(layer, None)
        if pend is None:
            return
        if pend.done is not None:
            # The FFN that reads these slots runs after the copy.
            torch.cuda.current_stream(self.device).wait_event(pend.done)
        self._reserved.difference_update(pend.slots)
        pairs = [(layer, e) for e in pend.experts]
        self._install(pairs, pend.slots, step, prefetched=True)
        cost = (len(pairs) * self.block_bytes
                / (self.hw.slow.read_bw_GBps * 1e9) + FETCH_LATENCY_S)
        self.m_blocked_s += max(0.0, cost - pend.hide_s)
        self._last_prefetched[layer] = frozenset(pend.experts)

    def prefetch(self, layer: int, step: int,
                 predicted: Optional[Sequence[int]] = None) -> int:
        """Put ``layer``'s forecast working set in flight while the current
        dispatch computes.

        ``predicted`` is the engine's speculative-gating forecast, hottest
        first: exactly its absent members are staged.  Without it (the
        wrap-around to the next step's first dispatch) the store falls back
        to recency (that layer's previous dispatch) and the guidance
        profile's hottest blocks.  Returns the number of blocks put in
        flight."""
        if not self.can_prefetch(layer):
            return 0
        if predicted is not None:
            want_set = [int(e) for e in predicted]
            targets = [e for e in want_set if not self.is_resident(layer, e)]
        else:
            prev = self.prev_needed.get(layer)
            if not prev:
                return 0                  # never dispatched: no forecast
            want = len(prev)
            ranked = sorted(
                (self.blocks[(layer, e)] for e in range(self.n_experts)
                 if e not in prev),
                key=lambda b: (-b.accesses, b.expert))
            want_set = list(prev)
            targets = [e for e in prev if not self.is_resident(layer, e)]
            targets += [b.expert for b in ranked
                        if b.slot is None][:max(want - len(targets), 0)]
            targets = targets[:want]
        if not targets:
            return 0
        # Never evict the current dispatch's pins or the forecast's
        # resident members (that would turn forecast hits into misses).
        protect = self._pinned | frozenset(
            self.blocks[(layer, e)].slot for e in want_set
            if self.blocks[(layer, e)].slot is not None)
        slots = self._acquire_slots(len(targets), protect)
        if len(slots) < len(targets):
            self.dropped_prefetches += len(targets) - len(slots)
            targets = targets[:len(slots)]
        if not targets:
            return 0
        pairs = [(layer, e) for e in targets]
        done = None
        if self._side is None:
            self._copy(pairs, slots)
        else:
            # The copy may overwrite slots that launches already queued on
            # the compute stream still read: land it after all of them.
            queued = torch.cuda.current_stream(self.device).record_event()
            with torch.cuda.stream(self._side):
                self._side.wait_event(queued)
                self._copy(pairs, slots)
                done = self._side.record_event()
        self._reserved.update(slots)
        self._pending[layer] = _PendingFetch(
            layer, targets, slots, done, self._last_window_s)
        return len(targets)

    # ------------------------------------------------------------ dispatch
    def dispatch(self, layer: int, counts, step: int) -> np.ndarray:
        """Make ``layer``'s routed experts resident and return the (E,)
        slot map for the grouped FFN (-1 for absent, unrouted blocks).

        ``counts`` is the dispatch's per-expert routed-token histogram,
        also the access profile.  Order: commit this layer's prefetch, pin
        the needed set, demand-fetch the misses in one batch on the compute
        stream (after every queued reader of the slots it evicts), then
        account."""
        counts = np.asarray(counts)
        assert counts.shape == (self.n_experts,), counts.shape
        needed = [int(e) for e in np.nonzero(counts)[0]]
        self._commit_pending(layer, step)

        committed = self._last_prefetched.pop(layer, frozenset())
        self.prefetch_hits += len(committed.intersection(needed))

        resident_slots = frozenset(
            self.blocks[(layer, e)].slot for e in needed
            if self.blocks[(layer, e)].slot is not None)
        missing = [e for e in needed
                   if self.blocks[(layer, e)].slot is None]
        if missing:
            slots = self._acquire_slots(len(missing), resident_slots)
            if len(slots) < len(missing):
                for s in slots:           # undo: nothing was transferred
                    self._free.append(s)
                have = len(needed) - len(missing) + len(slots)
                raise ExpertCacheMissError(
                    f"expert cache cannot hold layer {layer}'s dispatch "
                    f"working set: {len(needed)} distinct experts routed "
                    f"but only {have} fit a {self.cache_slots}-slot cache "
                    f"({len(self._reserved)} reserved by in-flight "
                    f"prefetch); raise ServeConfig.expert_cache_size or "
                    f"disable ServeConfig.expert_offchip")
            pairs = [(layer, e) for e in missing]
            self._copy(pairs, slots)
            self._install(pairs, slots, step, prefetched=False)
            self.m_blocked_s += (
                len(missing) * self.block_bytes
                / (self.hw.slow.read_bw_GBps * 1e9) + FETCH_LATENCY_S)

        slot_map = np.full(self.n_experts, -1, dtype=np.int32)
        for e in needed:
            b = self.blocks[(layer, e)]
            b.accesses += float(counts[e])
            b.last_used = step
            slot_map[e] = b.slot
        self._pinned = frozenset(int(slot_map[e]) for e in needed)
        self.dispatching[layer] = frozenset(needed)
        self.prev_needed[layer] = needed

        t_comp = ((self.window_bytes + len(needed) * self.block_bytes)
                  / (self.hw.fast.read_bw_GBps * 1e9))
        self.m_compute_s += t_comp + DISPATCH_OVERHEAD_S
        # What a prefetch issued now can hide: this dispatch's weight reads
        # plus the two launches before the next FFN needs it.
        self._last_window_s = t_comp + 2 * DISPATCH_OVERHEAD_S
        return slot_map

    # ----------------------------------------------------- controller face
    def drop_many(self, pairs: Sequence[Tuple[int, int]]
                  ) -> List[Tuple[int, int]]:
        """Demote blocks (metadata only).  Blocks named in their layer's
        most recent dispatch, pinned or reserved slots are refused."""
        dropped = []
        for l, e in pairs:
            b = self.blocks[(l, e)]
            if b.slot is None or b.slot in self._pinned \
                    or b.slot in self._reserved \
                    or e in self.dispatching.get(l, frozenset()):
                continue
            self._free.append(self._evict(b))
            dropped.append((l, e))
        return dropped

    def fetch_many(self, pairs: Sequence[Tuple[int, int]], step: int
                   ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
        """Promote blocks into *free* slots only (one batch on the compute
        stream); the controller never evicts on promote — refusals are
        reported back so the plan reflects what exists."""
        want = [(l, e) for l, e in pairs if not self.is_resident(l, e)]
        room = len(self._free)
        take, refused = want[:room], want[room:]
        if take:
            slots = [self._free.pop() for _ in take]
            self._copy(take, slots)
            self._install(take, slots, step, prefetched=True)
        return take, refused

    def reweight(self, decay: float) -> None:
        for b in self.blocks.values():
            b.accesses *= decay

    def fast_resident_bytes(self) -> int:
        return sum(self.block_bytes for b in self.blocks.values()
                   if b.slot is not None)


class ExpertBackend:
    """``TierBackend`` over an ``ExpertStore``: arena = one layer's expert
    population, chunk = one (layer, expert) block.  Same contract as
    ``PagedKVBackend`` — demotions first, promotions bounded by free
    slots, refusals reflected into ``last_recs``."""

    name = "expert"

    def __init__(self, store: ExpertStore, clock):
        self.store = store
        self.clock = clock
        self.last_recs: Dict[int, bool] = {}
        self._telemetry: Dict[int, List[ChunkStats]] = {}

    # ------------------------------------------------------------- protocol
    def snapshot(self) -> IntervalProfile:
        st = self.store
        step = self.clock()
        rows: List[ArenaProfile] = []
        telemetry: Dict[int, List[ChunkStats]] = {}
        for l in range(st.n_layers):
            blocks = [st.blocks[(l, e)] for e in range(st.n_experts)]
            fast = sum(1 for b in blocks if b.slot is not None)
            rows.append(ArenaProfile(
                arena_id=l, site_id=l, label=f"moe_l{l}",
                accesses=sum(b.accesses for b in blocks),
                resident_bytes=len(blocks) * st.block_bytes,
                fast_fraction=fast / len(blocks)))
            telemetry[l] = [
                ChunkStats(chunk_id=st.chunk_id(l, b.expert),
                           nbytes=st.block_bytes, accesses=b.accesses,
                           age=step - b.birth_step,
                           fast=b.slot is not None)
                for b in blocks]
        self._telemetry = telemetry
        return IntervalProfile(step, rows, 0, 0.0)

    def telemetry(self) -> Mapping[int, Sequence[ChunkStats]]:
        return self._telemetry

    def reweight(self, decay: float) -> None:
        self.store.reweight(decay)

    def on_plan(self, plan: MigrationPlan) -> None:
        self.last_recs = dict(plan.chunk_placement)

    def enforce(self, plan: MigrationPlan) -> MoveStats:
        stats = MoveStats()
        st = self.store
        placement = sorted(plan.chunk_placement.items())
        demote = [st.from_chunk(cid) for cid, fast in placement if not fast]
        dropped = st.drop_many(demote)
        # Logical bytes leaving the fast tier; demotion is metadata only.
        stats.bytes_demoted = st.block_bytes * len(dropped)
        want = [st.from_chunk(cid) for cid, fast in placement if fast]
        done, refused = st.fetch_many(want, self.clock())
        stats.bytes_promoted = st.block_bytes * len(done)
        for l, e in refused:
            stats.dropped_promotions += 1
            self.last_recs[st.chunk_id(l, e)] = False
        return stats

    def fast_bytes(self) -> int:
        return self.store.fast_resident_bytes()
