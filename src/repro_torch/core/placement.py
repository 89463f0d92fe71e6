"""Tier enforcement for real tensors: ``TorchArenaPlacer``
(``repro/core/placement.py`` ``JaxArenaPlacer``, same contract).

An arena is a named group of tensors (one parameter or moment group).
The fast tier is CUDA tensors on the placer's device (HBM); the slow tier
is ``pin_memory()`` CPU tensors (host DRAM over PCIe).  On the CPU both
tiers are CPU tensors and the tier is a label, as in the port's
``PagedKVPool``: every count is kept, no bytes move.

Fractional assignments are realised at tensor granularity: the
hottest-first stable order of the arena's entries keeps a prefix on the
fast tier whose byte count fits the recommended fraction.

The trainer-facing ``fetch_fast``/``writeback`` implement the offload
execution model: compute runs on fast-tier tensors; slow-tier entries pay
an explicit transfer each way every step (the ski-rental "rental").
``transfers_bytes`` counts what JAX counts: each entry moved by ``_apply``,
each slow entry fetched, each slow entry written back.

Copies run on PyTorch's current stream.  Host-to-device copies from pinned
memory are ``non_blocking`` (the stream orders them before any later use
and before a later copy back into the same buffer); device-to-host copies
into pinned memory block, so the host never reads or reuses a buffer the
stream has not filled yet.  A slow entry keeps its pinned buffer across
steps: ``writeback`` copies into it rather than pinning new memory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from .._device import DeviceLike, resolve_device
from .arenas import ArenaManager
from .runtime import FractionPlacer

FAST_KIND = "device"
SLOW_KIND = "pinned_host"


@dataclasses.dataclass
class TensorEntry:
    name: str
    tensor: torch.Tensor
    kind: str                      # FAST_KIND or SLOW_KIND

    @property
    def nbytes(self) -> int:
        return int(self.tensor.numel() * self.tensor.element_size())


class TorchArenaPlacer(FractionPlacer):
    """FractionPlacer whose ``_apply`` moves real tensors between HBM and
    pinned host memory (labels only when ``device`` is the CPU)."""

    def __init__(self, arenas: ArenaManager, device: DeviceLike = None):
        super().__init__(arenas)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.fast_kind = FAST_KIND
        self.slow_kind = SLOW_KIND
        self._store: Dict[int, List[TensorEntry]] = {}
        self.transfers_bytes: int = 0   # telemetry: bytes moved either way

    # ------------------------------------------------------------ movement
    def _moves(self) -> bool:
        return self.device.type == "cuda"

    def _to_slow(self, t: torch.Tensor) -> torch.Tensor:
        if not self._moves():
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)                           # blocking: the host owns it
        return host

    def _to_fast(self, t: torch.Tensor) -> torch.Tensor:
        if not self._moves():
            return t
        return t.to(self.device, non_blocking=True)

    # --------------------------------------------------------------- store
    def bind(self, arena_id: int, name: str, tensor: torch.Tensor) -> None:
        """Register a tensor; it is placed at once by the arena's current
        fast fraction (the ArenaManager decides first-touch placement, the
        placer realises it)."""
        kind = (self.fast_kind if not self._moves()
                or tensor.device == self.device else self.slow_kind)
        entries = self._store.setdefault(arena_id, [])
        for e in entries:
            if e.name == name:
                e.tensor, e.kind = tensor, kind
                break
        else:
            entries.append(TensorEntry(name=name, tensor=tensor, kind=kind))
        arena = self.arenas.arena_by_id(arena_id)
        if arena is not None and arena.fast_fraction < 1.0:
            self._apply(arena_id, arena.fast_fraction)

    def entries(self, arena_id: int) -> List[TensorEntry]:
        return self._store.get(arena_id, [])

    def _entry(self, arena_id: int, name: str) -> TensorEntry:
        for e in self._store.get(arena_id, []):
            if e.name == name:
                return e
        raise KeyError(f"arena {arena_id} has no tensor {name!r}")

    def get(self, arena_id: int, name: str) -> torch.Tensor:
        return self._entry(arena_id, name).tensor

    def kind(self, arena_id: int, name: str) -> str:
        """The tier of an entry: ``"device"`` or ``"pinned_host"``."""
        return self._entry(arena_id, name).kind

    # --------------------------------------------------------- enforcement
    def _apply(self, arena_id: int, new_fraction: float) -> None:
        entries = self._store.get(arena_id)
        if not entries:
            return
        total = sum(e.nbytes for e in entries)
        budget = int(round(new_fraction * total))
        for e in entries:                  # stable order: prefix goes fast
            target = self.fast_kind if budget >= e.nbytes else self.slow_kind
            if budget >= e.nbytes:
                budget -= e.nbytes
            if e.kind != target:
                self.transfers_bytes += e.nbytes
                e.tensor = (self._to_fast(e.tensor) if target == self.fast_kind
                            else self._to_slow(e.tensor))
                e.kind = target

    # ------------------------------------------------------ step interface
    def fetch_fast(self, arena_id: int) -> Dict[str, torch.Tensor]:
        """Fast-tier tensors of the arena for compute.  Slow entries pay a
        transfer (the rental) and come back as a separate copy; fast
        entries are returned as they are."""
        out: Dict[str, torch.Tensor] = {}
        for e in self._store.get(arena_id, []):
            if e.kind == self.fast_kind:
                out[e.name] = e.tensor
            else:
                self.transfers_bytes += e.nbytes
                out[e.name] = (self._to_fast(e.tensor) if self._moves()
                               else e.tensor.clone())
        return out

    def writeback(self, arena_id: int,
                  values: Dict[str, torch.Tensor]) -> None:
        """Store updated values, each entry keeping its tier: a slow entry
        pays the transfer back into its own pinned buffer."""
        for e in self._store.get(arena_id, []):
            if e.name not in values:
                continue
            new = values[e.name]
            if e.kind == self.slow_kind:
                self.transfers_bytes += e.nbytes
                if new is not e.tensor:
                    e.tensor.copy_(new)         # blocking into pinned memory
            else:
                e.tensor = new

    def fast_bytes(self) -> int:
        return sum(e.nbytes for entries in self._store.values()
                   for e in entries if e.kind == self.fast_kind)

    def slow_bytes(self) -> int:
        return sum(e.nbytes for entries in self._store.values()
                   for e in entries if e.kind != self.fast_kind)
