"""Spans, call records and the profiled slice of a traced run.

A traced run (``--trace 1``) splits its window in three parts that never
overlap: an untraced part (the per-layer numbers that are rates, tails and
counters), a part with synchronised host spans around the program's layers
(``Spans``), and a profiled slice (``profiled``) in which the device's
activity is recorded by ``torch.profiler`` (device only: recording every
host operator too slows the host about eightfold) while the calls that
launch the kernels are recorded by shape, without a synchronisation, so
that their work can be counted (``metrics/work.py``).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import sys
import time
import types
from typing import Callable, Dict, List, Optional, Tuple

import torch

clock = time.perf_counter


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if on_card(device):
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    """Start the device's memory peak afresh (after set-up)."""
    if on_card(device):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if on_card(device) else 0


def _set(obj, name: str, value) -> None:
    # A frozen dataclass (the port's optimizer) refuses ``setattr``; its
    # instance dictionary still takes the attribute.
    if isinstance(obj, (type, types.ModuleType)):
        setattr(obj, name, value)
    else:
        object.__setattr__(obj, name, value)


def _unset(obj, name: str) -> None:
    if isinstance(obj, (type, types.ModuleType)):
        delattr(obj, name)
    else:
        object.__delattr__(obj, name)


@contextlib.contextmanager
def patched(patches: List[Tuple[object, str, Callable]]):
    """Set ``obj.name = make(original)`` for each patch; restore every
    original on exit."""
    saved = []
    try:
        for obj, name, make in patches:
            orig = getattr(obj, name)
            saved.append((obj, name, orig, name in vars(obj)))
            _set(obj, name, make(orig))
        yield
    finally:
        for obj, name, orig, own in reversed(saved):
            if own:
                _set(obj, name, orig)
            else:
                _unset(obj, name)


class Spans:
    """Synchronised host spans: each wrapped call waits for the device
    before and after, so its wall time is its own work.  Records, by name,
    the total seconds, the calls, and the seconds of spans nested inside
    spans of another name."""

    def __init__(self):
        self.total: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.nested: Dict[Tuple[str, str], float] = {}
        self.notes: Dict[str, float] = {}
        self._stack: List[str] = []

    def wrap(self, name: str, note: Optional[Callable] = None):
        def make(fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                self._stack.append(name)
                t0 = clock()
                try:
                    out = fn(*a, **k)
                    torch.cuda.synchronize()
                finally:
                    dt = clock() - t0
                    self._stack.pop()
                    self.total[name] = self.total.get(name, 0.0) + dt
                    self.calls[name] = self.calls.get(name, 0) + 1
                    if self._stack:
                        key = (self._stack[-1], name)
                        self.nested[key] = self.nested.get(key, 0.0) + dt
                if note is not None:
                    for k2, v in note(*a, **k).items():
                        self.notes[k2] = self.notes.get(k2, 0.0) + v
                return out
            return run
        return make

    def outermost(self, names) -> float:
        """Seconds of the spans ``names``, leaving out those nested inside
        another of them."""
        inner = sum(v for (p, c), v in self.nested.items()
                    if p in names and c in names)
        return sum(self.total.get(n, 0.0) for n in names) - inner


class Calls:
    """Kernel-launching calls recorded by shape during the profiled slice,
    in launch order; tensors are kept by reference and read after it."""

    def __init__(self):
        self.log: List[Tuple[str, Dict]] = []

    def record(self, kind: str, make_info: Callable):
        def make(fn):
            def run(*a, **k):
                self.log.append((kind, make_info(*a, **k)))
                return fn(*a, **k)
            return run
        return make


@dataclasses.dataclass
class DeviceSlice:
    events: List[Tuple[str, float, float]]   # (name, start s, end s)
    window_s: float
    busy_s: float
    host_marks: List[Tuple[float, float, str]]  # (start, end, phase), same
    calls: List[Tuple[str, Dict]]               # clock as events


def _busy(events) -> float:
    """Seconds in which any device operation ran (union of intervals)."""
    busy, end = 0.0, float("-inf")
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def profiled(run: Callable[[], None], calls: Calls,
             marks: List[Tuple[float, float, str]], tries: int = 3
             ) -> Optional[DeviceSlice]:
    """``run()`` under ``torch.profiler`` recording the device only.  A
    profile that saw no device activity is taken again, up to ``tries``
    times; then None (the device metrics read "not measured").  Each try
    starts with a marker kernel launched on an idle device, which aligns
    the host's clock with the profile's."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        calls.log.clear()
        marks.clear()
        marker = torch.zeros(4096, device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_mark = clock()
            marker.add_(1.0)
            torch.cuda.synchronize()
            t0 = clock()
            run()
            torch.cuda.synchronize()
            t1 = clock()
        raw = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
               for e in prof.events()
               if str(e.device_type).endswith("CUDA")]
        if not raw:
            print(f"portbench: profile attempt {attempt + 1} of {tries} saw "
                  f"no device activity", file=sys.stderr)
            continue
        raw.sort(key=lambda e: e[1])
        shift = raw[0][1] - t_mark            # the marker: first event
        events = [(n, a - shift, b - shift) for n, a, b in raw[1:]
                  if a - shift >= t0 - 1e-3]
        return DeviceSlice(events=events, window_s=t1 - t0,
                           busy_s=_busy(events), host_marks=list(marks),
                           calls=list(calls.log))
    return None


def marking(marks: List[Tuple[float, float, str]], phase: str):
    """A wrapper that notes when the host was in ``phase`` (no
    synchronisation), for the attribution of the device's idle gaps."""
    def make(fn):
        def run(*a, **k):
            t0 = clock()
            try:
                return fn(*a, **k)
            finally:
                marks.append((t0, clock(), phase))
        return run
    return make


def breakdown(sl: DeviceSlice, top: int = 10) -> Dict:
    """The device operations that took most time, and the idle gaps summed
    by the innermost host phase under each gap's middle."""
    by_op: Dict[str, float] = {}
    for n, a, b in sl.events:
        by_op[n] = by_op.get(n, 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    marks = sorted(sl.host_marks)
    starts = [m[0] for m in marks]
    gaps: Dict[str, float] = {}
    end = None
    for _, a, b in sorted(sl.events, key=lambda e: e[1]):
        if end is not None and a > end:
            mid = 0.5 * (a + end)
            phase = "harness"
            # Marks nest as calls do: the innermost one holding ``mid`` is
            # the latest to start before it that has not ended.
            for j in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 65),
                           -1):
                if marks[j][1] >= mid:
                    phase = marks[j][2]
                    break
            gaps[phase] = gaps.get(phase, 0.0) + (a - end)
        end = b if end is None else max(end, b)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
