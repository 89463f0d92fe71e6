"""FT01 — serving/fault-tolerance code must take its clock by injection
(``repro/check/rules/ft01.py``, word for word in its contract).

The elastic-serving layer (``serve/``) and the fault-tolerance package
(``ft/``) are tested against deterministic failure timelines: the router
beats its ``HeartbeatMonitor`` with a step-counter clock, and the tests
replay crashes at exact ticks.  A direct ``time.time()`` /
``time.monotonic()`` (or ``perf_counter``) call inside those packages
reads the wall clock behind the injected clock's back, so heartbeat
timeouts, straggler EWMAs and failover decisions stop being replayable.

The sanctioned pattern passes the clock in as a parameter and *calls the
parameter*::

    def __init__(self, ..., clock: Callable[[], float] = time.monotonic):
        self.clock = clock          # reference, not a call — FT01-clean
        ...
        now = self.clock()

Only files whose directory path contains a ``serve`` or ``ft``
component are in scope; launchers and benchmarks may time themselves
with the wall clock freely.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from ..registry import Module, Rule, register
from ..report import Finding

_WALL_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
}

_SCOPE_DIRS = {"serve", "ft"}


def _in_scope(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return any(p in _SCOPE_DIRS for p in parts[:-1])


@register
class Ft01(Rule):
    id = "FT01"
    title = ("wall-clock call in serve/ or ft/ — inject the clock "
             "(clock=time.monotonic parameter) instead")

    def check(self, module: Module) -> Iterator[Finding]:
        if not _in_scope(module.path):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = module.imports.qualname(node.func)
            if qn in _WALL_CALLS:
                yield module.finding(
                    node, self.id,
                    f"direct wall-clock call '{qn}()' in {module.path} — "
                    f"serve/ft code must call an injected clock parameter "
                    f"(default it to {qn} instead of calling it) so "
                    f"failure timelines stay replayable")
