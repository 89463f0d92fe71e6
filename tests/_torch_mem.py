"""Shared helper of the simulator parity tests: run the same workload on
the JAX package's and the port's ``MemorySimulator`` and hold every field
of every result equal."""

import dataclasses

from repro import core as jcore
from repro import mem as jmem
from repro.mem import workloads as jwl
from repro_torch import core as tcore
from repro_torch import mem as tmem
from repro_torch.mem import workloads as twl


def results_equal(a, b) -> None:
    """Every field of two ``SimResult``s, the phase records' included,
    equal exactly."""
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    assert len(da["phase_records"]) == len(db["phase_records"]) > 0
    for ra, rb in zip(da.pop("phase_records"), db.pop("phase_records")):
        assert ra == rb
    assert da == db


def run_both(build, runs):
    """``runs``: (method name, args, kwargs) run on both packages'
    simulators of ``build(package workloads module)``."""
    jwl_, twl_ = build(jwl), build(twl)
    assert dataclasses.asdict(jwl_) == dataclasses.asdict(twl_)
    jsim = jmem.MemorySimulator(jcore.CLX, jwl_)
    tsim = tmem.MemorySimulator(tcore.CLX, twl_)
    out = []
    for name, args, kwargs in runs:
        a = getattr(jsim, name)(*args, **kwargs)
        b = getattr(tsim, name)(*args, **kwargs)
        results_equal(a, b)
        out.append((a, b))
    return out
