"""The port's memory simulator against the JAX package's at the large and
huge inputs of ``tests/test_mem_simulator.py`` (Figure 8 and the QMCPACK
pathology): first-touch, offline, online, hardware caching and online
with fragmentation at the DRAM capacity, every ``SimResult`` and
``PhaseRecord`` field equal exactly.  The medium inputs are in
``test_torch_mem_simulator.py``."""

import pytest

pytest.importorskip("jax")

from repro import core as jcore  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from _torch_mem import run_both  # noqa: E402

DRAM = tcore.CLX.fast.capacity_bytes


@pytest.mark.parametrize("name", ["lulesh", "amg", "snap"])
def test_large_guided_and_hw_cache_equal(name):
    assert DRAM == jcore.CLX.fast.capacity_bytes
    runs = run_both(lambda m: getattr(m, name)("large"),
                    [(policy, (DRAM,), {}) for policy in (
                        "run_first_touch", "run_offline", "run_online",
                        "run_hw_cache")])
    (ft, _), (off, _), (on, _), (hw, _) = [(t, j) for j, t in runs]
    assert off.speedup_over(ft) > 1.8 and on.speedup_over(ft) > 1.3
    assert off.speedup_over(hw) >= 0.95


@pytest.mark.parametrize("size", ["large", "huge"])
def test_qmcpack_pathology_equal(size):
    runs = [("run_first_touch", (DRAM,), {}), ("run_online", (DRAM,), {}),
            ("run_hw_cache", (DRAM,), {})]
    if size == "large":
        runs.append(("run_online", (DRAM,), {"fragmentation": True}))
    out = [t for _, t in run_both(lambda m: m.qmcpack(size), runs)]
    ft, on, hw = out[:3]
    assert 2.0 <= hw.speedup_over(on) <= 7.5
    if size == "large":
        assert out[3].speedup_over(on) > 1.5
