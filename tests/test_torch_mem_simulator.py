"""The port's memory simulator (``repro_torch.mem``) against the JAX
package's (``repro.mem``): the same workloads, the same floats.

Every run of ``tests/test_mem_simulator.py`` at the medium inputs (the
four CORAL workloads at five capacities under first-touch, offline and
online; the SPEC set under first-touch and online at 20%) gives equal
``SimResult`` and ``PhaseRecord`` fields, exactly: the port's copy runs the
same numpy and Python arithmetic over its own copy of ``core``.  The
large and huge inputs, hardware caching and fragmentation are in
``test_torch_mem_simulator_large.py`` (one file each keeps a worker under a
minute).  Each result is computed once; nothing here is timed."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from _torch_mem import run_both  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.mem import rss_backends as jrss  # noqa: E402
from repro.mem import workloads as jwl  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.mem import rss_backends as trss  # noqa: E402
from repro_torch.mem import workloads as twl  # noqa: E402

CAPS = (0.1, 0.2, 0.3, 0.4, 0.5)


def test_hardware_model_is_the_references():
    assert dataclasses.asdict(tcore.CLX) == dataclasses.asdict(jcore.CLX)


@pytest.mark.parametrize("name", sorted(jwl.CORAL))
@pytest.mark.parametrize("cap_frac", CAPS)
def test_coral_medium_results_equal(name, cap_frac):
    """Figure 6's sweep: first-touch, offline and online at each capacity,
    and the online run's speedup over first-touch (the paper's claim) the
    same number in both packages."""
    peak = twl.CORAL[name]("medium").peak_rss
    cap = int(peak * cap_frac)
    (ft_j, ft_t), (off_j, off_t), (on_j, on_t) = run_both(
        lambda m: m.CORAL[name]("medium"),
        [("run_first_touch", (cap,), {}), ("run_offline", (cap,), {}),
         ("run_online", (cap,), {})])
    assert on_t.speedup_over(ft_t) == on_j.speedup_over(ft_j) > 1.3
    assert off_t.speedup_over(ft_t) == off_j.speedup_over(ft_j) > 1.3


@pytest.mark.parametrize("name", sorted(jwl.SPEC))
def test_spec_results_equal(name):
    peak = twl.SPEC[name]().peak_rss
    cap = int(peak * 0.2)
    run_both(lambda m: m.SPEC[name](),
             [("run_first_touch", (cap,), {}), ("run_online", (cap,), {})])


def test_offline_strategies_and_all_fast_equal():
    """The offline knapsack and ski-rental-free strategies and the all-fast
    baseline on the smallest CORAL input."""
    cap = int(twl.snap("medium").peak_rss * 0.3)
    run_both(lambda m: m.snap("medium"),
             [("run_all_fast", (), {}),
              ("run_offline", (cap,), {"strategy": "knapsack"}),
              ("run_offline", (cap,), {"strategy": "thermos"})])


def test_build_hpc_and_spec_workload_equal():
    """The workload builders themselves, off the named configurations:
    late hot allocation, strong size/heat correlation."""
    kw = dict(n_sites=57, read_GBps=80.0, write_GBps=12.0, zipf_s=1.1,
              rand_frac=0.2, size_heat_corr=0.7, hot_alloc_late=0.3,
              phases=12, seed=5)
    assert dataclasses.asdict(jwl.build_hpc("x", 3.5, **kw)) == \
        dataclasses.asdict(twl.build_hpc("x", 3.5, **kw))
    args = ("y", 2.0, 40, 90, 20, 0.8, 0.02, 0.3, 11, 0.2)
    assert dataclasses.asdict(jwl.spec_workload(*args)) == \
        dataclasses.asdict(twl.spec_workload(*args))


def allocation_sequence(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        arena = int(rng.integers(0, 12))
        nbytes = int(rng.integers(1, 3 * 4096 * 64))
        yield ("allocate" if rng.random() < 0.7 else "release"), arena, \
            nbytes


@pytest.mark.parametrize("backend", ["PagemapWalkRSS", "VMACounterRSS"])
def test_rss_backends_collect_equal(backend):
    """Both RSS backends give the reference's ``collect()`` on the same
    allocation and release sequence, at every tenth operation."""
    j, t = getattr(jrss, backend)(), getattr(trss, backend)()
    for i, (op, arena, nbytes) in enumerate(allocation_sequence(3)):
        getattr(j, op)(arena, nbytes)
        getattr(t, op)(arena, nbytes)
        if i % 10 == 9:
            assert t.collect() == j.collect()
    if backend == "PagemapWalkRSS":
        assert t.lock_events == j.lock_events > 0
    stats = trss.time_collect(t)
    assert set(stats) == set(jrss.time_collect(j)) == {"mean_s", "max_s"}
