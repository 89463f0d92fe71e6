"""The traffic generator: the same seed gives the same schedule, another
seed the same sizes and times with other token ids and sampling seeds."""

import collections

import numpy as np
import pytest

from portbench.harness import catalog, traffic


@pytest.mark.parametrize("name", ["granite_8b.chat_tiered",
                                  "granite_8b.rag_resident"])
def test_same_seed_same_schedule(name):
    mix = catalog.cell(name)["mix"]
    a = traffic.make(mix, 2 ** 31 + 17, 49152, 51.0)
    b = traffic.make(mix, 2 ** 31 + 17, 49152, 51.0)
    assert a == b


@pytest.mark.parametrize("name", ["granite_8b.chat_tiered",
                                  "granite_8b.rag_resident"])
def test_other_seed_same_work_same_order(name):
    mix = catalog.cell(name)["mix"]
    a = traffic.make(mix, 5, 49152, 51.0)
    b = traffic.make(mix, 6, 49152, 51.0)
    assert a != b
    assert [x.due for x in a.arrivals] == [x.due for x in b.arrivals]
    for get in (lambda s: [len(x.prompt) for x in s.sessions],
                lambda s: [len(x.prompt) for x in s.arrivals],
                lambda s: [x.max_tokens for x in s.arrivals],
                lambda s: [x.greedy for x in s.arrivals],
                lambda s: [t for x in s.sessions for t in x.turn_tokens]):
        assert get(a) == get(b)
    assert len(a.arrivals) == len(b.arrivals)
    assert sum(x.max_tokens for x in a.sessions) == sum(
        x.max_tokens for x in b.sessions)


def test_every_arrival_falls_in_the_horizon():
    mix = catalog.cell("granite_8b.rag_resident")["mix"]
    for seed in range(5):
        s = traffic.make(mix, seed, 49152, 51.0)
        assert len(s.arrivals) == int(np.floor(0.32 * 51.0))
        assert all(0 <= a.due <= 51.0 for a in s.arrivals)
        assert [a.due for a in s.arrivals] == sorted(a.due
                                                     for a in s.arrivals)


def test_stratified_choice_keeps_exact_shares_well_mixed():
    v = traffic.stratified({"kind": "choice", "values": [16, 32, 64],
                            "weights": [0.25, 0.5, 0.25]}, 48).tolist()
    assert collections.Counter(v) == {16: 12, 32: 24, 64: 12}
    # Mixed: no quarter of the list holds one value alone.
    assert all(len(set(v[i:i + 12])) > 1 for i in range(0, 48, 12))


def test_stratified_uniform_and_exponential_quantiles():
    u = np.sort(traffic.stratified({"kind": "uniform", "low": 1024,
                                    "high": 4096}, 4))
    # Midpoints of four equal bins of the 3073 integers.
    assert u.tolist() == [1024 + int(q * 3073) for q in
                          (0.125, 0.375, 0.625, 0.875)]
    e = np.sort(traffic.stratified({"kind": "exponential", "mean": 2.0},
                                   2))
    assert np.allclose(e, [-2.0 * np.log(0.75), -2.0 * np.log(0.25)])


def test_session_budget_fills_the_context_limit():
    mix = catalog.cell("granite_8b.chat_tiered")["mix"]
    s = traffic.make(mix, 3, 49152, 51.0)
    assert len(s.sessions) == 48
    for x in s.sessions:
        assert len(x.prompt) - 1 + x.max_tokens == 4224
    assert sum(x.greedy for x in s.sessions) == 24
