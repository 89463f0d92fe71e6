"""Scheduler-policy conformance on the port (the reference suite
``tests/test_scheduler_policy.py`` on ``repro_torch``'s ``Engine`` and
``LLM``, ``llama3_2_1b`` SMOKE in f32 with the JAX package's weights):
every registered policy keeps every sampled stream bitwise under
preemption by recompute and chunked-prefill interleaving, finishes
leak-free and starves nobody; plus the policy-layer units (registry,
orderings, the DRR deficit and its cap), the cancel lifecycle and the
queue-depth and admission-wait stats.

Parity with the JAX package: on the same fake engines and requests, each
policy gives the same admission, prefill, decode and victim orders and the
same step budgets, step after step."""

import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import SamplingParams as JSamplingParams  # noqa: E402
from repro.serve import make_scheduler_policy as jmake_policy  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    LLM,
    Engine,
    Request,
    SamplingParams,
    ServeConfig,
    make_scheduler_policy,
)

POLICIES = ["fifo", "priority", "drr"]

N_REQ = 4
PROMPTS = [[(7 * i + j) % 50 + 1 for j in range(5 + 3 * i)]
           for i in range(N_REQ)]


def params_for(i):
    """Sampled (not greedy) params with varied scheduling metadata, so the
    bitwise comparison exercises the PRNG position-fold under every
    policy's reordering."""
    return SamplingParams(
        temperature=0.8, seed=100 + i, max_tokens=5,
        tenant="ab"[i % 2], priority=i % 3,
        deadline_steps=8 if i % 2 else None)


@pytest.fixture(scope="module")
def model():
    """The port's model with the JAX package's smoke weights, in f32."""
    cfg = dataclasses.replace(get_smoke("llama3_2_1b"), remat=False,
                              dtype=jnp.float32)
    jmodel = build_model(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jmodel.init(jax.random.PRNGKey(0)))
    m = Model(config_from_reference(jmodel.cfg), device="cpu")
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu"))
    return m


@pytest.fixture(scope="module")
def reference_streams(model):
    """Unloaded reference: each request runs ALONE on a roomy engine —
    its stream depends only on (seed, positions), so this is what every
    policy/chunking/preemption combination must reproduce bitwise."""
    eng = Engine(model, ServeConfig(max_batch=2, page_size=4, hbm_pages=32,
                                    host_pages=32))
    streams = {}
    for i in range(N_REQ):
        eng.add_request(i, PROMPTS[i], params=params_for(i))
        for _ in range(64):
            eng.step()
            if i in eng.finished:
                break
        streams[i] = list(eng.pop_finished(i).generated)
        assert len(streams[i]) == 5
    return streams


def drain(eng, max_steps=300):
    for _ in range(max_steps):
        eng.step()
        if not eng.requests and not eng.wait_queue:
            return
    raise AssertionError(
        f"engine did not drain: live={list(eng.requests)} "
        f"queue={list(eng.wait_queue)}")


# ----------------------------------------------------------- conformance
@pytest.mark.parametrize("chunk", [0, 3], ids=["eager", "interleaved"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_preserves_streams_under_churn(model, reference_streams,
                                              policy, chunk):
    """Concurrent load + forced pause/resume churn + a pool small enough
    to preempt: whatever the policy reorders, every request's sampled
    stream must equal its unloaded solo run bitwise, and the engine must
    finish leak-free."""
    cfg = ServeConfig(max_batch=2, page_size=4, hbm_pages=8, host_pages=8,
                      scheduler=policy, prefill_chunk_tokens=chunk)
    eng = Engine(model, cfg)
    for i in range(N_REQ):
        eng.add_request(i, PROMPTS[i], params=params_for(i))
    for step in range(300):
        # Deterministic churn: periodically park whichever live request
        # has the smallest id, so paused victims exist for preemption.
        live = sorted(r for r in eng.requests
                      if eng.requests[r].state == "active")
        if step % 5 == 1 and live:
            eng.pause(live[0])
        elif step % 5 == 3:
            for rid in list(eng.requests):
                eng.resume(rid)
        eng.step()
        if not eng.requests and not eng.wait_queue:
            break
    assert not eng.requests and not eng.wait_queue
    for i in range(N_REQ):
        got = list(eng.finished[i].generated)
        assert got == reference_streams[i], (
            f"policy={policy} chunk={chunk} req={i}: stream diverged")
    # Leak-free finish: no pages owned, both free lists whole again.
    assert not eng.pool.pages
    assert len(eng.pool.free_hbm) == cfg.hbm_pages - 1   # minus scratch
    assert len(eng.pool.free_host) == cfg.host_pages


@pytest.mark.parametrize("policy", POLICIES)
def test_no_starvation_under_long_prefill_load(model, policy):
    """The interleaving guarantee, under every policy: requests already
    DECODING keep producing tokens while a 40-token prompt drips through
    chunked prefill — the shorts finish before the long prompt's first
    token, and the long request still drains (nobody starves)."""
    eng = Engine(model,
                 ServeConfig(max_batch=2, page_size=4, hbm_pages=32,
                             host_pages=32, max_pages_per_seq=16,
                             scheduler=policy, prefill_chunk_tokens=4))
    for i in (1, 2):
        eng.add_request(i, PROMPTS[i % N_REQ],
                        params=SamplingParams(max_tokens=6,
                                              priority=1, tenant="b"))
    while any(eng.requests[i].state == "prefilling" for i in (1, 2)):
        eng.step()                       # let the shorts reach decode
    long_prompt = [(3 * j) % 40 + 1 for j in range(40)]
    eng.add_request(0, long_prompt, params=SamplingParams(max_tokens=2))
    assert eng.requests[0].state == "prefilling"
    short_done_at = {}
    long_first_token = None
    for step in range(1, 200):
        out = eng.step()
        if 0 in out and long_first_token is None:
            long_first_token = step
        for i in (1, 2):
            if i in eng.finished and i not in short_done_at:
                short_done_at[i] = step
        if not eng.requests and not eng.wait_queue:
            break
    assert not eng.requests and not eng.wait_queue, "starved"
    assert long_first_token is not None
    assert set(short_done_at) == {1, 2}
    for i, at in short_done_at.items():
        assert at < long_first_token, (
            f"policy={policy}: short request {i} finished at step {at}, "
            f"after the 40-token prefill's first token ({long_first_token})"
            f" — interleaving failed to protect decode")


# ------------------------------------------------------------- registry
def test_unknown_policy_raises_naming_the_knob(model):
    with pytest.raises(ValueError, match="ServeConfig.scheduler"):
        Engine(model, ServeConfig(scheduler="lifo"))


def test_fresh_policy_instance_per_engine():
    a, b = make_scheduler_policy("drr"), make_scheduler_policy("drr")
    assert a is not b
    a.deficit["t"] = 99.0
    assert "t" not in b.deficit


# -------------------------------------------------- ordering unit tests
def _req(rid, priority=0, tenant="default", deadline=None, queued=0,
         last_scheduled=0, req=Request, sp=SamplingParams):
    return req(
        request_id=rid, tokens=[1], max_new=1,
        params=sp(priority=priority, tenant=tenant, deadline_steps=deadline),
        queued_step=queued, last_scheduled=last_scheduled)


def _fake_engine(reqs=(), chunk=0, max_batch=4):
    return types.SimpleNamespace(
        cfg=types.SimpleNamespace(prefill_chunk_tokens=chunk,
                                  max_batch=max_batch),
        requests={r.request_id: r for r in reqs})


def test_fifo_admission_is_queue_order():
    pol = make_scheduler_policy("fifo")
    reqs = [_req(3), _req(1), _req(2)]
    assert [r.request_id
            for r in pol.admission_order(reqs, _fake_engine(reqs))] \
        == [3, 1, 2]


def test_priority_orders_by_class_then_deadline():
    pol = make_scheduler_policy("priority")
    lo = _req(0, priority=0)
    hi_late = _req(1, priority=2, deadline=50, queued=0)
    hi_soon = _req(2, priority=2, deadline=5, queued=0)
    mid = _req(3, priority=1)
    order = pol.admission_order([lo, hi_late, hi_soon, mid],
                                _fake_engine([lo, hi_late, hi_soon, mid]))
    assert [r.request_id for r in order] == [2, 1, 3, 0]
    # Preemption inverts: the lowest class pays first.
    assert pol.preempt_paused([lo, hi_soon, mid], None).request_id == 0


def test_drr_served_tenant_yields_to_starved_tenant():
    pol = make_scheduler_policy("drr")
    a, b = _req(0, tenant="a"), _req(1, tenant="b")
    eng = _fake_engine([a, b])
    pol.on_step(eng)                       # both earn one quantum
    pol.on_tokens(a, pol.quantum * 2, eng)      # tenant a over-served
    order = pol.decode_order([a, b], eng)
    assert [r.request_id for r in order] == [1, 0]
    # Preemption charges the over-served (poorest-deficit) tenant.
    assert pol.preempt_paused([a, b], eng).request_id == 0
    # Idle tenants bank nothing across steps.
    eng.requests.pop(0)
    pol.on_step(eng)
    assert "a" not in pol.deficit


def test_drr_deficit_is_capped():
    pol = make_scheduler_policy("drr")
    r = _req(0, tenant="t")
    eng = _fake_engine([r])
    for _ in range(pol.cap_steps * 3):
        pol.on_step(eng)
    assert pol.deficit["t"] == pol.quantum * pol.cap_steps


# ------------------------------------------- parity with the JAX package
def _ids(xs):
    return [r.request_id for r in xs]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_orders_match_jax(policy, seed):
    """Random requests (classes, tenants, deadlines, queue and schedule
    steps) on one fake engine per package: every order, victim and budget
    equal, over steps that charge tokens and retire requests."""
    rng = np.random.default_rng(seed)
    n = 12
    rows = [dict(rid=i, priority=int(rng.integers(0, 3)),
                 tenant="abc"[int(rng.integers(0, 3))],
                 deadline=(None if rng.random() < 0.4
                           else int(rng.integers(1, 40))),
                 queued=int(rng.integers(0, 10)),
                 last_scheduled=int(rng.integers(0, 10)))
            for i in range(n)]
    ours = [_req(**kw) for kw in rows]
    theirs = [_req(**kw, req=JRequest, sp=JSamplingParams) for kw in rows]
    chunk = int(rng.integers(0, 2)) * 8
    pol, jpol = make_scheduler_policy(policy), jmake_policy(policy)
    eng, jeng = _fake_engine(ours, chunk), _fake_engine(theirs, chunk)
    for step in range(6):
        pol.on_step(eng)
        jpol.on_step(jeng)
        live = sorted(eng.requests)
        ours_live = [eng.requests[i] for i in live]
        theirs_live = [jeng.requests[i] for i in live]
        for name in ("admission_order", "prefill_order", "decode_order"):
            assert _ids(getattr(pol, name)(ours_live, eng)) == \
                _ids(getattr(jpol, name)(theirs_live, jeng)), (name, step)
        for name in ("preempt_paused", "preempt_active"):
            assert getattr(pol, name)(ours_live, eng).request_id == \
                getattr(jpol, name)(theirs_live, jeng).request_id, name
        assert dataclasses.asdict(pol.step_budget(eng)) == \
            dataclasses.asdict(jpol.step_budget(jeng))
        # Charge tokens to a few requests and retire one.
        for rid in rng.choice(live, size=min(3, len(live)), replace=False):
            k = int(rng.integers(1, 40))
            pol.on_tokens(eng.requests[int(rid)], k, eng)
            jpol.on_tokens(jeng.requests[int(rid)], k, jeng)
        gone = int(live[int(rng.integers(0, len(live)))])
        eng.requests.pop(gone)
        jeng.requests.pop(gone)
    assert getattr(pol, "deficit", None) == getattr(jpol, "deficit", None)


# ------------------------------------------------------ cancel lifecycle
def test_cancel_lifecycle_and_stats(model):
    llm = LLM(model, ServeConfig(max_batch=2, page_size=4, hbm_pages=32,
                                 host_pages=32))
    # Active request with tokens already streamed: cancel ends the handle
    # with a final (token, "cancelled") delta and keeps the tokens.
    h = llm.submit([1, 2, 3], SamplingParams(max_tokens=50))
    llm.step()
    llm.step()
    llm.cancel(h.request_id)
    deltas = list(h)
    assert h.finish_reason == "cancelled"
    assert deltas[-1][1] == "cancelled"
    assert len(h.token_ids) == 2
    assert h.result().finish_reason == "cancelled"
    # A never-stepped (waiting-or-active, zero tokens) cancel emits the
    # tokenless final delta.
    h2 = llm.submit([4, 5], SamplingParams(max_tokens=50))
    llm.cancel(h2.request_id)
    assert list(h2) == [(None, "cancelled")]
    # Stats + lifecycle errors.  The LLM absorbed the finished result, so
    # a second cancel sees an id the cluster no longer tracks.
    s = llm.stats()
    assert s["finished_cancelled"] == 2
    with pytest.raises(ValueError, match="unknown id"):
        llm.cancel(h.request_id)
    with pytest.raises(ValueError, match="unknown id"):
        llm.cancel(999)
    # Cancel of a PAUSED page-holder frees its pages immediately.
    h3 = llm.submit([1, 2, 3, 4, 5], SamplingParams(max_tokens=50))
    llm.step()
    llm.pause(h3.request_id)
    assert llm.engine.pool.request_pages(h3.request_id)
    llm.cancel(h3.request_id)
    assert not llm.engine.pool.request_pages(h3.request_id)
    assert not llm.engine.pool.pages
    assert h3.result().finish_reason == "cancelled"


def test_queue_depth_and_admission_wait_stats(model):
    """queue_depth counts LIVE waiting requests; admission wait accrues in
    steps between enqueue and admission."""
    eng = Engine(model, ServeConfig(max_batch=1, page_size=2, hbm_pages=5,
                                    host_pages=0, max_pages_per_seq=4))
    eng.add_request(0, [1, 2, 3, 4, 5], max_new=4)    # holds the pool
    eng.add_request(1, [1, 2, 3, 4, 5], max_new=4)    # must wait
    assert eng.requests[1].state == "waiting"
    assert eng.stats()["queue_depth"] == 1
    assert eng.queue_delay_estimate() == pytest.approx(4 / 2 + 1 / 1)
    drain(eng)
    s = eng.stats()
    assert s["queue_depth"] == 0
    assert s["admissions"] >= 2
    assert s["admission_wait_steps"] > 0       # request 1 waited
    assert s["mean_admission_wait_steps"] == pytest.approx(
        s["admission_wait_steps"] / s["admissions"])
    # Engine-level cancel of an undrained finished result names the state.
    with pytest.raises(ValueError, match="already finished"):
        eng.cancel(0)
