"""The port's ``serve/workload.py``: deterministic trace synthesis, the
versioned JSON trace format, the modeled step-cost clock and trace replay
(the reference suite ``tests/test_workload.py`` on the port), plus parity
with the JAX package: ``synthesize`` gives equal traces, each package's
trace JSON loads in the other, and a replay's sampled streams equal the
JAX replay's on the same weights (``llama3_2_1b`` SMOKE, f32).

Replaying one trace eagerly and with interleaved prefill under another
policy gives the same streams bitwise, on one replica and on two, and
the modeled clock does not depend on the model's widths."""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serve import LLM as JLLM  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import workload as jwl  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_reference,
    params_from_numpy,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    LLM,
    SLO,
    SamplingParams,
    ServeConfig,
    StepCostModel,
    TenantSpec,
    Trace,
    TraceReplayer,
    WorkloadConfig,
    synthesize,
)

TENANTS = (
    TenantSpec(name="chat", arrival="poisson", rate=0.4,
               prompt_mix=((4, 2.0), (6, 1.0)),
               output_mix=((4, 1.0),), temperature=0.7),
    TenantSpec(name="batch", arrival="bursty", rate=0.3, burst_factor=4.0,
               burst_period=8, burst_duty=0.25, priority=1,
               prompt_mix=((10, 1.0),), output_mix=((3, 1.0),),
               deadline_steps=16),
)
CFG = WorkloadConfig(tenants=TENANTS, horizon_steps=16, vocab=64, seed=7)


def jax_config(cfg):
    """The same WorkloadConfig in the JAX package's classes."""
    return jwl.WorkloadConfig(
        tenants=tuple(jwl.TenantSpec(**dataclasses.asdict(t))
                      for t in cfg.tenants),
        horizon_steps=cfg.horizon_steps, vocab=cfg.vocab, seed=cfg.seed)


# ------------------------------------------------------------- synthesis
def test_synthesize_is_a_pure_function_of_the_config():
    a, b = synthesize(CFG), synthesize(CFG)
    assert a.requests == b.requests
    assert len(a) > 0
    reseeded = synthesize(dataclasses.replace(CFG, seed=8))
    assert reseeded.requests != a.requests


def test_synthesized_requests_carry_tenant_metadata():
    trace = synthesize(CFG)
    by_tenant = {t.name: [r for r in trace.requests if r.tenant == t.name]
                 for t in TENANTS}
    assert all(by_tenant.values()), "both tenants must produce arrivals"
    for r in by_tenant["batch"]:
        assert r.priority == 1 and r.deadline_steps == 16
        assert len(r.prompt) == 10 and r.max_tokens == 3
    for r in trace.requests:
        assert r.seed == r.request_id % (2 ** 31)
        assert all(0 <= t < CFG.vocab for t in r.prompt)
    # Ordered by (arrival step, request id).
    keyed = [(r.arrival_step, r.request_id) for r in trace.requests]
    assert keyed == sorted(keyed)
    sp = trace.requests[0].sampling_params()
    assert isinstance(sp, SamplingParams)
    assert sp.seed == trace.requests[0].seed


def test_bursty_arrivals_land_only_in_the_on_phase():
    trace = synthesize(CFG)
    spec = TENANTS[1]
    on_window = spec.burst_period * spec.burst_duty
    for r in trace.requests:
        if r.tenant == "batch":
            assert (r.arrival_step % spec.burst_period) < on_window


def test_tenant_spec_validation():
    with pytest.raises(ValueError, match="arrival"):
        TenantSpec(name="x", arrival="uniform")
    with pytest.raises(ValueError, match="burst_duty"):
        TenantSpec(name="x", burst_duty=0.0)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_synthesize_matches_jax(seed):
    """One numpy generator drives both packages: equal traces, field by
    field, at several seeds (the chip's two-tenant shape among them)."""
    cfg = dataclasses.replace(CFG, seed=seed)
    got, want = synthesize(cfg), jwl.synthesize(jax_config(cfg))
    assert len(got) == len(want) > 0
    for a, b in zip(got.requests, want.requests):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ----------------------------------------------------------- JSON format
def test_trace_json_roundtrip_and_version_gate():
    trace = synthesize(CFG)
    assert Trace.from_json(trace.to_json()) == trace
    with pytest.raises(ValueError, match="version"):
        Trace.from_json('{"version": 0, "requests": []}')


def test_trace_json_loads_across_packages():
    ours = synthesize(CFG)
    theirs = jwl.synthesize(jax_config(CFG))
    assert ours.to_json() == theirs.to_json()
    assert Trace.from_json(theirs.to_json()) == ours
    assert jwl.Trace.from_json(ours.to_json()) == theirs


# ------------------------------------------------------------ cost model
def test_step_cost_model_is_linear():
    cost = StepCostModel(base_ms=1.0, prefill_ms_per_token=0.2,
                         decode_ms_per_token=0.5)
    assert cost.step_ms(0, 0) == pytest.approx(1.0)
    assert cost.step_ms(10, 4) == pytest.approx(1.0 + 2.0 + 2.0)


# ---------------------------------------------------------------- replay
@functools.lru_cache(maxsize=None)
def models():
    """(JAX model, its f32 params, the port's model with those weights)."""
    cfg = dataclasses.replace(get_smoke("llama3_2_1b"), remat=False,
                              dtype=jnp.float32)
    model = build_model(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          model.init(jax.random.PRNGKey(0)))
    m = Model(config_from_reference(model.cfg), device="cpu")
    m.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu"))
    return model, params, m


SERVE = dict(max_batch=4, page_size=4, hbm_pages=64, host_pages=64)


def _replay(trace, replicas=1, **serve_kw):
    llm = LLM(models()[2], ServeConfig(**SERVE, **serve_kw),
              replicas=replicas)
    return TraceReplayer(llm, trace, slo=SLO(ttft_ms=1e9, tpot_ms=1e9)).run(
        max_steps=512)


@pytest.fixture(scope="module")
def eager():
    return _replay(synthesize(CFG))


def test_replay_metrics_complete_and_interleaving_is_bitwise(eager):
    trace = synthesize(CFG)
    inter = _replay(trace, prefill_chunk_tokens=4, scheduler="drr")
    # Interleaving + a different policy reorders service, never streams.
    assert eager.token_ids == inter.token_ids
    for rep in (eager, inter):
        assert set(rep.metrics) == {r.request_id for r in trace.requests}
        for m in rep.metrics.values():
            assert m.finish_step is not None
            assert m.finish_reason == "length"
            assert m.ttft_ms is not None and m.ttft_ms > 0
            assert m.ttft_steps is not None and m.ttft_steps >= 1
            if m.n_tokens > 1:
                assert m.max_tpot_ms >= m.mean_tpot_ms > 0
        assert rep.modeled_ms > 0 and rep.steps_run > 0
    # Summary reducers: per-tenant rows partition the overall row, and the
    # sky-high SLO counts every finished request as good.
    s_all = eager.summary(slo=SLO(ttft_ms=1e9, tpot_ms=1e9))
    s_chat = eager.summary(tenant="chat")
    s_batch = eager.summary(tenant="batch")
    assert s_chat["requests"] + s_batch["requests"] == s_all["requests"]
    assert s_all["finished"] == s_all["requests"]
    assert s_all["goodput_slo"] == pytest.approx(1.0)
    for key in ("p50_ttft_ms", "p99_ttft_ms", "p50_tpot_ms", "p99_tpot_ms"):
        assert not math.isnan(s_all[key])
        assert s_all[key] > 0


@pytest.mark.parametrize("chunk,scheduler", [(0, "priority"), (4, "drr")])
def test_replay_on_two_replicas_keeps_every_stream(eager, chunk, scheduler):
    """The chip's phase 9d at smoke widths: two replicas, eager under
    priority and interleaved under DRR, give the one-replica streams."""
    got = _replay(synthesize(CFG), replicas=2, scheduler=scheduler,
                  prefill_chunk_tokens=chunk)
    assert got.token_ids == eager.token_ids
    assert got.summary()["finished"] == len(synthesize(CFG))


def test_replay_streams_and_clock_match_jax(eager):
    """The same trace replayed by the JAX package on the same weights:
    equal sampled streams, steps and modeled clock."""
    model, params, _ = models()
    jllm = JLLM(model, params, JServeConfig(**SERVE))
    want = jwl.TraceReplayer(jllm, jwl.synthesize(jax_config(CFG)),
                             slo=jwl.SLO(ttft_ms=1e9, tpot_ms=1e9)).run(
        max_steps=512)
    assert jllm.engine.pool.swaps_in == 0
    assert eager.token_ids == want.token_ids
    assert eager.steps_run == want.steps_run
    assert eager.modeled_ms == want.modeled_ms
    assert eager.summary() == want.summary()


def test_modeled_clock_reads_only_the_schedule(eager):
    """The modeled clock charges tokens per step, and the schedule never
    reads a weight: another model of other widths replays the trace to the
    same steps, modeled milliseconds and summaries (so a chip run's
    modeled numbers can be checked on the CPU)."""
    cfg = dataclasses.replace(tconfigs.get_smoke("llama3_2_1b"),
                              n_layers=1, d_model=32, n_heads=2, kv_heads=1,
                              d_ff=64)
    other = Model(cfg, device="cpu").init(torch.Generator().manual_seed(9))
    got = TraceReplayer(LLM(other, ServeConfig(**SERVE)), synthesize(CFG),
                        slo=SLO(ttft_ms=1e9, tpot_ms=1e9)).run(max_steps=512)
    assert got.token_ids != eager.token_ids
    assert got.steps_run == eager.steps_run
    assert got.modeled_ms == eager.modeled_ms
    assert got.summary(slo=SLO()) == eager.summary(slo=SLO())
