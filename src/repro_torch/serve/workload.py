"""Deterministic traffic synthesis and trace replay for the serving stack —
the port of ``repro/serve/workload.py`` (numpy only; the same
``WorkloadConfig`` gives the same ``Trace`` in both packages, and each
package's trace JSON loads in the other).

The paper's claim — online guidance converges to offline-profile quality
"after a short startup period" — is only falsifiable under live, bursty,
multi-tenant load.  This module generates that load and replays it against
an ``LLM`` with NO wall-clock anywhere and every random draw from one
seeded generator: the same ``WorkloadConfig`` seed
always yields the same ``Trace``, and replaying a trace against the same
engine config always schedules, samples, and scores identically.

Three layers:

* ``synthesize(WorkloadConfig) -> Trace`` — per-tenant arrival processes
  (Poisson, or bursty on/off-modulated Poisson) on the engine's step-tick
  clock, with categorical prompt/output length mixtures.  A ``Trace`` is
  plain data (JSON-serializable, versioned) — captured production traffic
  can be replayed through the same door.
* ``TraceReplayer`` — drives an ``LLM`` step by step, submitting each
  trace request at its arrival step and recording when its first token and
  finish land.  Time is measured two ways at once: in engine steps
  (exact), and in *modeled milliseconds* via ``StepCostModel`` — a
  deterministic linear cost per step (base + prefill tokens + decode
  tokens, like core's ``modeled_swap_seconds``) that makes a 256-token
  one-shot prefill stall VISIBLE as a p99 inter-token spike without
  letting host timing noise into CI.
* ``ReplayReport`` — per-request TTFT/TPOT in both time domains plus
  goodput-under-SLO (fraction of requests finishing with TTFT and TPOT
  inside the ``SLO`` bounds), per tenant or overall.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .sampling import SamplingParams

TRACE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic shape.

    arrival: ``poisson`` (rate per step) or ``bursty`` — the Poisson rate
      is modulated by an on/off square wave: ``rate * burst_factor``
      during the on phase (``burst_duty`` of each ``burst_period`` steps),
      0 in the off phase.
    prompt_mix / output_mix: categorical ``((length, weight), ...)``
      mixtures; lengths in tokens.
    priority / deadline_steps / temperature: stamped onto each request's
      ``SamplingParams``.
    """

    name: str
    arrival: str = "poisson"          # poisson | bursty
    rate: float = 0.2                 # mean arrivals per engine step
    burst_factor: float = 8.0
    burst_period: int = 32
    burst_duty: float = 0.25
    priority: int = 0
    prompt_mix: Tuple[Tuple[int, float], ...] = ((8, 1.0),)
    output_mix: Tuple[Tuple[int, float], ...] = ((8, 1.0),)
    deadline_steps: Optional[int] = None
    temperature: float = 0.0

    def __post_init__(self):
        if self.arrival not in ("poisson", "bursty"):
            raise ValueError(
                f"TenantSpec.arrival must be 'poisson' or 'bursty', got "
                f"{self.arrival!r}")
        if not (0.0 < self.burst_duty <= 1.0):
            raise ValueError(
                f"burst_duty must be in (0, 1], got {self.burst_duty}")


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    tenants: Tuple[TenantSpec, ...]
    horizon_steps: int = 128          # arrival window, in engine steps
    vocab: int = 256                  # prompt tokens drawn from [0, vocab)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival: everything ``LLM.submit`` needs, plus the step it
    lands.  ``seed`` is explicit (== request id) so the sampled stream is
    pinned by the trace itself, not by replay-side id assignment."""

    request_id: int
    arrival_step: int
    tenant: str
    priority: int
    prompt: Tuple[int, ...]
    max_tokens: int
    seed: int
    temperature: float = 0.0
    deadline_steps: Optional[int] = None

    def sampling_params(self) -> SamplingParams:
        return SamplingParams(
            temperature=self.temperature, seed=self.seed,
            max_tokens=self.max_tokens, priority=self.priority,
            tenant=self.tenant, deadline_steps=self.deadline_steps)


@dataclasses.dataclass
class Trace:
    """An ordered arrival sequence (by step, then request id)."""

    requests: List[TraceRequest]
    version: int = TRACE_VERSION

    def __len__(self) -> int:
        return len(self.requests)

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "requests": [dataclasses.asdict(r) for r in self.requests],
        }, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        obj = json.loads(text)
        if obj.get("version") != TRACE_VERSION:
            raise ValueError(
                f"trace version {obj.get('version')!r} != "
                f"{TRACE_VERSION} (regenerate the trace)")
        reqs = []
        for row in obj["requests"]:
            row = dict(row)
            row["prompt"] = tuple(row["prompt"])
            reqs.append(TraceRequest(**row))
        return cls(requests=reqs)


def _draw_mix(rng: np.random.Generator,
              mix: Sequence[Tuple[int, float]]) -> int:
    values = [int(v) for v, _ in mix]
    weights = np.asarray([w for _, w in mix], dtype=np.float64)
    return values[int(rng.choice(len(values), p=weights / weights.sum()))]


def synthesize(cfg: WorkloadConfig) -> Trace:
    """Deterministically expand a workload spec into a concrete trace.

    One seeded generator drives everything; tenants are visited in spec
    order at each step, so the draw sequence (hence the trace) is a pure
    function of ``cfg``."""
    rng = np.random.default_rng(cfg.seed)
    requests: List[TraceRequest] = []
    rid = 0
    for step in range(cfg.horizon_steps):
        for spec in cfg.tenants:
            rate = spec.rate
            if spec.arrival == "bursty":
                on = (step % spec.burst_period) < (spec.burst_period
                                                   * spec.burst_duty)
                rate = spec.rate * spec.burst_factor if on else 0.0
            n = int(rng.poisson(rate)) if rate > 0 else 0
            for _ in range(n):
                n_prompt = max(_draw_mix(rng, spec.prompt_mix), 1)
                n_out = max(_draw_mix(rng, spec.output_mix), 1)
                prompt = tuple(
                    int(t) for t in rng.integers(0, cfg.vocab, n_prompt))
                requests.append(TraceRequest(
                    request_id=rid, arrival_step=step, tenant=spec.name,
                    priority=spec.priority, prompt=prompt,
                    max_tokens=n_out, seed=rid % (2 ** 31),
                    temperature=spec.temperature,
                    deadline_steps=spec.deadline_steps))
                rid += 1
    return Trace(requests=requests)


@dataclasses.dataclass(frozen=True)
class StepCostModel:
    """Deterministic modeled wall time for one engine step: the fixed
    dispatch overhead plus linear costs for the prompt tokens ingested and
    the decode tokens produced that step.  Coefficients are deliberately
    round numbers — the model exists to expose SCHEDULING effects (a
    one-shot 256-token prefill makes one step 50x longer; interleaving
    amortizes it) deterministically, not to predict a specific device."""

    base_ms: float = 1.0
    prefill_ms_per_token: float = 0.2
    decode_ms_per_token: float = 0.5

    def step_ms(self, prefill_tokens: int, decode_tokens: int) -> float:
        return (self.base_ms
                + self.prefill_ms_per_token * prefill_tokens
                + self.decode_ms_per_token * decode_tokens)


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request service objective in MODELED milliseconds: time to
    first token, and the worst single inter-token gap."""

    ttft_ms: float = 200.0
    tpot_ms: float = 50.0


@dataclasses.dataclass
class RequestMetrics:
    request_id: int
    tenant: str
    arrival_step: int
    arrival_ms: float = 0.0           # modeled clock at submit
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None
    finish_reason: Optional[str] = None
    n_tokens: int = 0
    # Modeled ms from ARRIVAL to first token (queueing included).
    ttft_ms: Optional[float] = None
    # Worst single inter-token gap (p100 TPOT) — the stall metric a
    # monopolizing prefill inflates.
    max_tpot_ms: Optional[float] = None
    mean_tpot_ms: Optional[float] = None

    @property
    def ttft_steps(self) -> Optional[int]:
        if self.first_token_step is None:
            return None
        return self.first_token_step - self.arrival_step


def _pct(values: Sequence[float], q: float) -> float:
    if not values:
        return float("nan")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


@dataclasses.dataclass
class ReplayReport:
    """Everything a replay produced, plus summary reducers."""

    metrics: Dict[int, RequestMetrics]
    steps_run: int
    modeled_ms: float
    token_ids: Dict[int, List[int]]   # per-request sampled streams

    def _rows(self, tenant: Optional[str]) -> List[RequestMetrics]:
        return [m for m in self.metrics.values()
                if tenant is None or m.tenant == tenant]

    def summary(self, tenant: Optional[str] = None,
                slo: Optional[SLO] = None) -> Dict[str, float]:
        rows = self._rows(tenant)
        done = [m for m in rows if m.finish_step is not None]
        ttft = [m.ttft_ms for m in rows if m.ttft_ms is not None]
        tpot = [m.max_tpot_ms for m in rows if m.max_tpot_ms is not None]
        out = {
            "requests": float(len(rows)),
            "finished": float(len(done)),
            "p50_ttft_ms": _pct(ttft, 50),
            "p99_ttft_ms": _pct(ttft, 99),
            "p50_tpot_ms": _pct(tpot, 50),
            "p99_tpot_ms": _pct(tpot, 99),
        }
        if slo is not None:
            good = [m for m in done
                    if m.ttft_ms is not None and m.ttft_ms <= slo.ttft_ms
                    and (m.max_tpot_ms is None
                         or m.max_tpot_ms <= slo.tpot_ms)]
            out["goodput_slo"] = (len(good) / len(rows)) if rows else 0.0
        return out


class TraceReplayer:
    """Drive an ``LLM`` through a trace on the engine's step clock.

    Each loop iteration submits the requests arriving at the current step,
    advances the engine one step, charges the ``StepCostModel`` with the
    prompt tokens ingested and decode tokens produced by that step (both
    read off engine counters — eager admission prefill included), and
    timestamps first-token/finish events in both time domains."""

    def __init__(self, llm, trace: Trace,
                 cost: Optional[StepCostModel] = None,
                 slo: Optional[SLO] = None):
        self.llm = llm
        self.trace = trace
        self.cost = cost if cost is not None else StepCostModel()
        self.slo = slo if slo is not None else SLO()

    def run(self, max_steps: int = 4096) -> ReplayReport:
        llm = self.llm
        by_step: Dict[int, List[TraceRequest]] = {}
        for tr in self.trace.requests:
            by_step.setdefault(tr.arrival_step, []).append(tr)
        horizon = max(by_step) if by_step else 0
        metrics: Dict[int, RequestMetrics] = {}
        handles: Dict[int, object] = {}
        token_ms: Dict[int, List[float]] = {}
        clock_ms = 0.0
        step = 0
        live = True
        while step <= horizon or (live and step < max_steps):
            # Eager admission prefill happens INSIDE submit, so the ingest
            # counter snapshots BEFORE the submits: the whole iteration's
            # ingest (admission + interleaved chunks) charges this step.
            before = llm.stats()["prefill_tokens"]
            for tr in by_step.get(step, ()):
                metrics[tr.request_id] = RequestMetrics(
                    request_id=tr.request_id, tenant=tr.tenant,
                    arrival_step=step, arrival_ms=clock_ms)
                handles[tr.request_id] = llm.submit(
                    list(tr.prompt), tr.sampling_params(),
                    request_id=tr.request_id)
            out = llm.step()
            after = llm.stats()["prefill_tokens"]
            clock_ms += self.cost.step_ms(int(after - before), len(out))
            step += 1
            for rid in out:
                m = metrics.get(rid)
                if m is None:
                    continue
                token_ms.setdefault(rid, []).append(clock_ms)
                if m.first_token_step is None:
                    m.first_token_step = step
                    m.ttft_ms = clock_ms - m.arrival_ms
            for h in handles.values():
                m = metrics[h.request_id]
                if m.finish_step is None and h.finished:
                    m.finish_step = step
                    m.finish_reason = h.finish_reason
                    m.n_tokens = len(h.token_ids)
            live = any(not h.finished for h in handles.values())
        for rid, stamps in token_ms.items():
            m = metrics[rid]
            if len(stamps) > 1:
                gaps = [b - a for a, b in zip(stamps, stamps[1:])]
                m.max_tpot_ms = max(gaps)
                m.mean_tpot_ms = sum(gaps) / len(gaps)
        # Arrival-side prefill accounting means submits before the FIRST
        # step are charged to that step; the counters make the charge
        # explicit rather than silently dropping it.
        return ReplayReport(
            metrics=metrics, steps_run=step, modeled_ms=clock_ms,
            token_ids={rid: list(h.token_ids)
                       for rid, h in handles.items()})
