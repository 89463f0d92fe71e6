"""SLO-aware scheduling policies for the serving engine.

PR 4's continuous-batching scheduler was three hard-wired decisions inside
``Engine``: FIFO admission from the wait queue, preempt the
least-recently-scheduled paused holder, pack decode batches oldest-first.
Production traffic is bursty, multi-tenant, and SLO-bound — which policy
wins depends on the workload, so the decisions live here behind one
interface and the engine consumes whichever ``ServeConfig.scheduler``
names.

A ``SchedulerPolicy`` owns four decisions:

* **admission order** — which waiting request the engine tries to admit
  next (the head of the returned order; admission never skips past a
  request that does not fit, so every policy keeps the no-starvation
  property of bounded head-of-line blocking rather than reordering around
  a stuck request forever).
* **decode order** — how active requests pack into the per-step decode
  batch under the HBM/logical dual budget.
* **preemption victims** — which paused (``preempt_paused``) or running
  (``preempt_active``) page-holder loses its pages when capacity runs out.
  Preemption is always BY RECOMPUTE (lossless: one-shot prefill == decode
  bitwise and sampling folds absolute stream positions), so policies are
  free to preempt aggressively — the stream never changes, only when its
  tokens arrive.
* **per-step budget split** — ``step_budget`` returns how many prompt
  tokens may prefill this step alongside the decode batch
  (chunked-prefill interleaving: a long prefill is split into
  budget-sized chunks co-scheduled with decode steps so a 32k-token
  prompt cannot starve in-flight decodes).  ``prefill_tokens == 0`` means
  eager whole-suffix prefill at admission — bitwise the pre-policy
  engine.

Determinism: policies see only engine state (step counters, request
metadata) and must be pure functions of it — no wall clock (rule FT01),
no unseeded PRNG (rule SCHED01).  Every ordering below carries a total
deterministic tie-break (ultimately ``request_id``), so a replayed trace
schedules identically.

Scheduling metadata rides on ``SamplingParams`` (``priority``,
``tenant``, ``deadline_steps``) and therefore inside ``RequestTicket`` —
a migrated request keeps its class and deadline across replicas.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

# Engine/Request are only type hints here; importing them would cycle
# (engine.py imports this module), so signatures use duck typing.


@dataclasses.dataclass(frozen=True)
class StepBudget:
    """How one engine step splits its work.

    prefill_tokens: prompt tokens that may ingest this step across all
      requests in ``prefilling`` state (chunked-prefill interleaving).
      ``0`` disables interleaving: admission ingests the whole suffix in
      one eager dispatch (the pre-policy engine, bitwise).
    decode_requests: rows the decode batch may pack (<= ``max_batch``).
    """

    prefill_tokens: int
    decode_requests: int


class SchedulerPolicy:
    """Base class: subclasses set ``name`` and implement the orderings.

    All ordering methods receive non-empty lists of live ``Request``
    objects and the engine, and must return a NEW list/choice without
    mutating engine state (bookkeeping belongs in ``on_step`` /
    ``on_tokens``)."""

    name = "base"

    # ------------------------------------------------------------ orders
    def admission_order(self, waiting: Sequence, engine) -> List:
        """Waiting requests, most-admittable first.  The engine only ever
        admits the HEAD of this order (no skip-ahead past a request that
        does not fit)."""
        raise NotImplementedError

    def prefill_order(self, prefilling: Sequence, engine) -> List:
        """Requests in ``prefilling`` state, in the order the per-step
        prefill token budget is offered to them.  Defaults to the
        admission order — the request a policy wanted in first also
        ingests first."""
        return self.admission_order(prefilling, engine)

    def decode_order(self, active: Sequence, engine) -> List:
        """Active requests, in batch-packing preference order."""
        raise NotImplementedError

    # ------------------------------------------------------- preemption
    def preempt_paused(self, candidates: Sequence, engine):
        """Pick the paused page-holder that loses its pages (preempt by
        recompute)."""
        raise NotImplementedError

    def preempt_active(self, candidates: Sequence, engine):
        """Pick the running/prefilling page-holder that is pushed back to
        the wait queue when logical pages are exhausted."""
        raise NotImplementedError

    # ----------------------------------------------------------- budget
    def step_budget(self, engine) -> StepBudget:
        return StepBudget(
            prefill_tokens=max(int(engine.cfg.prefill_chunk_tokens), 0),
            decode_requests=engine.cfg.max_batch)

    # ------------------------------------------------------ bookkeeping
    def on_step(self, engine) -> None:
        """Called once at the top of every engine step."""

    def on_tokens(self, req, n: int, engine) -> None:
        """Called when ``req`` consumed ``n`` tokens of service (prefill
        chunk tokens and decode tokens both count)."""


class FifoPolicy(SchedulerPolicy):
    """The pre-policy engine, bit for bit.

    Admission follows wait-queue order (head-of-line blocking included),
    decode packs oldest-``last_scheduled`` first, paused preemption takes
    the least-recently-scheduled holder, and active reclaim takes the
    youngest — exactly the decisions PR 4 hard-wired, so an engine
    running ``scheduler="fifo"`` with ``prefill_chunk_tokens=0``
    schedules identically to every pre-policy trace."""

    name = "fifo"

    def admission_order(self, waiting, engine):
        return list(waiting)                    # wait-queue order

    def decode_order(self, active, engine):
        return sorted(active, key=lambda r: (r.last_scheduled,
                                             r.request_id))

    def preempt_paused(self, candidates, engine):
        return min(candidates, key=lambda r: (r.last_scheduled,
                                              r.request_id))

    def preempt_active(self, candidates, engine):
        return sorted(candidates, key=lambda r: (r.last_scheduled,
                                                 r.request_id))[-1]


class PriorityPolicy(SchedulerPolicy):
    """Strict priority classes with earliest-deadline-first inside a class.

    ``SamplingParams.priority`` (higher = sooner) picks the class;
    within a class, requests with an SLO deadline
    (``queued_step + deadline_steps``, in engine steps) order
    earliest-absolute-deadline first and deadline-free requests fall back
    to FIFO.  Preemption inverts the order: the lowest class pays first,
    and within it the FIFO rule applies (oldest paused / youngest
    active), so a high-priority arrival preempts exactly the work the
    admission order values least."""

    name = "priority"

    @staticmethod
    def _deadline(r) -> float:
        d = getattr(r.params, "deadline_steps", None)
        return float(r.queued_step + d) if d is not None else float("inf")

    def admission_order(self, waiting, engine):
        return sorted(waiting, key=lambda r: (
            -r.params.priority, self._deadline(r), r.queued_step,
            r.request_id))

    def decode_order(self, active, engine):
        return sorted(active, key=lambda r: (
            -r.params.priority, self._deadline(r), r.last_scheduled,
            r.request_id))

    def preempt_paused(self, candidates, engine):
        return sorted(candidates, key=lambda r: (
            r.params.priority, -self._deadline(r), -r.last_scheduled,
            -r.request_id))[0]

    def preempt_active(self, candidates, engine):
        return sorted(candidates, key=lambda r: (
            -r.params.priority, self._deadline(r), r.last_scheduled,
            r.request_id))[-1]


class DrrPolicy(SchedulerPolicy):
    """Deficit round robin across tenants (``SamplingParams.tenant``).

    Every step, each tenant with live work earns ``quantum`` tokens of
    deficit (capped at ``cap_steps`` steps' worth so an idle-then-bursty
    tenant cannot bank unbounded credit); serving a tenant — prefill
    chunk tokens and decode tokens alike — spends it.  All orderings run
    richest-deficit-first, so a tenant that received less than its share
    catches up regardless of how many requests a noisy neighbour
    submitted; within a tenant the FIFO rules apply.  Preemption charges
    the POOREST tenant (the one most over its share)."""

    name = "drr"

    def __init__(self, quantum: int = 32, cap_steps: int = 8):
        self.quantum = quantum
        self.cap_steps = cap_steps
        self.deficit: Dict[str, float] = {}

    @staticmethod
    def _tenant(r) -> str:
        return getattr(r.params, "tenant", "default")

    def on_step(self, engine) -> None:
        live = {self._tenant(r) for r in engine.requests.values()}
        cap = float(self.quantum * self.cap_steps)
        for t in sorted(live):
            self.deficit[t] = min(self.deficit.get(t, 0.0) + self.quantum,
                                  cap)
        for t in [t for t in self.deficit if t not in live]:
            del self.deficit[t]          # idle tenants bank nothing

    def on_tokens(self, req, n: int, engine) -> None:
        t = self._tenant(req)
        self.deficit[t] = self.deficit.get(t, 0.0) - n

    def _key(self, r):
        return (-self.deficit.get(self._tenant(r), 0.0), self._tenant(r),
                r.last_scheduled, r.request_id)

    def admission_order(self, waiting, engine):
        return sorted(waiting, key=lambda r: (
            -self.deficit.get(self._tenant(r), 0.0), self._tenant(r),
            r.queued_step, r.request_id))

    def decode_order(self, active, engine):
        return sorted(active, key=self._key)

    def preempt_paused(self, candidates, engine):
        # Poorest tenant pays; within it, the FIFO oldest-paused rule.
        return sorted(candidates, key=lambda r: (
            self.deficit.get(self._tenant(r), 0.0), self._tenant(r),
            r.last_scheduled, r.request_id))[0]

    def preempt_active(self, candidates, engine):
        return sorted(candidates, key=self._key)[-1]


SCHEDULER_POLICIES: Dict[str, Callable[[], SchedulerPolicy]] = {}


def register_scheduler_policy(name: str):
    """Register a policy factory under ``ServeConfig.scheduler`` name."""
    def deco(factory: Callable[[], SchedulerPolicy]):
        SCHEDULER_POLICIES[name] = factory
        return factory
    return deco


register_scheduler_policy("fifo")(FifoPolicy)
register_scheduler_policy("priority")(PriorityPolicy)
register_scheduler_policy("drr")(DrrPolicy)


def make_scheduler_policy(name: str) -> SchedulerPolicy:
    """A FRESH policy instance per engine (DRR carries per-tenant state —
    sharing one instance across engines would bleed deficits between
    replicas)."""
    try:
        factory = SCHEDULER_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler policy {name!r} "
            f"(ServeConfig.scheduler): registered policies are "
            f"{sorted(SCHEDULER_POLICIES)}") from None
    return factory()
