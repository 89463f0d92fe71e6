"""Elastic multi-replica serving: replica lifecycle + routing front door —
the port of ``repro/serve/cluster.py`` (framework-free; the engines it
routes between are the port's).

One ``Engine`` is a replaceable unit here, not the serving stack.  The
``Router`` owns N ``EngineReplica`` wrappers and presents the same control
surface an ``Engine`` does (``add_request`` / ``step`` / ``pause`` /
``resume`` / ``pop_finished`` / ``requests`` / ``finished`` / ``stats``),
so ``serve.api.LLM`` routes instead of owning a single engine and every
existing driver keeps working at N=1.

* **Dispatch** is least-loaded and policy-aware: a new request goes to
  the alive replica with the smallest ``Engine.queue_delay_estimate()``
  (un-ingested prompt-token backlog over per-step prefill capacity, plus
  decode occupancy — so a replica stuffed with queued 32k prompts repels
  new work even while its pages-in-use still look modest), then fewest
  allocated pages, ties broken by replica id — deterministic, so a
  replayed workload routes identically.
  Replicas step one after another in the calling thread; on one card they
  share the device and its stream.

* **Lifecycle** runs through the seed's ``ft.HeartbeatMonitor`` with an
  injected step-tick clock (``router.step`` is the heartbeat cadence):
  wall-clock never enters the control path, so failover timelines replay
  deterministically in tests.  A replica
  that stops beating (``fail`` — a simulated crash, or any driver that
  stops stepping it) is detected after ``heartbeat_timeout`` ticks and its
  requests are recovered.

* **Recovery** migrates in-flight work instead of dropping it, on two
  paths with one decision rule — *warm when the dead engine's memory is
  still reachable, cold otherwise*:

  - **cold** (crash): the router's ``RequestTicket`` ledger — prompt,
    params, generated-so-far, maintained from step outputs, never read
    from the failed engine — is replayed on a survivor via
    ``Engine.import_request(ticket)``.  Preemption-by-recompute makes this
    bitwise: seeds are explicit or derived from the (preserved) request
    id, and the sampler folds absolute stream positions.
  - **warm** (``drain`` — graceful restart/scale-down): KV pages hand off
    via ``PagedKVPool.export_pages`` → ``import_pages`` (batched staging
    through CPU tensors, bitwise), prefix-cache blocks re-attach on the destination by chain
    hash, and decoding resumes with zero recompute.  A warm import that
    does not fit falls back to cold transparently.

* **Loss is loud, not silent**: when no survivor exists, the affected
  request ids land in ``lost_requests`` and their streaming handles raise
  ``ReplicaLostError`` instead of hanging or leaking a raw ``KeyError``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..ft import HeartbeatMonitor
from .engine import Engine, Request, RequestTicket


class ReplicaLostError(RuntimeError):
    """A request's owning replica left the cluster with no survivor able to
    rebuild it (or it was removed with ``migrate=False``).  Streaming
    handles raise this instead of spinning; resubmitting through the
    router is the caller's retry path."""


class EngineReplica:
    """One engine plus its cluster-membership state.

    ``alive`` replicas take new work and step; ``draining`` replicas step
    (finishing the handoff) but receive nothing new; ``failed`` replicas
    are unreachable — the router neither steps nor reads them (a crashed
    process's memory is gone; recovery uses the router's tickets) until
    detection moves them to ``dead``."""

    def __init__(self, replica_id: int, engine: Engine):
        self.replica_id = replica_id
        self.engine = engine
        self.state = "alive"     # alive | draining | failed | dead

    @property
    def reachable(self) -> bool:
        return self.state in ("alive", "draining")

    def load(self) -> Tuple[float, int]:
        """(queue-delay estimate, pages in use) — the least-loaded
        dispatch key.  The delay estimate (in engine steps) weighs queued
        prompt SIZE and decode occupancy, not just how many requests are
        waiting."""
        return (self.engine.queue_delay_estimate(),
                len(self.engine.pool.pages))

    def __repr__(self) -> str:
        return (f"EngineReplica(id={self.replica_id}, state={self.state}, "
                f"load={self.load()})")


class Router:
    """Engine-shaped front door over N replicas (see module docstring).

    ``engine_factory`` builds one fresh ``Engine`` per replica — replicas
    share the model through the factory's closure (so they live on its
    device) but own private KV pools, prefix caches, expert stores and
    guidance runtimes.  On a one-replica cluster
    unknown attributes delegate to that engine (``router.pool``,
    ``router.prefix_cache``, ...), so single-engine tooling and tests keep
    working unchanged; with more replicas the same access raises a named
    ``AttributeError`` instead of silently picking one.
    """

    def __init__(self, engine_factory: Callable[[], Engine],
                 n_replicas: int = 1, heartbeat_timeout: float = 8.0,
                 clock: Optional[Callable[[], float]] = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.engine_factory = engine_factory
        self.replicas: List[EngineReplica] = []
        self._next_replica_id = 0
        self._ticks = 0
        # The injected clock defaults to router step ticks: heartbeat
        # timelines are then a pure function of the driving loop.
        self.clock = clock if clock is not None else lambda: float(self._ticks)
        self.monitor = HeartbeatMonitor(
            n_nodes=0, timeout_s=heartbeat_timeout, clock=self.clock)
        self.owner: Dict[int, EngineReplica] = {}
        self.tickets: Dict[int, RequestTicket] = {}
        # Finished results whose engine left the cluster before the caller
        # drained them — served by pop_finished like any other result.
        self._orphan_finished: Dict[int, Request] = {}
        self.lost_requests: Dict[int, str] = {}    # rid -> why
        # ----------------------------------------------------- counters
        self.migrations_warm = 0
        self.migrations_cold = 0
        self.failovers = 0
        self.restarts = 0
        self.requests_lost = 0
        for _ in range(n_replicas):
            self.add_replica()

    # ------------------------------------------------------- membership
    def add_replica(self) -> EngineReplica:
        """Grow the cluster by one fresh replica (ids are never reused, so
        a restarted replica is observably a new member)."""
        rep = EngineReplica(self._next_replica_id, self.engine_factory())
        self._next_replica_id += 1
        self.replicas.append(rep)
        self.monitor.add_node(rep.replica_id)
        return rep

    def _by_id(self, replica_id: int) -> EngineReplica:
        for rep in self.replicas:
            if rep.replica_id == replica_id:
                return rep
        raise ValueError(
            f"unknown replica {replica_id}: cluster members are "
            f"{[r.replica_id for r in self.replicas]}")

    def _alive(self) -> List[EngineReplica]:
        return [r for r in self.replicas if r.state == "alive"]

    def fail(self, replica_id: int) -> None:
        """Simulate a crash: the replica stops beating and stepping, and
        its memory becomes unreachable.  Detection (and cold recovery of
        its requests from the ticket ledger) happens in ``step()`` once
        the heartbeat timeout elapses — the failover window."""
        rep = self._by_id(replica_id)
        if not rep.reachable:
            raise ValueError(
                f"cannot fail replica {replica_id}: already {rep.state}")
        rep.state = "failed"

    def drain(self, replica_id: int) -> int:
        """Gracefully empty a reachable replica: warm-migrate every one of
        its requests to the alive survivors (cold fallback per request
        when a survivor's pool cannot take the pages), and move undrained
        finished results onto the router.  Returns the number of requests
        migrated; the replica is left empty in ``draining`` state —
        ``remove_replica`` completes a scale-down, ``restart_replica`` a
        rolling restart."""
        rep = self._by_id(replica_id)
        if not rep.reachable:
            raise ValueError(
                f"cannot drain replica {replica_id}: {rep.state}")
        rep.state = "draining"
        if not self._alive():
            rep.state = "alive"
            raise ValueError(
                f"cannot drain replica {replica_id}: no other alive "
                f"replica to take its requests (add_replica first)")
        for rid, req in rep.engine.pop_finished().items():
            self._orphan_finished[rid] = req
            t = self.tickets.get(rid)
            if t is not None:
                t.finish_reason = req.finish_reason
        moved = 0
        for rid in sorted(rep.engine.requests):
            self._migrate_from(rep, rid)
            moved += 1
        return moved

    def remove_replica(self, replica_id: int, migrate: bool = True) -> None:
        """Take a replica out of the cluster.  ``migrate=True`` drains it
        first (nothing is lost); ``migrate=False`` abandons whatever it
        still holds — those requests land in ``lost_requests`` and their
        handles raise ``ReplicaLostError``."""
        rep = self._by_id(replica_id)
        if rep.reachable:
            if migrate and rep.engine.requests and self._alive_except(rep):
                self.drain(replica_id)
            for rid, req in rep.engine.pop_finished().items():
                self._orphan_finished[rid] = req
            for rid in sorted(rep.engine.requests):
                self._mark_lost(
                    rid, f"replica {replica_id} was removed without "
                         f"migration")
        rep.state = "dead"
        self.replicas.remove(rep)
        self.monitor.remove_node(rep.replica_id)

    def restart_replica(self, replica_id: int) -> EngineReplica:
        """One rolling-restart move: drain -> remove -> add a fresh
        replica.  In-flight requests migrate to survivors (bitwise), and
        the replacement joins empty as the preferred dispatch target."""
        rep = self._by_id(replica_id)
        if rep.engine.requests and self._alive_except(rep):
            self.drain(replica_id)
        self.remove_replica(replica_id)
        self.restarts += 1
        return self.add_replica()

    def _alive_except(self, rep: EngineReplica) -> List[EngineReplica]:
        return [r for r in self._alive() if r is not rep]

    # --------------------------------------------------------- dispatch
    def _pick(self) -> EngineReplica:
        alive = self._alive()
        if not alive:
            raise ReplicaLostError(
                "no alive replica to dispatch to (all failed, draining, "
                "or removed)")
        return min(alive, key=lambda r: (*r.load(), r.replica_id))

    def add_request(self, request_id: int, prompt,
                    max_new: Optional[int] = None,
                    params=None, replica_id: Optional[int] = None) -> None:
        """Route one request to the least-loaded alive replica (or pin it
        with ``replica_id`` — tests and cache-affinity callers).  The
        ticket ledger entry is cut AFTER engine validation, so a rejected
        request leaves no cluster state behind."""
        rep = (self._by_id(replica_id) if replica_id is not None
               else self._pick())
        if rep.state != "alive":
            raise ValueError(
                f"cannot route request {request_id} to replica "
                f"{rep.replica_id}: {rep.state}")
        rep.engine.add_request(request_id, prompt, max_new=max_new,
                               params=params)
        req = rep.engine.requests.get(request_id)
        if req is None:                      # admitted straight to finished
            req = rep.engine.finished[request_id]
        self.tickets[request_id] = RequestTicket(
            request_id=request_id, prompt=list(req.tokens),
            max_new=req.max_new, params=req.params,
            generated=list(req.generated),
            finish_reason=req.finish_reason)
        self.owner[request_id] = rep

    # --------------------------------------------------------- stepping
    def step(self) -> Dict[int, int]:
        """One cluster step: beat + detect failures + recover, then step
        every reachable replica and fold the new tokens into the ticket
        ledger (the cold-recovery source of truth)."""
        self._ticks += 1
        for rep in self.replicas:
            if rep.reachable:
                self.monitor.beat(rep.replica_id)
        for nid in self.monitor.check_failures():
            rep = next((r for r in self.replicas if r.replica_id == nid),
                       None)
            if rep is not None and rep.state == "failed":
                self._recover(rep)
            else:
                # Spurious detection (e.g. an injected clock jumped):
                # the replica is still stepping — revive its monitor entry
                # rather than recovering requests that never stalled.
                self.monitor.dead.discard(nid)
        out: Dict[int, int] = {}
        for rep in self.replicas:
            if rep.reachable:
                out.update(rep.engine.step())
        for rid, tok in out.items():
            t = self.tickets.get(rid)
            if t is not None:
                t.generated.append(int(tok))
        for rep in self.replicas:
            if not rep.reachable:
                continue
            for rid, req in rep.engine.finished.items():
                t = self.tickets.get(rid)
                if t is not None and t.finish_reason is None:
                    t.finish_reason = req.finish_reason
                    t.generated = list(req.generated)
        return out

    # --------------------------------------------------------- recovery
    def _recover(self, rep: EngineReplica) -> None:
        """Cold failover after a detected crash: every request the dead
        replica owned is rebuilt on a survivor from its ticket — never by
        reading the dead engine."""
        rep.state = "dead"
        self.replicas.remove(rep)
        self.monitor.remove_node(rep.replica_id)
        self.failovers += 1
        mine = sorted(rid for rid, r in self.owner.items() if r is rep)
        for rid in mine:
            t = self.tickets.get(rid)
            if t is None:
                continue
            if t.finish_reason is not None:
                # Finished before the crash but never drained: the ticket
                # already holds the full stream — synthesize the result.
                self._orphan_finished[rid] = Request(
                    request_id=rid, tokens=list(t.prompt),
                    max_new=t.max_new, params=t.params,
                    generated=list(t.generated), state="finished",
                    finish_reason=t.finish_reason,
                    truncated=t.finish_reason == "truncated")
                self.owner.pop(rid, None)
                continue
            self._migrate_cold(rid, t)

    def _migrate_cold(self, rid: int, ticket: RequestTicket) -> None:
        alive = self._alive()
        if not alive:
            self._mark_lost(
                rid, f"request {rid}'s replica died with no alive replica "
                     f"left to rebuild it")
            return
        target = min(alive, key=lambda r: (*r.load(), r.replica_id))
        target.engine.import_request(ticket)
        self.owner[rid] = target
        self.migrations_cold += 1

    def _migrate_from(self, src: EngineReplica, rid: int) -> None:
        """Move one live request off a draining replica.  Warm (KV pages
        ride along, zero recompute) when it holds pages; cold (recompute
        from the ticket) when it holds none or the target cannot fit the
        pages.  Either way the stream is bitwise-unchanged; pause state
        does not survive — a migrated request resumes running."""
        ticket = src.engine.export_request(rid)
        t = self.tickets.get(rid)
        if t is not None:                 # the ledger tracks the handoff
            ticket = RequestTicket(
                request_id=rid, prompt=ticket.prompt,
                max_new=ticket.max_new, params=ticket.params,
                generated=list(ticket.generated))
            self.tickets[rid] = ticket
        pages = src.engine.pool.request_pages(rid)
        if src.engine.requests[rid].state == "prefilling":
            # A mid-ingest request's pages are only written up to ``pos``;
            # the warm path would resume decode as if the whole prompt were
            # in KV.  Cold recompute re-prefills it correctly (and bitwise).
            pages = []
        target = self._pick()
        if pages:
            export = src.engine.pool.export_pages(
                [p.page_id for p in pages])
            try:
                target.engine.import_request(ticket, kv=export)
                self.migrations_warm += 1
            except MemoryError:
                target.engine.import_request(ticket)
                self.migrations_cold += 1
        else:
            target.engine.import_request(ticket)
            self.migrations_cold += 1
        src.engine.remove_request(rid)
        self.owner[rid] = target

    def _mark_lost(self, rid: int, why: str) -> None:
        self.lost_requests[rid] = why
        self.owner.pop(rid, None)
        self.tickets.pop(rid, None)
        self.requests_lost += 1

    # ------------------------------------------------- engine-shaped API
    @property
    def requests(self) -> Dict[int, Request]:
        """Merged live-request view.  A failed-but-undetected replica's
        requests stay visible (the router has not noticed the crash yet);
        they disappear at detection and reappear on their new owner."""
        out: Dict[int, Request] = {}
        for rep in self.replicas:
            if rep.state != "dead":
                out.update(rep.engine.requests)
        return out

    @property
    def finished(self) -> Dict[int, Request]:
        out = dict(self._orphan_finished)
        for rep in self.replicas:
            if rep.reachable:
                out.update(rep.engine.finished)
        return out

    def pop_finished(self, request_id: Optional[int] = None):
        """Drain finished results across the cluster (orphans included)."""
        if request_id is not None:
            if request_id in self._orphan_finished:
                req = self._orphan_finished.pop(request_id)
            else:
                rep = self.owner.get(request_id)
                if rep is None or not rep.reachable:
                    raise KeyError(request_id)
                req = rep.engine.pop_finished(request_id)
            self.tickets.pop(request_id, None)
            self.owner.pop(request_id, None)
            return req
        out, self._orphan_finished = self._orphan_finished, {}
        for rep in self.replicas:
            if rep.reachable:
                out.update(rep.engine.pop_finished())
        for rid in out:
            self.tickets.pop(rid, None)
            self.owner.pop(rid, None)
        return out

    def _owner_or_raise(self, request_id: int, verb: str) -> EngineReplica:
        if request_id in self.lost_requests:
            raise ReplicaLostError(
                f"cannot {verb} request {request_id}: "
                f"{self.lost_requests[request_id]}")
        rep = self.owner.get(request_id)
        if rep is None:
            raise ValueError(
                f"cannot {verb} request {request_id}: unknown id")
        if not rep.reachable:
            raise ReplicaLostError(
                f"cannot {verb} request {request_id}: its replica "
                f"{rep.replica_id} is unreachable (failover pending)")
        return rep

    def pause(self, request_id: int) -> None:
        self._owner_or_raise(request_id, "pause").engine.pause(request_id)

    def resume(self, request_id: int) -> None:
        self._owner_or_raise(request_id, "resume").engine.resume(request_id)

    def cancel(self, request_id: int) -> None:
        """Withdraw a live request on its owning replica.  The ticket is
        stamped immediately, so a crash between cancel and drain still
        resolves to a ``cancelled`` result rather than a recompute."""
        rep = self._owner_or_raise(request_id, "cancel")
        req = rep.engine.cancel(request_id)
        t = self.tickets.get(request_id)
        if t is not None:
            t.finish_reason = req.finish_reason
            t.generated = list(req.generated)

    def stats(self) -> Dict[str, float]:
        """Cluster-aggregate engine counters (summed over reachable
        replicas, with the prefix hit rate recomputed from the summed
        components) plus ``cluster_*`` lifecycle counters.  At N=1 this is
        the single engine's stats dict plus the cluster scalars."""
        agg: Dict[str, float] = {}
        for rep in self.replicas:
            if not rep.reachable:
                continue
            # No float cast: summing preserves each counter's own type, so
            # int counters stay ints (pre-cluster consumers %d-format them).
            for k, v in rep.engine.stats().items():
                agg[k] = agg.get(k, 0) + v
        # Per-replica means do not sum; report the replica average (the
        # same ``mean_`` convention serving_summary applies).
        n_reachable = sum(1 for r in self.replicas if r.reachable)
        if n_reachable > 1:
            for k in agg:
                if "mean_" in k:
                    agg[k] = agg[k] / n_reachable
        if agg.get("prefix_lookups"):
            agg["prefix_hit_rate"] = (agg["prefix_hit_requests"]
                                      / agg["prefix_lookups"])
        agg.update({
            "cluster_replicas": sum(
                1 for r in self.replicas if r.reachable),
            "cluster_migrations_warm": self.migrations_warm,
            "cluster_migrations_cold": self.migrations_cold,
            "cluster_failovers": self.failovers,
            "cluster_restarts": self.restarts,
            "cluster_requests_lost": self.requests_lost,
        })
        return agg

    def __getattr__(self, name: str):
        # Single-replica transparency: `.pool`, `.prefix_cache`,
        # `.runtime`, `.prefill_dispatches`, `._preempt_one`, ... resolve
        # to the sole reachable engine so Engine-era tooling (tests drive
        # internals like `_preempt_one` directly) works unchanged at N=1.
        # Dunders never delegate: protocol probes (pickle, copy, ipython)
        # must see the Router's own absence, not an engine method.
        if name.startswith("__"):
            raise AttributeError(name)
        reps = self.__dict__.get("replicas") or []
        live = [r for r in reps if r.reachable]
        if len(live) == 1:
            return getattr(live[0].engine, name)
        raise AttributeError(
            f"Router has no attribute {name!r} and cannot delegate it: "
            f"{len(live)} reachable replicas (single-engine attributes "
            f"are only transparent on a one-replica cluster; address "
            f"router.replicas[i].engine.{name} explicitly)")
