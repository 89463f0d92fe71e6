"""Serving and guidance telemetry of the port — ``guidance_summary`` and
``serving_summary``, copied from ``repro/launch/analysis.py`` (both are
framework-free).

``guidance_summary`` consumes the ``GuidanceRuntime``'s structured event
stream (interval decisions + rental payments); ``serving_summary`` is one
view over an ``Engine``'s or a ``Router``'s counters plus each controller's
events.  The reference module's jaxpr and HLO cost walk is not here: it
belongs with distribution (ROADMAP.md queue A item 11).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable


# ===================================================== guidance telemetry
def guidance_summary(events: Iterable[Any]) -> Dict[str, float]:
    """Aggregate a ``GuidanceRuntime`` event stream into report scalars.

    Accepts the runtime's ``events`` list (mixed ``IntervalEvent`` /
    ``RentalEvent``, discriminated by ``.kind``).  Every consumer — the
    launchers, ``chip_smoke.py`` — reads tiering telemetry through this
    one function.
    """
    intervals = [e for e in events if getattr(e, "kind", None) == "interval"]
    rentals = [e for e in events if getattr(e, "kind", None) == "rental"]
    migrations = [e for e in intervals if e.migrated]
    ratios = [e.decision.ratio for e in intervals
              if e.decision is not None and math.isfinite(e.decision.ratio)]
    return {
        "intervals": float(len(intervals)),
        "migrations": float(len(migrations)),
        "bytes_migrated": float(sum(e.bytes_moved for e in intervals)),
        "dropped_promotions": float(
            sum(e.dropped_promotions for e in intervals)),
        "rental_events": float(len(rentals)),
        "rental_bytes": float(sum(e.nbytes for e in rentals)),
        "mean_decision_ratio": (sum(ratios) / len(ratios)) if ratios else 0.0,
        "profile_seconds": float(
            sum(e.profile_seconds for e in intervals)),
    }


def serving_summary(engine) -> Dict[str, Any]:
    """One view over the serving engine's scheduler/migration counters and
    (when guided) the controller's event stream.

    Engine-side scalars are prefixed ``engine_`` (swap and transfer probes,
    prefill dispatch/token counts, admission/preemption/starvation totals,
    prefix-cache hit/saved-token counters when the cache is enabled, and
    the per-``finish_reason`` counts ``engine_finished_stop`` /
    ``engine_finished_length`` / ``engine_finished_truncated``); guidance
    scalars keep the ``guidance_summary`` names — the per-request KV
    controller's unprefixed, the shared-prefix controller's under
    ``prefix_``.  Launchers and reports read serving telemetry through
    this function rather than poking at per-subsystem counters.

    A ``serve.cluster.Router`` is accepted wherever an ``Engine`` is: the
    top level is then the cluster AGGREGATE (counters summed over reachable
    replicas — ``mean_``-prefixed scalars averaged — the prefix hit rate
    recomputed from summed components, and the router's ``cluster_*``
    lifecycle counters), with each replica's own flat summary under
    ``summary["replicas"]["replica<id>"]``.  At N=1 the aggregate equals
    the single engine's summary plus the ``cluster_*`` scalars, so
    consumers indexing ``engine_*`` keys work at any replica count.
    """
    if hasattr(engine, "replicas") and hasattr(engine, "tickets"):
        router = engine
        per = {f"replica{rep.replica_id}": serving_summary(rep.engine)
               for rep in router.replicas if rep.reachable}
        agg: Dict[str, Any] = {}
        means: Dict[str, list] = {}
        for summary in per.values():
            for k, v in summary.items():
                if not isinstance(v, (int, float)):
                    continue
                if "mean_" in k:
                    means.setdefault(k, []).append(float(v))
                else:
                    agg[k] = agg.get(k, 0.0) + float(v)
        for k, vals in means.items():
            agg[k] = sum(vals) / len(vals)
        if agg.get("engine_prefix_lookups"):
            agg["engine_prefix_hit_rate"] = (
                agg.get("engine_prefix_hit_requests", 0.0)
                / agg["engine_prefix_lookups"])
        agg.update({
            "cluster_replicas": float(len(per)),
            "cluster_migrations_warm": float(router.migrations_warm),
            "cluster_migrations_cold": float(router.migrations_cold),
            "cluster_failovers": float(router.failovers),
            "cluster_restarts": float(router.restarts),
            "cluster_requests_lost": float(router.requests_lost),
        })
        if len(per) > 1:
            agg["replicas"] = per
        return agg
    out = {f"engine_{k}": float(v) for k, v in engine.stats().items()}
    if getattr(engine, "runtime", None) is not None:
        out.update(guidance_summary(engine.runtime.events))
    if getattr(engine, "prefix_runtime", None) is not None:
        out.update({f"prefix_{k}": v for k, v in
                    guidance_summary(engine.prefix_runtime.events).items()})
    if getattr(engine, "expert_runtime", None) is not None:
        out.update({f"expert_{k}": v for k, v in
                    guidance_summary(engine.expert_runtime.events).items()})
    return out
