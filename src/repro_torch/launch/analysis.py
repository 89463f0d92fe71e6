"""Cost accounting and telemetry of the port (``repro/launch/analysis.py``).

``cost_of(fn, *args)`` is the counterpart of the reference's ``jaxpr_cost``:
it runs ``fn`` under a ``TorchDispatchMode`` and counts every aten op that
reaches it, so loops count once a trip and a backward (``loss.backward()``
inside ``fn``) and remat's recomputation count by running.

* ``flops``: the matmul family exactly, 2 * batch * m * n * k; each op that
  is the counterpart of the reference's ``_ELEMENTWISE_FLOPS`` at its
  output's numel.  aten's fused ops (``_softmax``, ``silu``, their
  backwards, ``nll_loss``) are not in that set, as JAX's reductions are
  not: where the reference spells softmax out in primitives, it counts the
  sub, exp and div that aten fuses.
* ``bytes_naive``: every op's tensor operands and outputs.
* ``bytes_dot``: the reference's post-fusion estimate: matmul, cat,
  cumsum, sort and topk operands and outputs; a gather (``index_select``,
  ``embedding``, advanced indexing, ``gather``) twice its output plus its
  indices, never the pool; a scatter (``index_put``, ``scatter_add``,
  ``index_add``, the embedding's backward) three times its update plus
  its indices; a slice update three times the slice.

The kernels are ``ctypes`` launches and invisible to the mode: each
kernel's autograd Function, and each inference entry point of
``kernels.ops``, charges its own cost from its shapes
(``kernels.cost``), so one step counts the same on the CPU, on ``meta``
and on the card.

``guidance_summary`` and ``serving_summary`` are framework-free copies:
the ``GuidanceRuntime``'s event stream and an ``Engine``'s or a
``Router``'s counters as report scalars.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import cost as kcost


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


# ================================================================ costs
_aten = torch.ops.aten


_MATMUL = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
           _aten.baddbmm.default, _aten.mv.default, _aten.dot.default}
# The counterparts of the reference's _ELEMENTWISE_FLOPS (add, sub, mul,
# div, max, min, neg, exp, log, tanh, logistic, rsqrt, sqrt, pow,
# integer_pow, erf, abs, floor, ceil, round, sign, cos, sin).
_ELEMENTWISE = {"add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div",
                "div_", "maximum", "minimum", "neg", "exp", "log", "tanh",
                "sigmoid", "rsqrt", "sqrt", "pow", "erf", "abs", "floor",
                "ceil", "round", "sign", "cos", "sin", "reciprocal"}
_GATHER = {"index_select", "embedding", "index", "gather"}
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "scatter_add",
            "scatter_add_", "index_add", "index_add_",
            "embedding_dense_backward", "scatter", "scatter_"}
_DOT_LIKE = {"cat", "cumsum", "sort", "topk", "convolution"}


def _tensors(tree) -> list:
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _bytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _matmul_flops(op, args) -> float:
    if op in (_aten.mm.default, _aten.addmm.default):
        a, b = (args[0], args[1]) if op is _aten.mm.default else args[1:3]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if op in (_aten.bmm.default, _aten.baddbmm.default):
        a, b = (args[0], args[1]) if op is _aten.bmm.default else args[1:3]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if op is _aten.mv.default:
        return 2.0 * args[0].shape[0] * args[0].shape[1]
    return 2.0 * args[0].numel()                   # dot


class CostWalk(TorchDispatchMode):
    """The counting mode of ``cost_of``: ``totals`` holds ``flops``,
    ``bytes_naive`` and ``bytes_dot``; ``matmul_flops`` the matrix
    products' share (aten's and the kernels'); ``kernels`` the flops
    charged by each kernel (``kernels.cost``)."""

    def __init__(self):
        super().__init__()
        self.totals = {"flops": 0.0, "bytes_naive": 0.0, "bytes_dot": 0.0}
        self.kernels: Dict[str, float] = {}
        self.matmul_flops = 0.0

    def charge(self, name: str, c: "kcost.Cost") -> None:
        self.totals["flops"] += c.flops
        self.totals["bytes_naive"] += c.bytes
        self.totals["bytes_dot"] += c.bytes
        self.matmul_flops += c.products
        self.kernels[name] = self.kernels.get(name, 0.0) + c.flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if kcost.SUSPENDED[0]:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_b, out_b = _bytes(ins), _bytes(outs)
        t = self.totals
        t["bytes_naive"] += in_b + out_b
        name = func.overloadpacket.__name__
        if func in _MATMUL:
            flops = _matmul_flops(func, args)
            t["flops"] += flops
            self.matmul_flops += flops
            t["bytes_dot"] += in_b + out_b
        elif name in _GATHER:
            idx = [x for x in ins if not x.is_floating_point()]
            t["bytes_dot"] += 2 * out_b + _bytes(idx)
        elif name in _SCATTER:
            idx = [x for x in ins if not x.is_floating_point()]
            upd = [x for x in ins if x.is_floating_point()][-1:]
            t["bytes_dot"] += 3 * _bytes(upd) + _bytes(idx)
        elif name == "slice_scatter":
            t["bytes_dot"] += 3 * _bytes(ins[1:2])
        elif name in _DOT_LIKE:
            t["bytes_dot"] += in_b + out_b
        elif name in _ELEMENTWISE and outs:
            t["flops"] += float(outs[0].numel())
        return out


def cost_of(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` and count what it does: ``flops``,
    ``bytes_naive``, ``bytes_dot`` (module docstring), ``matmul_flops``
    (the matrix products, aten's and the kernels') and ``kernels`` (the
    flops each kernel charged).  Put ``loss.backward()`` inside ``fn`` to
    count a training step."""
    walk = CostWalk()
    kcost.WALKS.append(walk)
    try:
        with walk:
            fn(*args, **kwargs)
    finally:
        kcost.WALKS.remove(walk)
    return {**walk.totals, "matmul_flops": walk.matmul_flops,
            "kernels": dict(walk.kernels)}
