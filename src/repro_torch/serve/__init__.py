"""Serving of the port: the ``LLM`` front door over a ``Router`` of
``Engine`` replicas, their two-tier paged KV pools, the shared-prefix
cache, the tiered expert store, the guided placement of pages, prefixes
and expert blocks, and trace synthesis and replay."""

from .api import DEFAULT_MAX_TOKENS, LLM, RequestHandle, RequestOutput
from .cluster import EngineReplica, ReplicaLostError, Router
from .engine import Engine, PagedKVBackend, Request, RequestTicket, ServeConfig
from .eviction import (
    EVICTION_POLICIES,
    EvictionPolicy,
    make_eviction_policy,
    register_eviction_policy,
)
from .expert_store import ExpertBackend, ExpertCacheMissError, ExpertStore
from .kvcache import Page, PageExport, PagedKVPool
from .prefix_cache import PrefixBackend, PrefixCache, PrefixNode, block_hash
from .sampling import SamplingParams
from .scheduler import (
    SCHEDULER_POLICIES,
    DrrPolicy,
    FifoPolicy,
    PriorityPolicy,
    SchedulerPolicy,
    StepBudget,
    make_scheduler_policy,
    register_scheduler_policy,
)
from .workload import (
    SLO,
    ReplayReport,
    StepCostModel,
    TenantSpec,
    Trace,
    TraceReplayer,
    TraceRequest,
    WorkloadConfig,
    synthesize,
)

__all__ = [
    "DEFAULT_MAX_TOKENS",
    "EVICTION_POLICIES",
    "DrrPolicy",
    "Engine",
    "EngineReplica",
    "EvictionPolicy",
    "ExpertBackend",
    "ExpertCacheMissError",
    "ExpertStore",
    "FifoPolicy",
    "LLM",
    "Page",
    "PageExport",
    "PagedKVBackend",
    "PagedKVPool",
    "PrefixBackend",
    "PrefixCache",
    "PrefixNode",
    "PriorityPolicy",
    "ReplayReport",
    "ReplicaLostError",
    "Request",
    "RequestHandle",
    "RequestOutput",
    "RequestTicket",
    "Router",
    "SCHEDULER_POLICIES",
    "SLO",
    "SamplingParams",
    "SchedulerPolicy",
    "ServeConfig",
    "StepBudget",
    "StepCostModel",
    "TenantSpec",
    "Trace",
    "TraceReplayer",
    "TraceRequest",
    "WorkloadConfig",
    "block_hash",
    "make_eviction_policy",
    "make_scheduler_policy",
    "register_eviction_policy",
    "register_scheduler_policy",
    "synthesize",
]
