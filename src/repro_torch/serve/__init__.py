"""Serving of the port: the ``LLM`` front door over the ``Engine``, its
two-tier paged KV pool, the shared-prefix cache, the tiered expert store,
and the guided placement of pages, prefixes and expert blocks."""

from .api import DEFAULT_MAX_TOKENS, LLM, RequestHandle, RequestOutput
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

__all__ = [
    "DEFAULT_MAX_TOKENS",
    "EVICTION_POLICIES",
    "DrrPolicy",
    "Engine",
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
    "Request",
    "RequestHandle",
    "RequestOutput",
    "RequestTicket",
    "SCHEDULER_POLICIES",
    "SamplingParams",
    "SchedulerPolicy",
    "ServeConfig",
    "StepBudget",
    "block_hash",
    "make_eviction_policy",
    "make_scheduler_policy",
    "register_eviction_policy",
    "register_scheduler_policy",
]
