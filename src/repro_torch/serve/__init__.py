"""Serving of the port: the ``LLM`` front door over the dense ``Engine``,
its two-tier paged KV pool and the guided placement of its pages."""

from .api import DEFAULT_MAX_TOKENS, LLM, RequestHandle, RequestOutput
from .engine import Engine, PagedKVBackend, Request, RequestTicket, ServeConfig
from .eviction import (
    EVICTION_POLICIES,
    EvictionPolicy,
    make_eviction_policy,
    register_eviction_policy,
)
from .kvcache import Page, PageExport, PagedKVPool
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
    "FifoPolicy",
    "LLM",
    "Page",
    "PageExport",
    "PagedKVBackend",
    "PagedKVPool",
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
    "make_eviction_policy",
    "make_scheduler_policy",
    "register_eviction_policy",
    "register_scheduler_policy",
]
