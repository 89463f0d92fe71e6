"""Fault tolerance of the port (``repro/ft``): ``HeartbeatMonitor``, a
framework-free copy, and elastic rescaling (``plan_rescale`` and
``reshard_state``)."""

from .elastic import RescalePlan, plan_rescale, reshard_state
from .heartbeat import HeartbeatMonitor, NodeStats

__all__ = ["HeartbeatMonitor", "NodeStats", "RescalePlan", "plan_rescale",
           "reshard_state"]
