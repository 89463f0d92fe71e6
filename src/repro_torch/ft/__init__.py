"""Failure detection of the port (``repro/ft``): ``HeartbeatMonitor``, a
framework-free copy.  Elastic rescaling (``ft/elastic.py``) is not ported
yet (ROADMAP.md queue A item 11)."""

from .heartbeat import HeartbeatMonitor, NodeStats

__all__ = ["HeartbeatMonitor", "NodeStats"]
