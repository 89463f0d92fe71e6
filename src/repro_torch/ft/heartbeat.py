"""Failure detection and straggler mitigation for multi-node runs.

On a real cluster each host runs a ``HeartbeatMonitor`` peer; here the
monitor is driven by the launcher/trainer loop (and by fault-injection in
tests), but the logic — missed-beat failure detection, EWMA step-time
straggler scoring, hot-spare replacement planning — is the production code
path.

Recovery contract (launch/train.py): on a detected failure the run (a)
marks the node dead, (b) computes the rescale plan (ft/elastic.py), (c)
restores the latest checkpoint onto the surviving mesh, (d) resumes.  The
trainer's checkpoint cadence bounds lost work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set


@dataclasses.dataclass
class NodeStats:
    node_id: int
    last_beat: float
    step_time_ewma: float = 0.0
    beats: int = 0


class HeartbeatMonitor:
    def __init__(self, n_nodes: int, timeout_s: float = 60.0,
                 straggler_factor: float = 1.8, ewma: float = 0.2,
                 clock=time.monotonic):
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.ewma = ewma
        self.clock = clock
        now = clock()
        self.nodes: Dict[int, NodeStats] = {
            i: NodeStats(i, now) for i in range(n_nodes)}
        self.dead: Set[int] = set()
        self.spares: List[int] = []

    def add_spare(self, node_id: int):
        self.spares.append(node_id)

    # ---------------------------------------------------------- membership
    def add_node(self, node_id: int):
        """Register a node after construction — elastic membership (a
        serving replica joining the cluster, a spare being activated).
        The node starts alive with its beat clock at ``now``."""
        if node_id in self.nodes and node_id not in self.dead:
            raise ValueError(
                f"cannot add node {node_id}: already monitored and alive")
        self.dead.discard(node_id)
        self.nodes[node_id] = NodeStats(node_id, self.clock())

    def remove_node(self, node_id: int):
        """Forget a node entirely (graceful leave, or cleanup after its
        failure was handled) — unknown ids are a no-op so teardown paths
        can call it unconditionally."""
        self.nodes.pop(node_id, None)
        self.dead.discard(node_id)

    def beat(self, node_id: int, step_time_s: Optional[float] = None):
        if node_id in self.dead:
            return
        st = self.nodes[node_id]
        st.last_beat = self.clock()
        st.beats += 1
        if step_time_s is not None:
            if st.step_time_ewma == 0.0:
                st.step_time_ewma = step_time_s
            else:
                st.step_time_ewma = (
                    (1 - self.ewma) * st.step_time_ewma
                    + self.ewma * step_time_s)

    # ---------------------------------------------------------- detection
    def check_failures(self) -> List[int]:
        now = self.clock()
        newly = [
            nid for nid, st in self.nodes.items()
            if nid not in self.dead and now - st.last_beat > self.timeout_s
        ]
        self.dead.update(newly)
        return newly

    def stragglers(self) -> List[int]:
        """Nodes whose EWMA step time exceeds straggler_factor x median."""
        alive = [st for nid, st in self.nodes.items()
                 if nid not in self.dead and st.step_time_ewma > 0]
        if len(alive) < 3:
            return []
        times = sorted(st.step_time_ewma for st in alive)
        median = times[len(times) // 2]
        return [st.node_id for st in alive
                if st.step_time_ewma > self.straggler_factor * median]

    # ----------------------------------------------------------- recovery
    def plan_replacement(self, failed: List[int]) -> Dict[int, Optional[int]]:
        """Map failed/straggler node -> spare (or None -> shrink)."""
        plan: Dict[int, Optional[int]] = {}
        for nid in failed:
            plan[nid] = self.spares.pop(0) if self.spares else None
        return plan

    @property
    def alive(self) -> List[int]:
        return [nid for nid in self.nodes if nid not in self.dead]
