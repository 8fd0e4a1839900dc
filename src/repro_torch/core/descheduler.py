"""Periodic descheduler: evict-to-rebalance off overloaded nodes.

The CPU-aware K3s scheduler (SNIPPETS.md) pairs utilization-scored
placement with a 30 s daemon that offloads pods from nodes ≥90% busy
so they reschedule onto cooler ones.  This is that daemon for the
simulated cluster: a sim daemon timer (``Sim.after(daemon=True)``, so
an armed descheduler never keeps an otherwise-drained run alive)
wakes every ``interval_s``, checks each node's live utilization
(``Cluster.node_util``: max of bound cpu/mem fraction — O(nodes) per
tick, pods are only scanned when something is actually hot), and
evicts up to ``max_evict_per_node`` RUNNING pods from every node at
or above ``util_threshold`` via ``Cluster.rebalance_evict``.

Evicted pods surface as FAILED with ``evicted=True`` AND
``rebalanced=True``, so the engine's requeue machinery (the PR-4/PR-7
path preemptions and node losses already ride) re-admits the task
with NO retry-budget charge, and recovery metrics count the offload
separately (``WorkflowRecord.rebalanced``).

Determinism: everything is a pure function of cluster state — nodes
are visited in the canonical ``_node_seq`` order, victims on a hot
node follow the declared ``victim`` policy (``"youngest"``: latest
``started``, least sunk work; ``"largest-request"``: biggest cpu/mem
ask, most relief per eviction; pod name tie-breaks both), and NO
random draw is ever consumed,
so arming a descheduler does not move the scheduler RNG word stream
and a fixed seed replays exactly.  Thrash guard: a pod is only
offloaded when some OTHER ready node below the threshold could fit
it right now — on a uniformly hot cluster the daemon idles instead of
cycling pods between equally-busy nodes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.cluster import RUNNING, Cluster
from repro_torch.core.sim import Sim


VICTIM_POLICIES = ("youngest", "largest-request")


@dataclass(frozen=True)
class DeschedulePolicy:
    """Picklable descheduler knobs (frozen: shareable across shards)."""
    interval_s: float = 30.0           # wake cadence (K3s: 30 s)
    util_threshold: float = 0.90       # node is "hot" at >= this
    max_evict_per_node: int = 1        # offloads per hot node per tick
    start_after_s: float = 0.0         # calm period before the first tick
    victim: str = "youngest"           # eviction order on a hot node:
                                       # "youngest" = least sunk work,
                                       # "largest-request" = biggest
                                       # utilization relief per eviction


class Descheduler:
    """The live daemon: arm once per run, read ``counters()`` after."""

    def __init__(self, sim: Sim, cluster: Cluster, policy: DeschedulePolicy):
        if policy.interval_s <= 0:
            raise ValueError("interval_s must be positive")
        if not (0.0 < policy.util_threshold <= 1.0):
            raise ValueError("util_threshold must be in (0, 1]")
        if policy.victim not in VICTIM_POLICIES:
            raise ValueError(f"unknown victim policy {policy.victim!r}; "
                             f"expected one of {VICTIM_POLICIES}")
        self.sim = sim
        self.cluster = cluster
        self.policy = policy
        self.cycles = 0                # ticks that found >= 1 hot node
        self.ticks = 0                 # all wakeups
        self.evictions = 0             # pods offloaded
        sim.after(policy.start_after_s + policy.interval_s, self._tick,
                  daemon=True, note="descheduler")

    def _tick(self):
        self.ticks += 1
        cluster = self.cluster
        threshold = self.policy.util_threshold
        hot = []
        cool = []                      # ready nodes below the threshold
        for node in cluster._node_seq:
            if not node.ready:
                continue
            if cluster.node_util(node) >= threshold:
                hot.append(node)
            else:
                cool.append(node)
        if hot and cool:
            self.cycles += 1
            for node in hot:
                self._offload(node, cool)
        self.sim.after(self.policy.interval_s, self._tick, daemon=True,
                       note="descheduler")

    def _offload(self, node, cool):
        """Evict up to ``max_evict_per_node`` RUNNING residents of one
        hot node, ordered by the victim policy (youngest = latest
        ``started``, least sunk work; largest-request = biggest
        cpu/mem ask, most relief per eviction; pod name tie-breaks
        both), each gated on a cooler node that fits it (thrash
        guard)."""
        if self.policy.victim == "largest-request":
            key = lambda p: (-p.cpu_m, -p.mem_mi, p.name)
        else:
            key = lambda p: (-p.started, p.name)
        residents = sorted(
            (pod for pod in self.cluster.pods.values()
             if pod.node == node.name and pod.phase == RUNNING),
            key=key)
        evicted = 0
        for pod in residents:
            if evicted >= self.policy.max_evict_per_node:
                break
            if not any(n.fits(pod.cpu_m, pod.mem_mi) for n in cool):
                continue
            if self.cluster.rebalance_evict(pod.namespace, pod.name):
                evicted += 1
        self.evictions += evicted

    def counters(self) -> dict:
        return {"ticks": self.ticks, "active_cycles": self.cycles,
                "evictions": self.evictions,
                "interval_s": self.policy.interval_s,
                "util_threshold": self.policy.util_threshold,
                "victim": self.policy.victim}
