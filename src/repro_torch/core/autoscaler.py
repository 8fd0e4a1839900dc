"""Elastic node autoscaler: pending-depth scale-up, idle-drain scale-down.

KubeAdaptor's headline win over Argo is resource usage rate; its
follow-up (Shan et al., "Adaptive Resource Allocation for Workflow
Containerization on Kubernetes") and xpk's node-auto-provisioning
push the same engine toward elastic clusters where capacity is paid
for only while the workload needs it.  This daemon is that loop for
the simulated cluster: declared **node pools** (one per
``calibration`` node class) scale up when admission pressure is
sustained and drain back down when the cluster goes idle, turning
resource usage rate into an optimizable axis — equal makespan and
SLO hit-rate at materially fewer node-seconds (``Cluster.cost_summary``).

Mechanics (all through existing primitives, no new scheduler paths):

* The FULL max roster is materialized up front by the cluster
  builder, so the native ``ka_schedule_cycle`` mirrors keep fixed
  node indices for the whole run.  Scale state is a per-node
  ``provisioned`` bit: scale-up flips a node back in via
  ``Cluster.provision_node`` (a ``restore_node``-style ready-array
  write + node MODIFIED fan-out + scheduler kick), scale-down
  cordons+drains through ``Cluster.deprovision_node`` (the PR-7
  ``drain_node`` reclaim path — residents requeue through admission
  with no retry-budget charge).
* Scale-up: when pending depth (admission queue + unbound pod queue)
  stays at or above ``pending_threshold`` for ``sustain_s``, each
  subsequent tick provisions ``scale_step`` more nodes (first
  deprovisioned member, pools in declared order) — monotone growth
  to the pool max, so a persistent backlog always reaches full
  capacity (liveness).
* Scale-down: ONLY when the pending depth is zero AND the unbound
  pod queue is empty (never strands a pending pod), nodes that have
  held zero resource-bound pods for ``idle_s`` are drained in
  reverse roster order, respecting each pool's ``min`` and never
  dropping the cluster's last provisioned node.

Determinism contract (same as the PR-8 descheduler): every decision
is a pure function of cluster state, nodes are visited in canonical
``_node_seq`` order, the timer is a ``Sim.after(daemon=True)`` event
(an armed autoscaler never keeps an otherwise-drained run alive),
and NO random draw is ever consumed — arming it does not move the
scheduler/chaos RNG word streams, so a fixed seed replays exactly
and every pinned binding hash is untouched when it is disabled.

Sharding: ``AutoscalePolicy`` is frozen/picklable and crosses the
fork like ``ShardSpec.deschedule``; ``spawn(index, workers)`` slices
explicit pool min/max across shards with the same base+remainder
split as the node partition, while derived pools (``pools=()``) pass
through and re-derive from each shard's own roster prefix.  The cost
integrals it shapes merge exactly across shards (areas and flips
add, peaks/lows take max/min).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import calibration
from repro_torch.core.cluster import Cluster
from repro_torch.core.sim import Sim


def _split(total: int, index: int, workers: int) -> int:
    """Base+remainder share of ``total`` for shard ``index`` — the
    same split ``shard.partition_nodes`` applies to the roster, so a
    pool's min/max slices line up with each shard's node prefix."""
    base, rem = divmod(total, workers)
    return base + (1 if index < rem else 0)


@dataclass(frozen=True)
class NodePool:
    """One elastic pool: the members of ``node_class`` may be scaled
    between ``min`` and ``max`` provisioned nodes.  ``max=None``
    means the whole class population; classes without a declared
    pool stay fully provisioned and unmanaged."""
    node_class: str
    min: int = 0
    max: Optional[int] = None


@dataclass(frozen=True)
class AutoscalePolicy:
    """Picklable autoscaler knobs (frozen: shareable across shards).

    With ``pools=()`` one pool per node class is derived from the
    roster: ``max`` = the class population, ``min`` =
    ``ceil(min_frac * population)`` (at least 1)."""
    pools: Tuple[NodePool, ...] = ()
    min_frac: float = 0.25             # derived-pool floor fraction
    interval_s: float = 15.0           # wake cadence
    pending_threshold: int = 1         # depth that counts as pressure
    sustain_s: float = 30.0            # pressure must persist this long
    scale_step: int = 1                # nodes provisioned per hot tick
    idle_s: float = 60.0               # zero-usage span before drain
    start_after_s: float = 0.0         # calm period before the first tick

    def spawn(self, index: int, workers: int) -> "AutoscalePolicy":
        """Per-shard slice: explicit pool min/max partition like the
        node roster; derived pools re-derive per shard."""
        if workers <= 1 or not self.pools:
            return self
        sliced = tuple(
            NodePool(p.node_class,
                     _split(p.min, index, workers),
                     None if p.max is None
                     else _split(p.max, index, workers))
            for p in self.pools)
        return replace(self, pools=sliced)


class _Pool:
    """Resolved pool state: ordered member names + provision floor."""
    __slots__ = ("node_class", "names", "min_n")

    def __init__(self, node_class: str, names: List[str], min_n: int):
        self.node_class = node_class
        self.names = names
        self.min_n = min_n


class Autoscaler:
    """The live daemon: arm once per run, read ``counters()`` after."""

    def __init__(self, sim: Sim, cluster: Cluster, policy: AutoscalePolicy,
                 cluster_cfg=None,
                 pending_fn: Optional[Callable[[], int]] = None):
        if policy.interval_s <= 0:
            raise ValueError("interval_s must be positive")
        if policy.pending_threshold < 1:
            raise ValueError("pending_threshold must be >= 1")
        if policy.sustain_s < 0 or policy.idle_s < 0:
            raise ValueError("sustain_s and idle_s must be >= 0")
        if policy.scale_step < 1:
            raise ValueError("scale_step must be >= 1")
        if not (0.0 < policy.min_frac <= 1.0):
            raise ValueError("min_frac must be in (0, 1]")
        if policy.start_after_s < 0:
            raise ValueError("start_after_s must be >= 0")
        self.sim = sim
        self.cluster = cluster
        self.policy = policy
        self.pending_fn = pending_fn
        self.ticks = 0
        self.scale_up_events = 0       # ticks that provisioned >= 1 node
        self.scale_down_events = 0     # ticks that drained >= 1 node
        self.nodes_provisioned = 0
        self.nodes_deprovisioned = 0
        self.pods_drained = 0          # residents disrupted by scale-down
        self._above_since: Optional[float] = None
        self._idle_since: Dict[str, float] = {}
        self._pools = self._resolve_pools(cluster_cfg)
        # shrink to each pool's floor before the run starts: the max
        # roster is materialized (fixed native indices) but only the
        # floor is paid for until pressure shows up
        for pool in self._pools:
            full = self._class_names[pool.node_class]
            for name in full[pool.min_n:]:
                cluster.deprovision_node(name)
        # the shrink runs at t=0 (zero cost accrued at full size): the
        # run's peak/low start from the floor, not the materialized max
        cluster._prov_peak = cluster._prov_low = cluster._prov_nodes
        sim.after(policy.start_after_s + policy.interval_s, self._tick,
                  daemon=True, note="autoscaler")

    # ---- pool resolution --------------------------------------------------
    def _resolve_pools(self, cluster_cfg) -> List[_Pool]:
        roster = [n.name for n in self.cluster._node_seq]
        if cluster_cfg is not None:
            labels = calibration.node_class_names(cluster_cfg)
            if len(labels) != len(roster):
                raise ValueError(
                    f"cluster config declares {len(labels)} nodes but the "
                    f"cluster materialized {len(roster)}")
        else:
            labels = ("node",) * len(roster)
        by_class: Dict[str, List[str]] = {}
        for name, label in zip(roster, labels):
            by_class.setdefault(label, []).append(name)
        self._class_names = by_class
        pools: List[_Pool] = []
        if self.policy.pools:
            for p in self.policy.pools:
                names = by_class.get(p.node_class)
                if names is None:
                    raise ValueError(
                        f"unknown node class {p.node_class!r}; roster has "
                        f"{sorted(by_class)}")
                max_n = len(names) if p.max is None \
                    else max(0, min(p.max, len(names)))
                min_n = max(0, min(p.min, max_n))
                # members beyond max stay deprovisioned for the whole
                # run (shrunk below); scale-up only walks names[:max_n]
                pools.append(_Pool(p.node_class, names[:max_n], min_n))
        else:
            for label, names in by_class.items():
                floor = min(len(names),
                            max(1, math.ceil(
                                self.policy.min_frac * len(names))))
                pools.append(_Pool(label, names, floor))
        return pools

    # ---- the daemon loop --------------------------------------------------
    def _depth(self) -> int:
        """Admission-queue depth (runner wires the arbiter's pending
        map in) plus the cluster's unbound pod queue — both mean
        work waiting on capacity."""
        base = self.pending_fn() if self.pending_fn is not None else 0
        return base + len(self.cluster._pending_pods)

    def _tick(self):
        self.ticks += 1
        now = self.sim.now()
        self._track_idle(now)
        depth = self._depth()
        if depth >= self.policy.pending_threshold:
            if self._above_since is None:
                self._above_since = now
            # NOT reset after a scale-up: every further hot tick adds
            # scale_step more, so a persistent backlog reaches max
            if now - self._above_since + 1e-9 >= self.policy.sustain_s:
                self._scale_up()
        else:
            self._above_since = None
            if depth == 0:
                self._scale_down(now)
        self.sim.after(self.policy.interval_s, self._tick, daemon=True,
                       note="autoscaler")

    def _track_idle(self, now: float):
        """A node is idle when it holds zero bound resources (even
        virtual entry/exit pods request 50m/50Mi, so zero usage means
        zero resident pods).  First-seen-idle timestamps persist
        across ticks and clear the moment the node is busy again."""
        idle = self._idle_since
        nodes = self.cluster.nodes
        for pool in self._pools:
            for name in pool.names:
                node = nodes[name]
                if node.provisioned and not node.cpu_used \
                        and not node.mem_used:
                    if name not in idle:
                        idle[name] = now
                else:
                    idle.pop(name, None)

    def _scale_up(self):
        budget = self.policy.scale_step
        flipped = 0
        for pool in self._pools:
            if budget <= 0:
                break
            for name in pool.names:
                if budget <= 0:
                    break
                if not self.cluster.nodes[name].provisioned:
                    self.cluster.provision_node(name)
                    self._idle_since.pop(name, None)
                    budget -= 1
                    flipped += 1
        if flipped:
            self.scale_up_events += 1
            self.nodes_provisioned += flipped

    def _scale_down(self, now: float):
        flipped = 0
        cluster = self.cluster
        for pool in self._pools:
            n_prov = sum(1 for nm in pool.names
                         if cluster.nodes[nm].provisioned)
            for name in reversed(pool.names):
                if n_prov <= pool.min_n or cluster._prov_nodes <= 1:
                    break
                node = cluster.nodes[name]
                if not node.provisioned:
                    continue
                since = self._idle_since.get(name)
                if since is None \
                        or now - since + 1e-9 < self.policy.idle_s:
                    continue
                self.pods_drained += cluster.deprovision_node(name)
                self._idle_since.pop(name, None)
                n_prov -= 1
                flipped += 1
        if flipped:
            self.scale_down_events += 1
            self.nodes_deprovisioned += flipped

    def counters(self) -> dict:
        return {"ticks": self.ticks,
                "scale_up_events": self.scale_up_events,
                "scale_down_events": self.scale_down_events,
                "nodes_provisioned": self.nodes_provisioned,
                "nodes_deprovisioned": self.nodes_deprovisioned,
                "pods_drained": self.pods_drained,
                "managed_nodes": sum(len(p.names) for p in self._pools),
                "floor_nodes": sum(p.min_n for p in self._pools),
                "interval_s": self.policy.interval_s,
                "pending_threshold": self.policy.pending_threshold,
                "sustain_s": self.policy.sustain_s,
                "idle_s": self.policy.idle_s}
