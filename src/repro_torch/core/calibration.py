"""Frozen control-plane latency constants (one global set, all figures).

Derivation (see EXPERIMENTS.md §Calibration): the KubeAdaptor column of
the paper fixes the per-pod overhead budget — avg task-pod execution
time ~12.8s with a 10s stress payload leaves ~2.8s of pod lifecycle
overhead, split between container start (image check + create + NFS
mount) and deletion, with the informer contributing its ~50ms cache
latency. Baseline-specific constants come from the tools' documented
behaviour (kubectl round-trips for Batch Job; Argo's controller
reconcile cadence) and were tuned ONCE against the Montage lifecycle
column only — every other number in EXPERIMENTS.md (other 3 workflows,
task-exec times, resource rates, 100-run totals) is emergent.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ClusterParams:
    # apiserver + informer
    api_latency: float = 0.05          # per CRUD round-trip
    watch_latency: float = 0.02        # apiserver -> watch stream
    informer_latency: float = 0.05     # watch -> local cache + handler
    resync_interval: float = 30.0      # informer periodic resync
    # scheduler (the level-2 "K8s" scheduler: disordered by design)
    sched_cycle: float = 0.08
    # pod lifecycle
    pod_start_latency: float = 1.20    # image-present check + container create
    pvc_mount_latency: float = 0.30    # NFS dynamic-volume mount per pod
    pod_delete_latency: float = 1.15   # container teardown
    # namespace / storage
    ns_create_latency: float = 0.40
    ns_delete_latency: float = 0.60
    pvc_create_latency: float = 0.50   # StorageClass dynamic provisioning
    # Batch Job baseline (kubectl-driven, level-synchronized)
    kubectl_latency: float = 1.20      # CLI spawn + apiserver round-trip
    batch_poll_interval: float = 3.0   # kubectl-get status polling
    batch_pod_poll: float = 0.70       # per-pod status fetch within a poll
    # Argo-like baseline (controller reconcile loop)
    argo_reconcile: float = 7.0        # resync/requeue cadence per step
    argo_controller_overhead: float = 1.0   # DAG processing per cycle
    argo_pod_overhead: float = 0.5     # per-pod template instantiation
    argo_workflow_init: float = 2.0    # CRD submission + controller pickup
    # fault tolerance / stragglers
    max_retries: int = 3
    on_retry_exhausted: str = "raise"   # "raise": RuntimeError tears down the
                                        # whole run (historical behaviour);
                                        # "fail-workflow": mark the workflow
                                        # failed, clean up its namespace, let
                                        # every other workflow finish
    create_retry_backoff: float = 0.25  # wait before re-creating after
                                        # AlreadyExists delete+retry (§4.5);
                                        # avoids hot-looping the apiserver
    preempt_cooldown_s: float = 5.0     # min gap between preemption plans
                                        # per starved tenant (bounds
                                        # eviction churn while a plan's
                                        # deletions are still in flight)
    # transient apiserver faults (chaos plane, ISSUE 7): capped
    # exponential backoff with jitter for retryable "Unavailable"
    # errors on pod create/delete — generalizes the AlreadyExists
    # delete+retry above
    api_fault_backoff_s: float = 0.25   # base delay, doubled per attempt
    api_fault_backoff_max_s: float = 8.0
    max_api_fault_retries: int = 8      # then RuntimeError (outage, not blip)
    straggler_factor: float = 1.5      # speculative copy beyond x expected
    straggler_min_wait: float = 5.0
    # metrics
    sample_period: float = 0.5         # resource usage sampling (paper: 0.5s)


@dataclass(frozen=True)
class PaperCluster:
    """§5.1: 1 master + 6 workers, 8-core/16GB each; master unschedulable."""
    n_nodes: int = 6
    node_cpu_m: int = 8000             # 48000m allocatable total (Fig 9)
    node_mem_mi: int = 15312           # 91872Mi allocatable total (Fig 10)

    def nodes(self) -> Tuple[Tuple[str, int, int], ...]:
        return tuple((f"node{i+1}", self.node_cpu_m, self.node_mem_mi)
                     for i in range(self.n_nodes))


@dataclass(frozen=True)
class NodeClass:
    """One capacity class in a heterogeneous cluster (the K3s-style
    edge-zoo: big/small boxes, cpu- vs mem-skewed shapes).  ``weight``
    is the class's relative share of the node count."""
    name: str
    cpu_m: int
    mem_mi: int
    weight: int = 1


@dataclass(frozen=True)
class HeteroCluster:
    """Heterogeneous cluster config: ``n_nodes`` machines drawn from
    ``classes`` by deterministic weighted round-robin (node ``i`` gets
    the ``i mod cycle``-th entry of the weight-expanded class cycle),
    so a fixed config always yields the same node list and any
    ``dataclasses.replace(cfg, n_nodes=k)`` slice (the shard
    partition) is a prefix-consistent mix of the same classes.

    Drop-in for ``PaperCluster`` everywhere a cluster config is
    consumed: ``nodes()`` has the same shape and the per-node
    capacities flow through ``Cluster`` unchanged (node state, the
    native free/ready mirrors and ``allocatable()`` are all per-node
    already).  Every class must fit the paper task (1200m/1200Mi) or
    its nodes can never bind a pod."""
    n_nodes: int = 6
    classes: Tuple[NodeClass, ...] = (
        NodeClass("big", 16000, 30624, weight=1),
        NodeClass("small", 4000, 7656, weight=2),
    )

    def class_cycle(self) -> Tuple[NodeClass, ...]:
        cycle: Tuple[NodeClass, ...] = ()
        for c in self.classes:
            cycle += (c,) * max(1, c.weight)
        return cycle

    def nodes(self) -> Tuple[Tuple[str, int, int], ...]:
        cycle = self.class_cycle()
        return tuple((f"node{i+1}", cycle[i % len(cycle)].cpu_m,
                      cycle[i % len(cycle)].mem_mi)
                     for i in range(self.n_nodes))

    def mix_label(self) -> str:
        return "+".join(f"{c.name}x{c.weight}({c.cpu_m}m/{c.mem_mi}Mi)"
                        for c in self.classes)


# preset mixes: averages match the uniform paper node (8000m/15312Mi
# per node when n_nodes divides the cycle length), so hetero tiers
# keep total allocatable comparable to the uniform tiers
NODE_MIXES = {
    "big-small": (
        NodeClass("big", 16000, 30624, weight=1),     # 2x paper node
        NodeClass("small", 4000, 7656, weight=2),     # paper node / 2
    ),
    "cpu-mem-skew": (
        NodeClass("cpu-heavy", 12000, 7656, weight=1),
        NodeClass("mem-heavy", 4000, 22968, weight=1),
    ),
}


def hetero_cluster(n_nodes: int, mix: str = "big-small") -> HeteroCluster:
    """A preset heterogeneous config (see ``NODE_MIXES``)."""
    if mix not in NODE_MIXES:
        raise ValueError(f"unknown node mix {mix!r}; "
                         f"expected one of {sorted(NODE_MIXES)}")
    return HeteroCluster(n_nodes=n_nodes, classes=NODE_MIXES[mix])


def node_class_names(cfg) -> Tuple[str, ...]:
    """Per-node class name for any cluster config, in roster order:
    hetero configs follow the weighted round-robin ``class_cycle``
    (so any prefix slice — the shard partition — keeps consistent
    labels), uniform configs collapse to a single ``"node"`` class.
    The autoscaler's derived node pools group the roster by these."""
    n = cfg.n_nodes
    if hasattr(cfg, "class_cycle"):
        cycle = cfg.class_cycle()
        return tuple(cycle[i % len(cycle)].name for i in range(n))
    return ("node",) * n


# Paper workload: stress -c 1 -m 100 -t 5 -> CPU+mem busy ~10s total,
# requests = limits = 1200m / 1200Mi.
TASK_DURATION_S = 10.0
TASK_CPU_M = 1200
TASK_MEM_MI = 1200

DEFAULT_PARAMS = ClusterParams()
DEFAULT_CLUSTER = PaperCluster()
