"""Sharded multi-process control plane (ISSUE 6).

One event loop tops out around 10^5 workflows: PR 5's 100k tier runs a
single ``Sim`` at ~8k events/s and ~1.8 GiB RSS.  The 1M-workflow
target partitions the *control plane itself*: tenants are hashed onto
N arbiter shards, each shard owns a disjoint slice of the cluster's
nodes and runs a complete stack — ``Sim`` loop, informers, admission
arbiter, gateway — in a forked worker process.  Shards share nothing
at runtime; results return over the pool's result pipe as compact
picklable records (``MetricsPartial`` + scalar counters), and the
parent merges them into global summaries via the mergeable stats
layer (``core/stats``, ``core/metrics``).

Determinism:

* ``shard_of(tenant, workers) = crc32(tenant) % workers`` — a stable,
  documented hash (NOT Python's randomized ``hash``), so a tenant
  lands on the same shard in every process and on every run.
* ``shard_seed(root, i)`` spawns each shard's RNG seed from the root
  seed by sha256 — shards are decorrelated but fully reproducible,
  and no seed depends on wallclock, pid, or worker scheduling.
* ``processes=False`` runs the same per-shard function sequentially
  in-process; by construction it is bit-identical to the multi-process
  mode (pinned by tests/test_shard_plane.py), which makes the fork
  path testable without fork-sensitive asserts.

Failure recovery (ISSUE 7): the PR-6 fork path was a blocking
``Pool.map`` — a worker dying mid-shard (OOM kill, segfault, spot
reclaim of the parent's host) hung the parent forever.  Workers now
run as individual ``Process``es reporting over one-way pipes: a
heartbeat thread proves liveness, exceptions serialize back as
structured error messages, and the parent detects dead processes,
stale heartbeats and a global join timeout.  ``on_shard_failure``
picks the policy: ``"raise"`` surfaces a ``ShardFailure`` naming the
shard and its tenants; ``"restart"`` respawns the shard from its
recorded spec (same tenant partition, same spawned seed — the rerun
is deterministic, so the merged result is unchanged); ``"degrade"``
merges the surviving shards and flags the result ``degraded=True``
with the failure manifest.  Chaos schedules fan out with the same
spawning discipline: ``ChaosSchedule.spawn(i)`` derives each shard's
decorrelated chaos stream, and per-shard chaos counters merge by
summation (``ShardedRunResult.chaos_counters``).

Throughput accounting on a sharded run: shards execute in waves of
``shard_procs`` OS processes (default ``os.cpu_count()``), so each
event loop runs unoversubscribed.  The aggregate ``events_per_sec``
is Σ shard events / max(shard loop wall) — the standard weak-scaling
aggregate ("N unoversubscribed loops side by side"); per-shard rows
and the true end-to-end ``wall_s`` are always reported alongside so
the definition is transparent, and ``loop_cpu_s`` gives the
CPU-second basis.
"""
from __future__ import annotations

import hashlib
import os
import zlib
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.core import calibration as cal
from repro_torch.core.chaos import ChaosSchedule
from repro_torch.core.autoscaler import AutoscalePolicy
from repro_torch.core.descheduler import DeschedulePolicy
from repro_torch.core.gateway import BackpressurePolicy, merge_gateway_snapshots
from repro_torch.core.metrics import MetricsPartial
from repro_torch.core.runner import ControlPlane
from repro_torch.core.stats import StreamingStat

__all__ = ["shard_of", "shard_seed", "partition_nodes", "ShardSpec",
           "ShardFailure", "ShardedControlPlane", "ShardedRunResult"]


class ShardFailure(RuntimeError):
    """A shard worker failed (died, raised, or timed out).  Structured:
    names the shard, the tenants stranded on it, and the reason — the
    base signal for the restart/degrade recovery modes."""

    def __init__(self, shard: int, tenants: List[str], reason: str):
        self.shard = shard
        self.tenants = list(tenants)
        self.reason = reason
        super().__init__(
            f"shard {shard} failed ({reason}); stranded tenants: "
            f"{', '.join(self.tenants) or '(none)'}")


def shard_of(tenant: str, workers: int) -> int:
    """Deterministic tenant -> shard index (stable across processes)."""
    if workers <= 1:
        return 0
    return zlib.crc32(tenant.encode("utf-8")) % workers


def shard_seed(root_seed: int, index: int) -> int:
    """Spawn shard ``index``'s seed from the root seed (sha256-based:
    decorrelated streams, no wallclock/pid dependence)."""
    digest = hashlib.sha256(
        f"repro-shard/{root_seed}/{index}".encode("ascii")).digest()
    return int.from_bytes(digest[:8], "big")


def partition_nodes(n_nodes: int, workers: int) -> List[int]:
    """Disjoint node-slice sizes per shard (first shards absorb the
    remainder; sums to ``n_nodes``)."""
    base, rem = divmod(n_nodes, workers)
    return [base + (1 if i < rem else 0) for i in range(workers)]


@dataclass
class ShardSpec:
    """Everything one worker process needs to build and run its shard
    (picklable: crosses the pool task pipe)."""
    index: int
    workers: int
    seed: int
    n_nodes: int
    engine_name: str = "kubeadaptor"
    params: cal.ClusterParams = None
    cluster_cfg: cal.PaperCluster = None      # template; n_nodes overrides
    payload_mode: str = "virtual"
    speculative: bool = False
    scheduler: str = "topological"
    admission_policy: str = "fifo"
    sample_resources: bool = True
    sample_mode: str = "full"
    usage_mode: str = "sampled"
    retain_pod_log: bool = True
    lifecycle: Optional[str] = None
    queue: Optional[str] = None
    fold_completed: bool = False
    capture_trace: bool = True
    streams: List[dict] = field(default_factory=list)
    trace_records: List[dict] = field(default_factory=list)
    trace_tenants: Dict[str, dict] = field(default_factory=dict)
    horizon_s: float = 500_000.0
    record_bindings: bool = False
    profile: bool = False
    chaos: Optional[ChaosSchedule] = None     # already spawned per shard
    placement: str = "first-fit"              # scatter-cycle node pick
    deschedule: Optional[DeschedulePolicy] = None  # per-shard daemon
    autoscale: Optional[AutoscalePolicy] = None    # already spawned per shard
    # durable submission front door (ISSUE 10): same frozen policy on
    # every shard (the gate stream seed decorrelates); wal_dir arms the
    # per-shard file sink ({wal_dir}/shard-{index}.wal) so a restarted
    # incarnation replays its own submission log with exactly-once dedup
    gateway: Optional[BackpressurePolicy] = None
    wal_dir: Optional[str] = None


def _spec_tenants(spec: ShardSpec) -> List[str]:
    """Tenants routed to this shard (for ShardFailure manifests)."""
    tenants = {s["tenant"] for s in spec.streams}
    tenants.update(r["tenant"] for r in spec.trace_records)
    tenants.update(spec.trace_tenants)
    return sorted(tenants)


def _build_shard_plane(spec: ShardSpec) -> ControlPlane:
    params = spec.params if spec.params is not None else cal.DEFAULT_PARAMS
    cfg = spec.cluster_cfg if spec.cluster_cfg is not None \
        else cal.DEFAULT_CLUSTER
    plane = ControlPlane(
        spec.engine_name, params=params,
        cluster_cfg=replace(cfg, n_nodes=spec.n_nodes),
        payload_mode=spec.payload_mode, seed=spec.seed,
        speculative=spec.speculative, scheduler=spec.scheduler,
        admission_policy=spec.admission_policy,
        sample_resources=spec.sample_resources,
        sample_mode=spec.sample_mode, usage_mode=spec.usage_mode,
        retain_pod_log=spec.retain_pod_log, lifecycle=spec.lifecycle,
        queue=spec.queue, fold_completed=spec.fold_completed,
        capture_trace=spec.capture_trace, chaos=spec.chaos,
        placement=spec.placement, deschedule=spec.deschedule,
        autoscale=spec.autoscale, gateway=spec.gateway,
        wal_path=(os.path.join(spec.wal_dir, f"shard-{spec.index}.wal")
                  if spec.wal_dir and spec.gateway is not None else None),
        shard_index=spec.index)
    for stream in spec.streams:
        plane.add_stream(**stream)
    if spec.trace_records:
        plane.add_trace(spec.trace_records, tenants=spec.trace_tenants)
    return plane


def _run_shard(spec: ShardSpec, die_at: Optional[float] = None) -> dict:
    """Build, run, and compact one shard.  Runs in a forked worker
    (``processes=True``) or inline (``processes=False``) — identical
    code path either way, so the two modes are bit-identical by
    construction for everything the sim computes.

    ``die_at`` (forked test hook, REPRO_SHARD_KILL=<i>@<t>): hard-exit
    at virtual time ``t`` — a mid-run SIGKILL that leaves a partially
    written WAL behind for the restarted incarnation to replay."""
    import resource as _resource
    import time as _time

    import repro_torch.core.cluster as _cluster_mod

    plane = _build_shard_plane(spec)
    if die_at is not None:
        plane.sim.at(die_at, lambda: os._exit(42), daemon=True,
                     note="test:shard-kill")

    bindings: List[Tuple[str, str]] = []
    if spec.record_bindings:
        inner = plane.cluster._bind

        def recording_bind(pod, node):
            bindings.append((pod.tenant,
                             f"{pod.namespace}/{pod.name}->{node.name}"
                             f"@{plane.sim.now():.4f}"))
            return inner(pod, node)

        plane.cluster._bind = recording_bind

    copies0 = _cluster_mod.SNAPSHOTS_MADE
    profiler = None
    if spec.profile:
        import cProfile
        profiler = cProfile.Profile()
        profiler.enable()
    t0 = _time.perf_counter()
    res = plane.run(horizon_s=spec.horizon_s)
    wall = _time.perf_counter() - t0
    profile_text = None
    if profiler is not None:
        import io
        import pstats
        profiler.disable()
        buf = io.StringIO()
        pstats.Stats(profiler, stream=buf).sort_stats(
            "cumulative").print_stats(20)
        profile_text = buf.getvalue()

    partial = res.metrics.export_partial()
    record = {
        "shard": spec.index,
        "seed": spec.seed,
        "nodes": spec.n_nodes,
        "tenants": sorted(partial.tenant_aggs),
        "wall_s": wall,
        "loop_wall_s": res.sim.run_wall_s,
        "loop_cpu_s": getattr(res.sim, "run_cpu_s", 0.0),
        "last_event_t": res.sim.last_event_t,
        "events": res.sim.events_processed,
        "pods_created": getattr(res.cluster, "pods_created", 0),
        "api_calls": res.cluster.api_calls,
        "informer_copies": _cluster_mod.SNAPSHOTS_MADE - copies0,
        "peak_pending_pods": getattr(res.cluster, "max_pending_pods", 0),
        "queue": res.sim.queue_name,
        "usage_mode": res.metrics.usage_mode,
        "lifecycle": getattr(res.cluster, "lifecycle", "chained"),
        "completed_workflows": partial.completed,
        "failed_workflows": partial.failed,
        "arbiter": (res.arbiter.counters()
                    if res.arbiter is not None else {}),
        "chaos": (res.chaos.counters() if res.chaos is not None else None),
        # placement observables (ISSUE 8): per-shard hotspot profile
        # (merged exactly by ShardedRunResult.hotspot_summary) plus
        # descheduler accounting when the daemon was armed
        "node_hotspot": res.cluster.hotspot_summary(),
        "rebalances": getattr(res.cluster, "rebalances", 0),
        "descheduler": (res.descheduler.counters()
                        if res.descheduler is not None else None),
        # provisioned-capacity cost accounting (ISSUE 9): always
        # recorded (fixed rosters report flat provisioning); merged
        # exactly by ShardedRunResult.cost_summary
        "cost": res.cluster.cost_summary(),
        "autoscaler": (res.autoscaler.counters()
                       if res.autoscaler is not None else None),
        # durable front door (ISSUE 10): per-shard qstat snapshot
        # (merged exactly by ShardedRunResult.gateway_summary)
        "gateway": (res.gate.snapshot() if res.gate is not None else None),
        # per-process high-water mark: each worker process runs exactly
        # one shard, so this is the shard's own RSS
        "peak_rss_mib": _resource.getrusage(
            _resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        "metrics_partial": partial,
        "exec_stat": getattr(res.cluster, "exec_stat", None),
        "profile": profile_text,
        "bindings": bindings if spec.record_bindings else None,
    }
    if res.gate is not None:
        res.gate.close()
    return record


def _shard_worker_main(spec: ShardSpec, conn, heartbeat_s: float,
                       die: bool = False) -> None:
    """Forked worker entrypoint: run one shard, stream liveness.

    A daemon thread sends ``("heartbeat", index)`` every
    ``heartbeat_s`` (the sim loop's pure-Python stretches yield the GIL
    every switch interval and the native scheduler releases it outright,
    so beats flow while the shard computes).  The shard's result or a
    serialized exception goes back over the same pipe — the parent
    never blocks on a silent worker again.  ``die`` is the test hook
    (REPRO_SHARD_KILL): ``True`` hard-exits before running (simulated
    SIGKILL at launch); a float hard-exits at that virtual time
    mid-run (the WAL-replay crash scenario).
    """
    import threading
    import traceback as _traceback

    die_at = die if isinstance(die, float) else None
    if die is True:
        os._exit(42)

    lock = threading.Lock()
    stop = threading.Event()

    def beat():
        while not stop.wait(heartbeat_s):
            with lock:
                try:
                    conn.send(("heartbeat", spec.index))
                except OSError:
                    return

    threading.Thread(target=beat, daemon=True).start()
    try:
        record = _run_shard(spec, die_at=die_at)
    except BaseException as exc:
        stop.set()
        with lock:
            try:
                conn.send(("error", {
                    "shard": spec.index,
                    "exc_type": type(exc).__name__,
                    "message": str(exc),
                    "traceback": _traceback.format_exc(),
                }))
            except OSError:
                pass
        os._exit(1)
    stop.set()
    with lock:
        conn.send(("result", record))
    conn.close()


@dataclass
class ShardedRunResult:
    """Merged view over the shard records.

    ``shards`` keeps every per-shard record (ordered by shard index);
    scalar totals are sums across shards, pending peaks are maxima,
    ``metrics`` is the merged ``MetricsPartial`` (global
    ``tenant_summary()`` / ``usage_summary()``), ``exec_stat`` the
    merged pod-execution stat.  ``loop_wall_s`` is the max shard loop
    wall (the weak-scaling denominator — see module docstring);
    ``wall_s`` is the parent's true end-to-end wall.

    ``degraded`` is True when ``on_shard_failure="degrade"`` merged a
    partial fleet; ``failures`` lists the dropped shards
    (``{"shard", "tenants", "reason", "restarts"}``).
    """
    workers: int
    shards: List[dict]
    metrics: MetricsPartial
    exec_stat: Optional[StreamingStat]
    wall_s: float
    degraded: bool = False
    failures: List[dict] = field(default_factory=list)

    @property
    def events(self) -> int:
        return sum(s["events"] for s in self.shards)

    @property
    def pods_created(self) -> int:
        return sum(s["pods_created"] for s in self.shards)

    @property
    def api_calls(self) -> int:
        return sum(s["api_calls"] for s in self.shards)

    @property
    def informer_copies(self) -> int:
        return sum(s["informer_copies"] for s in self.shards)

    @property
    def completed_workflows(self) -> int:
        return sum(s["completed_workflows"] for s in self.shards)

    @property
    def failed_workflows(self) -> int:
        return sum(s["failed_workflows"] for s in self.shards)

    @property
    def loop_wall_s(self) -> float:
        return max((s["loop_wall_s"] for s in self.shards), default=0.0)

    @property
    def loop_cpu_s(self) -> float:
        return sum(s["loop_cpu_s"] for s in self.shards)

    @property
    def sim_makespan_s(self) -> float:
        return max((s["last_event_t"] for s in self.shards), default=0.0)

    @property
    def events_per_sec(self) -> float:
        lw = self.loop_wall_s
        return self.events / lw if lw > 0 else 0.0

    @property
    def peak_pending_pods(self) -> int:
        return max((s["peak_pending_pods"] for s in self.shards), default=0)

    @property
    def peak_pending_admission(self) -> int:
        return max((s["arbiter"].get("max_pending", 0)
                    for s in self.shards), default=0)

    @property
    def peak_pending_gateway(self) -> int:
        return max((s["gateway"]["peak_pending"]
                    for s in self.shards if s.get("gateway")), default=0)

    @property
    def peak_shard_rss_mib(self) -> float:
        return max((s["peak_rss_mib"] for s in self.shards), default=0.0)

    def arbiter_totals(self) -> Dict[str, int]:
        """Summed arbiter counters (max_pending is a per-shard peak and
        is excluded here — read ``peak_pending_admission``)."""
        out: Dict[str, int] = {}
        for s in self.shards:
            for key, val in s["arbiter"].items():
                if key == "max_pending":
                    continue
                out[key] = out.get(key, 0) + val
        return out

    def chaos_counters(self) -> Dict[str, float]:
        """Summed chaos counters across shards (empty dict when no
        shard ran with a chaos schedule) — exactly mergeable because
        every counter is a per-shard sum."""
        out: Dict[str, float] = {}
        for s in self.shards:
            c = s.get("chaos")
            if not c:
                continue
            for key, val in c.items():
                out[key] = out.get(key, 0) + val
        return out

    @property
    def rebalances(self) -> int:
        return sum(s.get("rebalances", 0) for s in self.shards)

    def descheduler_counters(self) -> Dict[str, float]:
        """Summed descheduler counters across shards (empty dict when
        no shard armed a daemon).  Config echoes (interval/threshold)
        are identical per shard, so keeping the last value is exact."""
        out: Dict[str, float] = {}
        for s in self.shards:
            c = s.get("descheduler")
            if not c:
                continue
            for key, val in c.items():
                if key in ("interval_s", "util_threshold", "victim"):
                    out[key] = val
                else:
                    out[key] = out.get(key, 0) + val
        return out

    def cost_summary(self) -> Dict[str, float]:
        """Exact merge of the per-shard provisioned-capacity costs:
        the shards' rosters are disjoint slices of the whole cluster,
        so area integrals and flip counts add, peaks/lows add too
        (each shard's extremum is over its own slice — concurrent
        daemon ticks make the cluster-wide extremum the sum), and the
        utilization-over-provisioned ratios are recomputed from the
        pooled areas."""
        acc: Dict[str, float] = {}
        sum_keys = ("node_seconds", "cpu_mcore_seconds", "mem_mib_seconds",
                    "used_cpu_mcore_seconds", "used_mem_mib_seconds",
                    "provisioned_peak_nodes", "provisioned_low_nodes",
                    "provision_flips")
        for s in self.shards:
            c = s.get("cost")
            if not c:
                continue
            for key in sum_keys:
                acc[key] = acc.get(key, 0.0) + c.get(key, 0.0)
        if not acc:
            return {}
        cpu_s = acc.get("cpu_mcore_seconds", 0.0)
        mem_s = acc.get("mem_mib_seconds", 0.0)
        acc["cpu_util_over_provisioned"] = (
            acc.get("used_cpu_mcore_seconds", 0.0) / cpu_s
            if cpu_s > 0 else 0.0)
        acc["mem_util_over_provisioned"] = (
            acc.get("used_mem_mib_seconds", 0.0) / mem_s
            if mem_s > 0 else 0.0)
        return acc

    def autoscaler_counters(self) -> Dict[str, float]:
        """Summed autoscaler counters across shards (empty dict when
        no shard armed a daemon).  Config echoes are identical per
        shard, so keeping the last value is exact."""
        out: Dict[str, float] = {}
        for s in self.shards:
            c = s.get("autoscaler")
            if not c:
                continue
            for key, val in c.items():
                if key in ("interval_s", "pending_threshold",
                           "sustain_s", "idle_s"):
                    out[key] = val
                else:
                    out[key] = out.get(key, 0) + val
        return out

    def hotspot_summary(self) -> Dict[str, float]:
        """Exact merge of the per-shard utilization profiles: the
        union of shards is the whole cluster, so mean/variance combine
        by the standard pooled-population identities and max/min by
        max/min (both the peak and the time-weighted mean axes)."""
        total_n = 0
        acc = {"peak": [0.0, 0.0, 0.0, float("inf")],
               "util": [0.0, 0.0, 0.0, float("inf")]}
        keys = {"peak": ("mean_peak_util", "peak_util_variance",
                         "max_peak_util", "min_peak_util"),
                "util": ("mean_util", "util_variance",
                         "max_mean_util", "min_mean_util")}
        for s in self.shards:
            h = s.get("node_hotspot")
            if not h or not h.get("nodes"):
                continue
            n = h["nodes"]
            total_n += n
            for ax, (mk, vk, xk, nk) in keys.items():
                a = acc[ax]
                a[0] += n * h[mk]
                a[1] += n * (h[vk] + h[mk] ** 2)
                a[2] = max(a[2], h[xk])
                a[3] = min(a[3], h[nk])
        out = {"nodes": total_n}
        for ax, (mk, vk, xk, nk) in keys.items():
            a = acc[ax]
            if not total_n:
                out.update({mk: 0.0, vk: 0.0, xk: 0.0, nk: 0.0})
                continue
            mean = a[0] / total_n
            out[mk] = mean
            out[vk] = max(0.0, a[1] / total_n - mean * mean)
            out[xk] = a[2]
            out[nk] = a[3]
        return out

    def gateway_summary(self) -> dict:
        """Merged qstat snapshot across shards (empty dict when no
        shard armed a gateway) — exact by construction: counters and
        gauges sum over the disjoint tenant partition, per-shard peaks
        and the retry horizon take the max."""
        return merge_gateway_snapshots(
            s.get("gateway") for s in self.shards)

    def recovery_summary(self) -> Dict[str, float]:
        """Merged disruption/recovery accounting (see
        ``MetricsPartial.recovery_summary``)."""
        return self.metrics.recovery_summary()

    def tenant_summary(self) -> Dict[str, Dict[str, float]]:
        return self.metrics.tenant_summary()

    def usage_summary(self) -> Dict[str, Dict[str, float]]:
        return self.metrics.usage_summary()

    def bindings(self) -> Dict[str, List[str]]:
        """Per-tenant binding sequences (``record_bindings=True`` runs
        only) — shard-internal order preserved per tenant."""
        out: Dict[str, List[str]] = {}
        for s in self.shards:
            if not s["bindings"]:
                continue
            for tenant, line in s["bindings"]:
                out.setdefault(tenant, []).append(line)
        return out


class ShardedControlPlane:
    """Tenant-partitioned fan-out of ``ControlPlane``.

    Mirrors the ``ControlPlane`` builder API (``add_stream`` /
    ``add_trace`` / ``run``), but each tenant's streams land on shard
    ``shard_of(tenant, workers)``; each shard gets a disjoint node
    slice (``partition_nodes``), its own spawned seed, and a full
    independent stack in a forked worker (``processes=True``) or run
    inline sequentially (``processes=False`` — bit-identical, for
    tests).  ``workers=1`` callers should use ``ControlPlane``
    directly; this class still accepts it (single shard, full
    cluster) for uniform benchmark plumbing.
    """

    def __init__(self, workers: int,
                 engine_name: str = "kubeadaptor",
                 params: cal.ClusterParams = cal.DEFAULT_PARAMS,
                 cluster_cfg: cal.PaperCluster = cal.DEFAULT_CLUSTER,
                 payload_mode: str = "virtual", seed: int = 0,
                 speculative: bool = False,
                 scheduler: str = "topological",
                 admission_policy: str = "fifo",
                 sample_resources: bool = True,
                 sample_mode: str = "full",
                 usage_mode: str = "sampled",
                 retain_pod_log: bool = True,
                 lifecycle: Optional[str] = None,
                 queue: Optional[str] = None,
                 fold_completed: bool = False,
                 capture_trace: bool = True,
                 processes: bool = True,
                 shard_procs: Optional[int] = None,
                 record_bindings: bool = False,
                 profile: bool = False,
                 chaos: Optional[ChaosSchedule] = None,
                 placement: str = "first-fit",
                 deschedule: Optional[DeschedulePolicy] = None,
                 autoscale: Optional[AutoscalePolicy] = None,
                 gateway: Optional[BackpressurePolicy] = None,
                 wal_dir: Optional[str] = None,
                 on_shard_failure: str = "raise",
                 shard_timeout_s: Optional[float] = None,
                 heartbeat_s: float = 2.0,
                 heartbeat_timeout_s: float = 60.0,
                 max_shard_restarts: int = 1):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if cluster_cfg.n_nodes < workers:
            raise ValueError(f"{cluster_cfg.n_nodes} nodes cannot be "
                             f"sliced across {workers} shards")
        if on_shard_failure not in ("raise", "restart", "degrade"):
            raise ValueError(f"unknown on_shard_failure "
                             f"{on_shard_failure!r}; expected "
                             f"'raise', 'restart', or 'degrade'")
        if wal_dir is not None and gateway is None:
            raise ValueError("wal_dir requires a gateway policy")
        self.workers = workers
        self.processes = processes
        self.shard_procs = shard_procs
        self.on_shard_failure = on_shard_failure
        self.shard_timeout_s = shard_timeout_s
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.max_shard_restarts = max_shard_restarts
        slices = partition_nodes(cluster_cfg.n_nodes, workers)
        self.specs = [ShardSpec(
            index=i, workers=workers, seed=shard_seed(seed, i),
            n_nodes=slices[i], engine_name=engine_name, params=params,
            cluster_cfg=cluster_cfg, payload_mode=payload_mode,
            speculative=speculative, scheduler=scheduler,
            admission_policy=admission_policy,
            sample_resources=sample_resources, sample_mode=sample_mode,
            usage_mode=usage_mode, retain_pod_log=retain_pod_log,
            lifecycle=lifecycle, queue=queue,
            fold_completed=fold_completed, capture_trace=capture_trace,
            record_bindings=record_bindings, profile=profile,
            chaos=chaos.spawn(i) if chaos is not None else None,
            placement=placement, deschedule=deschedule,
            autoscale=(autoscale.spawn(i, workers)
                       if autoscale is not None else None),
            gateway=gateway, wal_dir=wal_dir)
            for i in range(workers)]

    # -- tenancy knobs (ControlPlane API, routed by tenant hash) ----------
    def add_stream(self, workflow, repeats: int = 1,
                   tenant: str = "default", arrival: str = "serial",
                   concurrency: int = 1, rate: float = 1.0, burst: int = 1,
                   priority: int = 0, weight: float = 1.0,
                   quota_cpu_m: int = 0, quota_mem_mi: int = 0,
                   deadline_s: float = 0.0) -> int:
        """Register one tenant workload; returns the owning shard."""
        shard = shard_of(tenant, self.workers)
        self.specs[shard].streams.append(dict(
            workflow=workflow, repeats=repeats, tenant=tenant,
            arrival=arrival, concurrency=concurrency, rate=rate,
            burst=burst, priority=priority, weight=weight,
            quota_cpu_m=quota_cpu_m, quota_mem_mi=quota_mem_mi,
            deadline_s=deadline_s))
        return shard

    def add_trace(self, records, tenants: Optional[dict] = None):
        """Partition an arrival trace by tenant hash (record order is
        preserved within each shard)."""
        tenants = tenants or {}
        for rec in records:
            shard = shard_of(rec["tenant"], self.workers)
            self.specs[shard].trace_records.append(rec)
        for name, share in tenants.items():
            self.specs[shard_of(name, self.workers)].trace_tenants[name] = \
                share
        return self

    # -- execution --------------------------------------------------------
    def run(self, horizon_s: float = 500_000.0) -> ShardedRunResult:
        import time as _time
        for spec in self.specs:
            spec.horizon_s = horizon_s
        t0 = _time.perf_counter()
        if self.processes and self.workers > 1:
            records, failures = self._run_forked()
        else:
            records, failures = self._run_inline()
        wall = _time.perf_counter() - t0
        records.sort(key=lambda r: r["shard"])

        merged = MetricsPartial()
        exec_stat: Optional[StreamingStat] = None
        for rec in records:
            merged.merge(rec["metrics_partial"])
            st = rec["exec_stat"]
            if st is not None:
                if exec_stat is None:
                    exec_stat = StreamingStat()
                exec_stat.merge(st)
        return ShardedRunResult(workers=self.workers, shards=records,
                                metrics=merged, exec_stat=exec_stat,
                                wall_s=wall, degraded=bool(failures),
                                failures=failures)

    def _failure_info(self, index: int, reason: str,
                      restarts: int) -> dict:
        return {"shard": index,
                "tenants": _spec_tenants(self.specs[index]),
                "reason": reason, "restarts": restarts}

    def _run_inline(self) -> Tuple[List[dict], List[dict]]:
        """Sequential in-process execution with the same
        ``on_shard_failure`` policy as the fork path.  Restarting a
        deterministic in-process exception will fail again (documented
        — restart is for environmental deaths, which only the fork
        path can exhibit), after which the policy falls through to
        raise."""
        records: List[dict] = []
        failures: List[dict] = []
        for spec in self.specs:
            attempt = 0
            while True:
                try:
                    records.append(_run_shard(spec))
                    break
                except Exception as exc:
                    reason = f"{type(exc).__name__}: {exc}"
                    if (self.on_shard_failure == "restart"
                            and attempt < self.max_shard_restarts):
                        attempt += 1
                        continue
                    if self.on_shard_failure == "degrade":
                        failures.append(self._failure_info(
                            spec.index, reason, attempt))
                        break
                    raise ShardFailure(spec.index, _spec_tenants(spec),
                                       reason) from exc
        return records, failures

    def _run_forked(self) -> Tuple[List[dict], List[dict]]:
        """Fan the shard specs out as one ``Process`` per shard (waves
        of ``shard_procs``, so no loop is oversubscribed), supervised
        over one-way pipes.  A shard fails when its worker sends an
        error, dies without a result, goes heartbeat-silent for
        ``heartbeat_timeout_s``, or the global ``shard_timeout_s``
        join deadline passes — then ``on_shard_failure`` decides:
        raise ShardFailure, respawn the same spec (deterministic, so
        the merged result is unchanged), or drop the shard and merge
        the survivors flagged degraded."""
        import multiprocessing as mp
        import time as _time
        from multiprocessing import connection as mp_conn

        ctx = mp.get_context("fork")
        wave = min(self.shard_procs or os.cpu_count() or 1, self.workers)
        kill_env = os.environ.get("REPRO_SHARD_KILL")
        kill_shard, _, _kill_t = (kill_env or "").partition("@")
        kill_at = float(_kill_t) if _kill_t else None
        deadline = (_time.monotonic() + self.shard_timeout_s
                    if self.shard_timeout_s is not None else None)

        todo = list(range(self.workers))
        restarts: Dict[int, int] = {}
        live: Dict[int, list] = {}      # index -> [proc, conn, last_beat]
        records: Dict[int, dict] = {}
        failures: List[dict] = []

        def launch(i: int) -> None:
            parent, child = ctx.Pipe(duplex=False)
            # REPRO_SHARD_KILL=<index>[@<t>] (test hook): the shard's
            # first incarnation hard-exits — pre-run (simulated SIGKILL
            # at launch), or at virtual time <t> mid-run (leaving a
            # torn WAL for the restart to replay).  Restarted
            # incarnations survive, so restart is testable.
            die: object = kill_shard == str(i) and not restarts.get(i)
            if die and kill_at is not None:
                die = kill_at
            proc = ctx.Process(target=_shard_worker_main,
                               args=(self.specs[i], child,
                                     self.heartbeat_s, die))
            proc.start()
            child.close()
            live[i] = [proc, parent, _time.monotonic()]

        def reap(i: int) -> None:
            proc, conn, _ = live.pop(i)
            try:
                conn.close()
            except OSError:
                pass
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=10.0)

        def handle_failure(i: int, reason: str) -> None:
            reap(i)
            n = restarts.get(i, 0)
            if (self.on_shard_failure == "restart"
                    and n < self.max_shard_restarts):
                restarts[i] = n + 1
                todo.insert(0, i)
                return
            info = self._failure_info(i, reason, n)
            if self.on_shard_failure == "degrade":
                failures.append(info)
                return
            for j in list(live):
                reap(j)
            raise ShardFailure(i, info["tenants"], reason)

        def drain(i: int) -> Optional[str]:
            """Pull pending messages off shard i's pipe; returns a
            failure reason, or None while healthy / once its result
            landed (a dead worker's buffered result still counts)."""
            proc, conn, _ = live[i]
            try:
                while conn.poll():
                    msg = conn.recv()
                    if msg[0] == "heartbeat":
                        live[i][2] = _time.monotonic()
                    elif msg[0] == "result":
                        records[i] = msg[1]
                        reap(i)
                        return None
                    elif msg[0] == "error":
                        return (f"{msg[1]['exc_type']}: "
                                f"{msg[1]['message']}")
            except (EOFError, OSError):
                return (f"worker died without result "
                        f"(exit code {proc.exitcode})")
            return None

        while todo or live:
            while todo and len(live) < wave:
                launch(todo.pop(0))
            conns = {entry[1]: i for i, entry in live.items()}
            for conn in mp_conn.wait(list(conns),
                                     timeout=min(1.0, self.heartbeat_s)):
                i = conns[conn]
                if i not in live:
                    continue
                reason = drain(i)
                if reason is not None:
                    handle_failure(i, reason)
            now = _time.monotonic()
            for i in list(live):
                proc, _, last = live[i]
                if not proc.is_alive():
                    reason = drain(i) if i in live else None
                    if i in live:       # no buffered result salvaged it
                        handle_failure(
                            i, reason or f"worker died without result "
                                         f"(exit code {proc.exitcode})")
                elif now - last > self.heartbeat_timeout_s:
                    handle_failure(
                        i, f"no heartbeat for "
                           f"{self.heartbeat_timeout_s:.0f}s")
            if deadline is not None and _time.monotonic() > deadline:
                for i in list(live):
                    handle_failure(
                        i, f"shard join timeout "
                           f"({self.shard_timeout_s:.0f}s)")
                while todo:             # never-launched shards at deadline
                    i = todo.pop()
                    info = self._failure_info(
                        i, "not started before shard join timeout",
                        restarts.get(i, 0))
                    if self.on_shard_failure == "degrade":
                        failures.append(info)
                    else:
                        for j in list(live):
                            reap(j)
                        raise ShardFailure(i, info["tenants"],
                                           info["reason"])
        return [records[i] for i in sorted(records)], failures
