"""Metrics: pod timelines, workflow lifecycles, resource-usage sampling.

Definitions follow the paper exactly:
  * task-pod execution time  = pod deletion - pod creation (Fig 7),
  * workflow lifecycle       = namespace creation -> namespace deletion
                               (Fig 8: "from creation to death of the
                               workflow namespace"),
  * resource usage rate      = requested(running pods) / allocatable,
                               sampled every 0.5 s (Figs 9-14),
  * order consistency        = pod start order is a topological
                               linearization of the DAG (Fig 6).

Multi-tenant extensions (beyond-paper): every record carries its
tenant; ``note_submitted`` timestamps gateway hand-off so queueing
delay (submission -> namespace creation) is measurable; the sampler
also breaks bound node usage down per tenant; ``tenant_summary``
aggregates makespan / queueing delay / lifecycle / admission
deferrals per tenant for the multi-tenant benchmarks — plus, with the
admission pipeline (ISSUE 4), per-tenant quota-reject counts,
preempted-pod counts, and the per-stream SLO: ``set_tenant_deadline``
registers a deadline and the summary reports its hit-rate over
completed workflows (submission -> namespace teardown).

Scale tier (ISSUE 2): ``sample_mode="streaming"`` replaces the
unbounded per-sample lists with flat-memory accumulators
(``core/stats.StreamingStat``: count/mean/max + fixed reservoir for
percentiles) — at 1000 workflows the sampler would otherwise grow
without bound. Paper-scale runs keep the default ``"full"`` mode, so
``samples``/``usage_rate_over`` behave exactly as before.

Event-driven usage accounting (ISSUE 3): the 0.5 s sampler is a
polling daemon — 1801 sim events per 900 s run, scaling with sim time
rather than load, and only ever an approximation of the underlying
step function.  ``usage_mode="event"`` drops the daemon entirely: the
cluster fires ``on_usage_change`` at every bind/release and the
collector keeps exact ``StepAccumulator``s (cluster cpu/mem + per
tenant), from which mean/peak/p95 rates are derived in closed form via
``usage_summary()``.  The default stays ``"sampled"`` (both
``sample_mode`` flavours unchanged); tests pin that the two modes
agree on mean/peak and that removing the daemon moves no scheduling
decision.

Sharded control plane (ISSUE 6): per-tenant aggregation is
*foldable* and *mergeable*.  ``fold_completed=True`` collapses each
``WorkflowRecord`` into a compact per-tenant ``TenantAgg`` the moment
its namespace is deleted (O(tenants) memory instead of O(workflows) —
the 1M-workflow tier would otherwise hold a million records).
``export_partial()`` emits a picklable ``MetricsPartial`` (tenant
aggregates + usage-rate accumulators) that travels over the shard
result pipe; ``MetricsPartial.merge`` unions shard partials (tenants
are shard-disjoint, so per-tenant merge is key-union; usage windows
concatenate via ``StepAccumulator.merge``) and reproduces the global
``tenant_summary`` / ``usage_summary`` shapes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.core import calibration as cal
from repro_torch.core.cluster import Cluster, SUCCEEDED
from repro_torch.core.dag import Workflow
from repro_torch.core.sim import Sim
from repro_torch.core.stats import StepAccumulator, StreamingStat


@dataclass
class WorkflowRecord:
    name: str
    instance: int
    tenant: str = "default"
    submitted_at: float = -1.0
    first_create: float = -1.0     # first task-pod creation (post-admission)
    ns_created: float = -1.0
    ns_deleted: float = -1.0
    starts: List[Tuple[float, str]] = field(default_factory=list)   # (t, task)
    finishes: Dict[str, float] = field(default_factory=dict)
    retries: int = 0
    preempted: int = 0             # task pods evicted by the Preempt stage
    node_lost: int = 0             # task pods lost to node kills/drains
    rebalanced: int = 0            # task pods offloaded by the descheduler
    failed: bool = False           # retry budget exhausted (fail-workflow)
    failure: str = ""

    @property
    def lifecycle(self) -> float:
        return self.ns_deleted - self.ns_created

    @property
    def queue_delay(self) -> float:
        """Gateway hand-off -> first task-pod creation. Namespace/PVC
        setup is never arbiter-gated, so only the first *pod* creation
        reflects admission wait under contention."""
        if self.submitted_at < 0 or self.first_create < 0:
            return float("nan")
        return self.first_create - self.submitted_at


@dataclass
class TenantAgg:
    """Compact per-tenant aggregate — everything ``tenant_summary``
    derives from the record list, folded to O(1) scalars so completed
    ``WorkflowRecord``s can be dropped (``fold_completed``) and shard
    partials merged.  Field bases mirror ``tenant_summary`` exactly:
    makespan spans records with a deleted namespace *including* failed
    ones; queue-delay / lifecycle / deadline hits cover completed
    (non-failed) records only; preempted/retries span all records."""
    workflows: int = 0
    completed: int = 0
    failed: int = 0
    mk_t0: float = math.inf       # min submission (fallback ns_created)
    mk_t1: float = -math.inf      # max namespace deletion
    qd_sum: float = 0.0
    qd_n: int = 0
    lc_sum: float = 0.0
    lc_n: int = 0
    preempted: int = 0
    node_lost: int = 0
    rebalanced: int = 0
    retries: int = 0
    deadline_hits: int = 0

    def fold(self, rec: "WorkflowRecord", deadline_s: float = 0.0):
        self.workflows += 1
        self.preempted += rec.preempted
        self.node_lost += rec.node_lost
        self.rebalanced += rec.rebalanced
        self.retries += rec.retries
        if rec.failed:
            self.failed += 1
        if rec.ns_deleted > 0:
            t0 = rec.submitted_at if rec.submitted_at >= 0 else rec.ns_created
            if t0 < self.mk_t0:
                self.mk_t0 = t0
            if rec.ns_deleted > self.mk_t1:
                self.mk_t1 = rec.ns_deleted
            if not rec.failed:
                self.completed += 1
                qd = rec.queue_delay
                if qd == qd:                       # drop NaN
                    self.qd_sum += qd
                    self.qd_n += 1
                self.lc_sum += rec.lifecycle
                self.lc_n += 1
                if (deadline_s > 0 and rec.submitted_at >= 0
                        and rec.ns_deleted - rec.submitted_at
                        <= deadline_s + 1e-9):
                    self.deadline_hits += 1

    def merge(self, other: "TenantAgg") -> "TenantAgg":
        self.workflows += other.workflows
        self.completed += other.completed
        self.failed += other.failed
        self.mk_t0 = min(self.mk_t0, other.mk_t0)
        self.mk_t1 = max(self.mk_t1, other.mk_t1)
        self.qd_sum += other.qd_sum
        self.qd_n += other.qd_n
        self.lc_sum += other.lc_sum
        self.lc_n += other.lc_n
        self.preempted += other.preempted
        self.node_lost += other.node_lost
        self.rebalanced += other.rebalanced
        self.retries += other.retries
        self.deadline_hits += other.deadline_hits
        return self

    def summary_row(self, deferrals: int = 0, quota_rejects: int = 0,
                    deadline_s: float = 0.0,
                    gateway: Optional[Dict[str, int]] = None
                    ) -> Dict[str, float]:
        """One ``tenant_summary`` row — same keys, same NaN semantics.
        ``gateway`` (``{"rejects", "retries", "shed"}``) adds the
        submission-edge columns; ``None`` keeps the legacy key set."""
        row = {
            "workflows": float(self.workflows),
            "completed": float(self.completed),
            "failed": float(self.failed),
            "makespan": (self.mk_t1 - self.mk_t0
                         if self.mk_t1 > -math.inf else float("nan")),
            "avg_queue_delay": (self.qd_sum / self.qd_n
                                if self.qd_n else float("nan")),
            "avg_lifecycle": (self.lc_sum / self.lc_n
                              if self.lc_n else float("nan")),
            "admission_deferrals": float(deferrals),
            "quota_rejects": float(quota_rejects),
            "preempted": float(self.preempted),
            "node_lost": float(self.node_lost),
            "rebalanced": float(self.rebalanced),
        }
        if gateway is not None:
            row["gateway_rejects"] = float(gateway.get("rejects", 0))
            row["gateway_retries"] = float(gateway.get("retries", 0))
            row["gateway_shed"] = float(gateway.get("shed", 0))
        if deadline_s > 0:
            row["deadline_s"] = deadline_s
            row["deadline_hits"] = float(self.deadline_hits)
            row["deadline_hit_rate"] = (self.deadline_hits / self.completed
                                        if self.completed else float("nan"))
        return row


@dataclass
class MetricsPartial:
    """Picklable shard extract of a ``MetricsCollector``.

    ``usage`` holds *rate-normalized* accumulators (levels divided by
    the exporting shard's allocatable), so merging concatenates the
    shards' utilization-rate step functions: the merged mean is the
    time-weighted mean utilization across shard slices (equal to the
    cluster-wide rate for equal slices), the merged peak is the max
    per-slice peak.  Tenants are shard-disjoint under the crc32
    partition, so tenant maps merge by key-union (same-key collisions
    still compose correctly via ``TenantAgg.merge``).
    """
    tenant_aggs: Dict[str, TenantAgg] = field(default_factory=dict)
    admission_deferrals: Dict[str, int] = field(default_factory=dict)
    quota_rejects: Dict[str, int] = field(default_factory=dict)
    # submission-edge outcomes from the DurableGateway (ISSUE 10);
    # gateway_active gates the extra tenant_summary columns so
    # gateway-free runs keep the legacy key set bit-for-bit
    gateway_active: bool = False
    gateway_rejects: Dict[str, int] = field(default_factory=dict)
    gateway_retries: Dict[str, int] = field(default_factory=dict)
    gateway_shed: Dict[str, int] = field(default_factory=dict)
    tenant_deadlines: Dict[str, float] = field(default_factory=dict)
    usage: Dict[str, StepAccumulator] = field(default_factory=dict)
    usage_basis: str = "event"
    # chaos recovery: disruption -> replacement-create times (seconds),
    # exactly mergeable like every other StreamingStat (Chan variance,
    # reservoir union) — empty outside chaos runs
    resched: StreamingStat = field(default_factory=StreamingStat)

    def merge(self, other: "MetricsPartial") -> "MetricsPartial":
        self.resched.merge(other.resched)
        for tenant, agg in other.tenant_aggs.items():
            mine = self.tenant_aggs.get(tenant)
            if mine is None:
                self.tenant_aggs[tenant] = replace(agg)
            else:
                mine.merge(agg)
        for src, dst in ((other.admission_deferrals, self.admission_deferrals),
                         (other.quota_rejects, self.quota_rejects),
                         (other.gateway_rejects, self.gateway_rejects),
                         (other.gateway_retries, self.gateway_retries),
                         (other.gateway_shed, self.gateway_shed)):
            for tenant, n in src.items():
                dst[tenant] = dst.get(tenant, 0) + n
        self.gateway_active = self.gateway_active or other.gateway_active
        self.tenant_deadlines.update(other.tenant_deadlines)
        for key, acc in other.usage.items():
            mine = self.usage.get(key)
            if mine is None:
                self.usage[key] = _copy_acc(acc)
            else:
                mine.merge(acc)
        return self

    def tenant_summary(self) -> Dict[str, Dict[str, float]]:
        return {
            tenant: self.tenant_aggs[tenant].summary_row(
                deferrals=self.admission_deferrals.get(tenant, 0),
                quota_rejects=self.quota_rejects.get(tenant, 0),
                deadline_s=self.tenant_deadlines.get(tenant, 0.0),
                gateway=({"rejects": self.gateway_rejects.get(tenant, 0),
                          "retries": self.gateway_retries.get(tenant, 0),
                          "shed": self.gateway_shed.get(tenant, 0)}
                         if self.gateway_active else None))
            for tenant in sorted(self.tenant_aggs)
        }

    def usage_summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for key, acc in self.usage.items():
            out[key] = {"basis": self.usage_basis, "changes": acc.changes,
                        "mean_rate": acc.mean(),
                        "peak_rate": acc.peak,
                        "p95_rate": acc.percentile(95)}
        return out

    @property
    def completed(self) -> int:
        return sum(a.completed for a in self.tenant_aggs.values())

    @property
    def failed(self) -> int:
        return sum(a.failed for a in self.tenant_aggs.values())

    @property
    def workflows(self) -> int:
        return sum(a.workflows for a in self.tenant_aggs.values())

    def recovery_summary(self) -> Dict[str, float]:
        """Recovery accounting rollup: node_lost/preempted splits from
        the tenant aggregates plus time-to-reschedule percentiles."""
        st = self.resched
        out = {
            "node_lost": float(sum(a.node_lost
                                   for a in self.tenant_aggs.values())),
            "preempted": float(sum(a.preempted
                                   for a in self.tenant_aggs.values())),
            "rebalanced": float(sum(a.rebalanced
                                    for a in self.tenant_aggs.values())),
            "rescheduled": float(st.count),
        }
        if st.count:
            out["resched_mean_s"] = st.mean
            out["resched_p50_s"] = st.percentile(50)
            out["resched_p95_s"] = st.percentile(95)
            out["resched_max_s"] = st.max
        return out


def _copy_acc(acc: StepAccumulator) -> StepAccumulator:
    out = StepAccumulator(t0=acc.start_t, level=acc.level)
    out.peak = acc.peak
    out.last_t = acc.last_t
    out.level_dur = dict(acc.level_dur)
    out.changes = acc.changes
    return out


def _rate_acc(acc: StepAccumulator, alloc: float) -> StepAccumulator:
    """Rebase an absolute-level accumulator to utilization rates
    (divide by allocatable) on a window starting at 0."""
    out = StepAccumulator(t0=0.0, level=acc.level / alloc if alloc else 0.0)
    out.peak = acc.peak / alloc if alloc else 0.0
    out.last_t = acc.total_time
    out.level_dur = {lv / alloc: d for lv, d in acc.level_dur.items()} \
        if alloc else {}
    out.changes = acc.changes
    return out


class _ContentionTracker:
    """Exact contended-window integrals for ``usage_mode="event"``:
    per-tenant bound-CPU·seconds accumulated ONLY while every tracked
    tenant holds resources — the event-driven equivalent of filtering
    the 0.5 s samples to instants where all tenants appear."""

    __slots__ = ("tenants", "levels", "active", "last_t",
                 "cpu_seconds", "contended_time")

    def __init__(self, tenants, t0: float):
        self.tenants = list(tenants)
        self.levels = {t: 0 for t in self.tenants}
        self.active = False
        self.last_t = t0
        self.cpu_seconds = {t: 0.0 for t in self.tenants}
        self.contended_time = 0.0

    def update(self, t: float, holding: Dict[str, int]):
        if self.active and t > self.last_t:
            dt = t - self.last_t
            self.contended_time += dt
            for tenant in self.tenants:
                self.cpu_seconds[tenant] += self.levels[tenant] * dt
        self.last_t = t
        levels = self.levels
        for tenant in self.tenants:
            levels[tenant] = holding.get(tenant, 0)
        self.active = all(levels[t] > 0 for t in self.tenants)

    def means(self) -> Dict[str, float]:
        if self.contended_time <= 0.0:
            return {}
        return {t: s / self.contended_time
                for t, s in self.cpu_seconds.items()}


class MetricsCollector:
    def __init__(self, sim: Sim, cluster: Cluster,
                 params: cal.ClusterParams = cal.DEFAULT_PARAMS,
                 sample_mode: str = "full",
                 usage_mode: str = "sampled",
                 fold_completed: bool = False):
        if sample_mode not in ("full", "streaming"):
            raise ValueError(f"unknown sample_mode {sample_mode!r}")
        if usage_mode not in ("sampled", "event"):
            raise ValueError(f"unknown usage_mode {usage_mode!r}")
        self.sim = sim
        self.cluster = cluster
        self.p = params
        self.sample_mode = sample_mode
        self.usage_mode = usage_mode
        self.fold_completed = fold_completed
        self.tenant_aggs: Dict[str, TenantAgg] = {}
        self.workflows: Dict[Tuple[str, int], WorkflowRecord] = {}
        self.samples: List[Tuple[float, int, int]] = []   # (t, cpu_m, mem_mi)
        self.tenant_samples: List[Tuple[float, Dict[str, int]]] = []
        self.cpu_stat = StreamingStat()
        self.mem_stat = StreamingStat()
        self.tenant_cpu_stats: Dict[str, StreamingStat] = {}
        self.admission_deferrals: Dict[str, int] = {}
        self.quota_rejects: Dict[str, int] = {}       # tenant -> count
        # submission-edge outcomes (DurableGateway, ISSUE 10); the
        # flag gates the extra tenant_summary columns
        self.gateway_active = False
        self.gateway_rejects: Dict[str, int] = {}
        self.gateway_retries: Dict[str, int] = {}
        self.gateway_shed: Dict[str, int] = {}
        self.tenant_deadlines: Dict[str, float] = {}  # tenant -> SLO seconds
        # chaos recovery: disruption -> replacement-create latency
        self.resched_stat = StreamingStat()
        self._sampling = False
        # event-driven accounting: exact step accumulators fed by the
        # cluster's bind/release hook — no polling daemon
        self.cpu_acc: Optional[StepAccumulator] = None
        self.mem_acc: Optional[StepAccumulator] = None
        self.tenant_cpu_accs: Dict[str, StepAccumulator] = {}
        self.tenant_mem_accs: Dict[str, StepAccumulator] = {}
        self._contention: Optional[_ContentionTracker] = None
        self._usage_closed = False
        if usage_mode == "event":
            self.cpu_acc = StepAccumulator(t0=sim.now())
            self.mem_acc = StepAccumulator(t0=sim.now())
            cluster.on_usage_change = self._usage_changed

    def _usage_changed(self, tenant: Optional[str]):
        t = self.sim.t
        self.cpu_acc.set(t, self.cluster.cpu_in_use)
        self.mem_acc.set(t, self.cluster.mem_in_use)
        if self._contention is not None:
            self._contention.update(t, self.cluster.tenant_holding_cpu)
        if tenant is not None:
            acc = self.tenant_cpu_accs.get(tenant)
            if acc is None:
                # window-align with the cluster accumulators (t0 at
                # collector start): tenant means are over the whole run,
                # leading idle time included — unlike sampled-mode
                # tenant stats, which are means over active samples only
                acc = self.tenant_cpu_accs[tenant] = \
                    StepAccumulator(t0=self.cpu_acc.start_t)
                self.tenant_mem_accs[tenant] = \
                    StepAccumulator(t0=self.mem_acc.start_t)
            acc.set(t, self.cluster.tenant_holding_cpu.get(tenant, 0))
            self.tenant_mem_accs[tenant].set(
                t, self.cluster.tenant_holding_mem.get(tenant, 0))

    # ---- lifecycle bookkeeping (engines call these) ---------------------
    def wf_record(self, wf: Workflow) -> WorkflowRecord:
        key = (wf.name, wf.instance)
        if key not in self.workflows:
            self.workflows[key] = WorkflowRecord(wf.name, wf.instance,
                                                 tenant=wf.tenant)
        return self.workflows[key]

    def note_submitted(self, wf: Workflow) -> WorkflowRecord:
        rec = self.wf_record(wf)
        rec.submitted_at = self.sim.now()
        return rec               # engines cache it for the _rec fast paths

    def note_first_create(self, wf: Workflow):
        rec = self.wf_record(wf)
        if rec.first_create < 0:
            rec.first_create = self.sim.now()

    # -- record-based fast paths: one wf_record lookup per WORKFLOW
    # (engines keep the record on their per-workflow state) instead of
    # one tuple-key dict probe per pod event
    def note_first_create_rec(self, rec: WorkflowRecord):
        if rec.first_create < 0:
            rec.first_create = self.sim.now()

    def note_start_rec(self, rec: WorkflowRecord, task_id: str):
        rec.starts.append((self.sim.now(), task_id))

    def note_finish_rec(self, rec: WorkflowRecord, task_id: str):
        rec.finishes[task_id] = self.sim.now()

    def note_admission_deferred(self, tenant: str):
        self.admission_deferrals[tenant] = \
            self.admission_deferrals.get(tenant, 0) + 1

    def note_quota_reject(self, tenant: str):
        self.quota_rejects[tenant] = self.quota_rejects.get(tenant, 0) + 1

    def note_gateway(self, kind: str, tenant: str):
        d = {"reject": self.gateway_rejects,
             "retry": self.gateway_retries,
             "shed": self.gateway_shed}[kind]
        d[tenant] = d.get(tenant, 0) + 1

    def _gateway_row(self, tenant: str) -> Optional[Dict[str, int]]:
        if not self.gateway_active:
            return None
        return {"rejects": self.gateway_rejects.get(tenant, 0),
                "retries": self.gateway_retries.get(tenant, 0),
                "shed": self.gateway_shed.get(tenant, 0)}

    def set_tenant_deadline(self, tenant: str, deadline_s: float):
        """Register the tenant's SLO: a completed workflow *hits* when
        submission -> namespace teardown stays within ``deadline_s``."""
        self.tenant_deadlines[tenant] = deadline_s

    def note_failed(self, wf: Workflow, reason: str = ""):
        rec = self.wf_record(wf)
        rec.failed = True
        rec.failure = reason

    def note_rescheduled(self, dt: float):
        """A node-loss-disrupted task got its replacement pod created
        ``dt`` seconds after the disruption (time-to-reschedule)."""
        self.resched_stat.add(dt)

    def note_ns_created(self, wf: Workflow):
        self.wf_record(wf).ns_created = self.sim.now()

    def note_ns_deleted(self, wf: Workflow):
        rec = self.wf_record(wf)
        rec.ns_deleted = self.sim.now()
        if self.fold_completed:
            agg = self.tenant_aggs.get(rec.tenant)
            if agg is None:
                agg = self.tenant_aggs[rec.tenant] = TenantAgg()
            agg.fold(rec, self.tenant_deadlines.get(rec.tenant, 0.0))
            del self.workflows[(rec.name, rec.instance)]

    def note_start(self, wf: Workflow, task_id: str):
        self.wf_record(wf).starts.append((self.sim.now(), task_id))

    def note_finish(self, wf: Workflow, task_id: str):
        self.wf_record(wf).finishes[task_id] = self.sim.now()

    # ---- resource sampling ------------------------------------------------
    def start_sampling(self):
        if self._sampling:
            return
        self._sampling = True
        if self.usage_mode == "event":
            return                 # accumulators run from construction

        streaming = self.sample_mode == "streaming"

        def sample():
            cpu, mem = self.cluster.used()
            # cluster-maintained per-tenant holdings; zero entries are
            # stripped to match the old holding-pod scan exactly
            by_tenant = {t: c for t, c
                         in self.cluster.tenant_holding_cpu.items() if c}
            if streaming:
                self.cpu_stat.add(cpu)
                self.mem_stat.add(mem)
                for t, c in by_tenant.items():
                    stat = self.tenant_cpu_stats.get(t)
                    if stat is None:
                        stat = self.tenant_cpu_stats[t] = StreamingStat()
                    stat.add(c)
            else:
                self.samples.append((self.sim.now(), cpu, mem))
                self.tenant_samples.append((self.sim.now(), by_tenant))
            if self._sampling:
                self.sim.after(self.p.sample_period, sample, daemon=True,
                               note="resource-sampler")

        sample()

    def stop_sampling(self):
        self._sampling = False
        if self.usage_mode == "event" and not self._usage_closed:
            # freeze the window at the stop instant — the clock may be
            # parked at the run horizon afterwards (Sim.run semantics),
            # and trailing idle time is not part of the measured run
            self._close_accs()
            self._usage_closed = True
            self.cluster.on_usage_change = None

    def _close_accs(self):
        if self._usage_closed:
            return
        # last_event_t, not t: after a bounded run the clock parks at the
        # horizon (Sim.run semantics) — trailing idle time up to an
        # arbitrary horizon must not dilute the usage integral.  During
        # event execution the two are identical.
        t = getattr(self.sim, "last_event_t", self.sim.t)
        self.cpu_acc.close(t)
        self.mem_acc.close(t)
        for acc in self.tenant_cpu_accs.values():
            acc.close(t)
        for acc in self.tenant_mem_accs.values():
            acc.close(t)

    # ---- derived metrics (the figures) -------------------------------------
    def pod_exec_times(self, workflow: Optional[str] = None,
                       include_virtual: bool = False) -> List[float]:
        if not self.cluster.retain_pod_log:
            raise RuntimeError(
                "pod_exec_times needs the per-pod log; this cluster was "
                "built with retain_pod_log=False — use "
                "cluster.exec_stat (streaming) instead")
        out = []
        for pod in self.cluster.pod_log:
            if workflow is not None and pod.workflow != workflow:
                continue
            if not include_virtual and pod.labels.get("virtual") == "1":
                continue
            if pod.deleted > 0 and pod.phase == SUCCEEDED:
                out.append(pod.deleted - pod.created)
        return out

    def avg_pod_exec_time(self, workflow: Optional[str] = None) -> float:
        xs = self.pod_exec_times(workflow)
        return sum(xs) / len(xs) if xs else float("nan")

    def lifecycles(self, name: str) -> List[float]:
        return [r.lifecycle for (n, _), r in self.workflows.items()
                if n == name and r.ns_deleted > 0]

    def avg_lifecycle(self, name: str) -> float:
        xs = self.lifecycles(name)
        return sum(xs) / len(xs) if xs else float("nan")

    def total_time(self, name: str) -> float:
        recs = [r for (n, _), r in self.workflows.items() if n == name]
        if not recs:
            return float("nan")
        return max(r.ns_deleted for r in recs) - min(r.ns_created for r in recs)

    def order_consistent(self, wf: Workflow) -> bool:
        """Start order must be a topological linearization of the DAG
        AND every dependency must have FINISHED before the dependent starts."""
        rec = self.wf_record(wf)
        started_at = {t: ts for ts, t in rec.starts}
        for ts, tid in rec.starts:
            for dep in wf.tasks[tid].inputs:
                if dep not in rec.finishes or rec.finishes[dep] > ts + 1e-9:
                    return False
                if dep not in started_at or started_at[dep] > ts + 1e-9:
                    return False
        return len(rec.starts) >= len(wf.tasks)

    def overall_usage(self) -> Tuple[float, float]:
        """Run-wide average (cpu_rate, mem_rate) vs allocatable; works
        in both sample modes (streaming keeps only the accumulators)
        and in event mode (exact step-function integral)."""
        cpu_a, mem_a = self.cluster.allocatable()
        if cpu_a == 0:
            return 0.0, 0.0
        if self.usage_mode == "event":
            self._close_accs()
            return self.cpu_acc.mean() / cpu_a, self.mem_acc.mean() / mem_a
        if self.sample_mode == "streaming":
            if not self.cpu_stat.count:
                return 0.0, 0.0
            return self.cpu_stat.mean / cpu_a, self.mem_stat.mean / mem_a
        if not self.samples:
            return 0.0, 0.0
        n = len(self.samples)
        cpu = sum(c for _, c, _ in self.samples) / n / cpu_a
        mem = sum(m for _, _, m in self.samples) / n / mem_a
        return cpu, mem

    def usage_summary(self) -> Dict[str, Dict[str, float]]:
        """Mean/peak/p95 usage rates vs allocatable, per resource.

        ``usage_mode="event"``: exact closed-form over the bind/release
        step function (``basis="event"``, plus the change count).
        ``"sampled"``: derived from the 0.5 s samples (full mode) or
        the streaming accumulators — the historical approximation.
        """
        cpu_a, mem_a = self.cluster.allocatable()
        if cpu_a == 0:
            return {}
        if self.usage_mode == "event":
            self._close_accs()
            out = {}
            for key, acc, alloc in (("cpu", self.cpu_acc, cpu_a),
                                    ("mem", self.mem_acc, mem_a)):
                out[key] = {"basis": "event", "changes": acc.changes,
                            "mean_rate": acc.mean() / alloc,
                            "peak_rate": acc.peak / alloc,
                            "p95_rate": acc.percentile(95) / alloc}
            return out
        out = {}
        if self.sample_mode == "streaming":
            pairs = (("cpu", self.cpu_stat, cpu_a),
                     ("mem", self.mem_stat, mem_a))
            for key, st, alloc in pairs:
                if not st.count:
                    continue
                out[key] = {"basis": "sampled", "samples": st.count,
                            "mean_rate": st.mean / alloc,
                            "peak_rate": st.max / alloc,
                            "p95_rate": st.percentile(95) / alloc}
            return out
        if self.samples:
            n = len(self.samples)
            for key, idx, alloc in (("cpu", 1, cpu_a), ("mem", 2, mem_a)):
                xs = sorted(s[idx] for s in self.samples)
                out[key] = {"basis": "sampled", "samples": n,
                            "mean_rate": sum(xs) / n / alloc,
                            "peak_rate": xs[-1] / alloc,
                            "p95_rate": xs[min(n - 1, round(0.95 * (n - 1)))]
                                        / alloc}
        return out

    def usage_rate_over(self, t0: float, t1: float) -> Tuple[float, float]:
        """Average (cpu_rate, mem_rate) over [t0, t1] vs allocatable."""
        cpu_a, mem_a = self.cluster.allocatable()
        window = [(t, c, m) for t, c, m in self.samples if t0 <= t <= t1]
        if not window or cpu_a == 0:
            return 0.0, 0.0
        cpu = sum(c for _, c, _ in window) / len(window) / cpu_a
        mem = sum(m for _, _, m in window) / len(window) / mem_a
        return cpu, mem

    def first_lifecycle_usage(self, name: str) -> Tuple[float, float]:
        recs = sorted((r for (n, _), r in self.workflows.items() if n == name),
                      key=lambda r: r.ns_created)
        if not recs:
            return 0.0, 0.0
        r = recs[0]
        return self.usage_rate_over(r.ns_created, r.ns_deleted)

    # ---- per-tenant aggregates (multi-tenant control plane) ---------------
    def tenant_records(self, tenant: str) -> List[WorkflowRecord]:
        return [r for r in self.workflows.values() if r.tenant == tenant]

    def tenant_makespan(self, tenant: str) -> float:
        """First submission -> last namespace deletion for the tenant."""
        recs = [r for r in self.tenant_records(tenant) if r.ns_deleted > 0]
        if not recs:
            return float("nan")
        t0 = min(r.submitted_at if r.submitted_at >= 0 else r.ns_created
                 for r in recs)
        return max(r.ns_deleted for r in recs) - t0

    def tenant_mean_cpu(self, tenant: str) -> float:
        """Time/sample-averaged bound CPU (milli-cores) for one tenant,
        available in every accounting mode: the exact step-function
        mean in ``usage_mode="event"``, the streaming accumulator mean
        in streaming-sample mode, the per-sample mean otherwise."""
        if self.usage_mode == "event":
            acc = self.tenant_cpu_accs.get(tenant)
            if acc is None:
                return 0.0
            self._close_accs()
            return acc.mean()
        if self.sample_mode == "streaming":
            stat = self.tenant_cpu_stats.get(tenant)
            return stat.mean if stat is not None and stat.count else 0.0
        if not self.tenant_samples:
            return 0.0
        return (sum(s.get(tenant, 0) for _, s in self.tenant_samples)
                / len(self.tenant_samples))

    def track_contention(self, tenants: List[str]):
        """Arm exact contended-CPU tracking for ``usage_mode="event"``
        (call before the run; the sampled modes derive contention from
        ``tenant_samples`` and need no arming)."""
        if self.usage_mode != "event":
            return
        self._contention = _ContentionTracker(tenants, self.cpu_acc.start_t)

    def tenant_mean_mem(self, tenant: str) -> float:
        """Time-averaged bound memory (Mi) for one tenant — exact step
        function mean, ``usage_mode="event"`` only (the sampled modes
        never tracked per-tenant memory)."""
        acc = self.tenant_mem_accs.get(tenant)
        if acc is None:
            return 0.0
        self._close_accs()
        return acc.mean()

    def contended_cpu(self, tenants: List[str]) -> Dict[str, float]:
        """Time-averaged bound CPU (milli-cores) per tenant over the
        window where ALL the given tenants hold resources — i.e. while
        they actually contend. Empty dict if they never overlapped.
        In event mode reads the exact tracker armed by
        ``track_contention``; otherwise filters the 0.5 s samples."""
        if self.usage_mode == "event":
            if self._contention is None or \
                    set(tenants) - set(self._contention.tenants):
                raise RuntimeError(
                    "contended_cpu in usage_mode='event' needs "
                    "track_contention(tenants) armed before the run")
            return self._contention.means()
        window = [s for _, s in self.tenant_samples
                  if all(s.get(t) for t in tenants)]
        if not window:
            return {}
        return {t: sum(s[t] for s in window) / len(window) for t in tenants}

    def _folded_aggs(self) -> Dict[str, TenantAgg]:
        """Per-tenant aggregates: folded completions + a non-mutating
        fold of whatever records are still live (insertion order, so
        float sums match the record-list path bit-for-bit)."""
        aggs = {t: replace(a) for t, a in self.tenant_aggs.items()}
        for rec in self.workflows.values():
            agg = aggs.get(rec.tenant)
            if agg is None:
                agg = aggs[rec.tenant] = TenantAgg()
            agg.fold(rec, self.tenant_deadlines.get(rec.tenant, 0.0))
        return aggs

    def export_partial(self) -> MetricsPartial:
        """Compact picklable extract for the shard result pipe."""
        usage: Dict[str, StepAccumulator] = {}
        basis = "event"
        cpu_a, mem_a = self.cluster.allocatable()
        if self.usage_mode == "event":
            self._close_accs()
            usage["cpu"] = _rate_acc(self.cpu_acc, cpu_a)
            usage["mem"] = _rate_acc(self.mem_acc, mem_a)
        return MetricsPartial(
            tenant_aggs=self._folded_aggs(),
            admission_deferrals=dict(self.admission_deferrals),
            quota_rejects=dict(self.quota_rejects),
            gateway_active=self.gateway_active,
            gateway_rejects=dict(self.gateway_rejects),
            gateway_retries=dict(self.gateway_retries),
            gateway_shed=dict(self.gateway_shed),
            tenant_deadlines=dict(self.tenant_deadlines),
            usage=usage, usage_basis=basis,
            resched=self.resched_stat)

    def tenant_summary(self) -> Dict[str, Dict[str, float]]:
        if self.fold_completed:
            # record list is partial by design — go through the aggs
            return {
                tenant: agg.summary_row(
                    deferrals=self.admission_deferrals.get(tenant, 0),
                    quota_rejects=self.quota_rejects.get(tenant, 0),
                    deadline_s=self.tenant_deadlines.get(tenant, 0.0),
                    gateway=self._gateway_row(tenant))
                for tenant, agg in sorted(self._folded_aggs().items())
            }
        out: Dict[str, Dict[str, float]] = {}
        for tenant in sorted({r.tenant for r in self.workflows.values()}):
            recs = self.tenant_records(tenant)
            done = [r for r in recs if r.ns_deleted > 0 and not r.failed]
            delays = [r.queue_delay for r in done
                      if r.queue_delay == r.queue_delay]      # drop NaN
            lifecycles = [r.lifecycle for r in done]
            out[tenant] = {
                "workflows": float(len(recs)),
                "completed": float(len(done)),
                "failed": float(sum(1 for r in recs if r.failed)),
                "makespan": self.tenant_makespan(tenant),
                "avg_queue_delay": (sum(delays) / len(delays)
                                    if delays else float("nan")),
                "avg_lifecycle": (sum(lifecycles) / len(lifecycles)
                                  if lifecycles else float("nan")),
                "admission_deferrals":
                    float(self.admission_deferrals.get(tenant, 0)),
                "quota_rejects": float(self.quota_rejects.get(tenant, 0)),
                "preempted": float(sum(r.preempted for r in recs)),
                "node_lost": float(sum(r.node_lost for r in recs)),
                "rebalanced": float(sum(r.rebalanced for r in recs)),
            }
            gw = self._gateway_row(tenant)
            if gw is not None:
                out[tenant]["gateway_rejects"] = float(gw["rejects"])
                out[tenant]["gateway_retries"] = float(gw["retries"])
                out[tenant]["gateway_shed"] = float(gw["shed"])
            # per-stream SLO: deadline hit-rate over *completed* runs
            # (failed/unfinished workflows are neither hit nor miss —
            # they surface in "failed"); submission -> teardown wall
            deadline = self.tenant_deadlines.get(tenant, 0.0)
            if deadline > 0:
                hits = sum(
                    1 for r in done
                    if r.submitted_at >= 0
                    and r.ns_deleted - r.submitted_at <= deadline + 1e-9)
                out[tenant]["deadline_s"] = deadline
                out[tenant]["deadline_hits"] = float(hits)
                out[tenant]["deadline_hit_rate"] = (
                    hits / len(done) if done else float("nan"))
        return out
