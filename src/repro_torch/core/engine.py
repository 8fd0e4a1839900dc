"""KubeAdaptor engine (§4.3–4.6): the docking framework itself.

Modules, mapped 1:1 to the paper's architecture diagram (Fig 3):
  * workflow input interface   — ``submit`` (fed by the injector via the
                                 in-process gRPC analogue)
  * workflow namespace creator — ``_create_namespace`` (+ PVC via
                                 VolumeManager/StorageClass)
  * task container creator     — ``_create_task_pods`` (concurrent
                                 creates for parallel offspring =
                                 the Goroutine mechanism)
  * resource gathering/alloc   — ResourceGatherer admission gate
  * state tracking & monitoring— InformerSet handlers feeding the
                                 EventRegistry (§4.6 sequence diagram)
  * workflow container destroy — ``_on_pod_succeeded`` -> delete; the
                                 deletion event triggers successors
  * fault tolerance (§4.5)     — Failed pods recreated (<= max_retries),
                                 AlreadyExists resolved by delete+retry;
                                 node loss surfaces as pod failures and
                                 takes the same path
  * straggler mitigation       — optional speculative twin when a pod
                                 overruns straggler_factor x expected
                                 (beyond-paper, for the 1000-node brief)

Multi-tenant control plane (beyond-paper). The engine is one stage of

    WorkflowGateway ──submit──▶ KubeAdaptorEngine ──request──▶ AdmissionArbiter
      (N streams,                 (per-workflow state,           (shared headroom,
       arrival processes)          event-trigger chain)           fifo/priority/
           ▲                                                      fair-share)
           └────────────── workflow-complete ◀────────────────────────┘

The arbiter is a single shared instance: every ``_submit_ready`` files
admission *requests* instead of self-servicing headroom, so concurrent
workflows from many tenants contend under a pluggable policy, and any
pod deletion (any tenant) re-evaluates the pending queue. Tenancy
knobs (per-tenant priority / fair-share weight) are registered on the
arbiter by the ControlPlane builder in core/runner.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core import calibration as cal
from repro_torch.core.cluster import (FAILED, PENDING, RUNNING, SUCCEEDED, Cluster,
                                PodObj)
from repro_torch.core.dag import Task, Workflow
from repro_torch.core.events import EventRegistry
from repro_torch.core.informer import InformerSet
from repro_torch.core.metrics import MetricsCollector
from repro_torch.core.resources import AdmissionArbiter
from repro_torch.core.schedulers import TopologicalScheduler
from repro_torch.core.sim import Sim
from repro_torch.core.volumes import VolumeManager


@dataclass
class WorkflowState:
    wf: Workflow
    scheduler: Optional[object] = None                  # level-1 order source
    rec: Optional[object] = None       # cached metrics WorkflowRecord
    create_cb: Optional[Callable] = None   # admission grant callback
    labels_cache: Dict[str, Dict[str, str]] = field(default_factory=dict)
    pvc: Optional[str] = None
    created: Set[str] = field(default_factory=set)      # tasks with live pods
    completed: Set[str] = field(default_factory=set)    # deps satisfied
    retries: Dict[str, int] = field(default_factory=dict)
    speculated: Set[str] = field(default_factory=set)
    done: bool = False
    # incremental readiness (exact mirror of the all-tasks scan): unmet
    # dependency counts, the ready-but-not-created pool, and each task's
    # definition-order index to reproduce the scan's output order
    unmet: Dict[str, int] = field(default_factory=dict)
    ready_pool: Set[str] = field(default_factory=set)
    order_idx: Dict[str, int] = field(default_factory=dict)
    # task -> instant its pod was lost to a node kill/drain; popped when
    # the replacement pod is created (time-to-reschedule metric).  Empty
    # except under chaos — the hot path tests the dict, nothing more.
    disrupted_at: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        for i, (tid, t) in enumerate(self.wf.tasks.items()):
            self.order_idx[tid] = i
            self.unmet[tid] = len(t.inputs)
            if not t.inputs:
                self.ready_pool.add(tid)

    def note_completed(self, tid: str):
        """First completion of ``tid``: unlock its successors."""
        self.completed.add(tid)
        for nxt in self.wf.tasks[tid].outputs:
            self.unmet[nxt] -= 1
            if self.unmet[nxt] == 0:
                self.ready_pool.add(nxt)

    @property
    def ns(self) -> str:
        return self.wf.namespace()


class KubeAdaptorEngine:
    name = "kubeadaptor"

    def __init__(self, sim: Sim, cluster: Cluster, informers: InformerSet,
                 events: EventRegistry, volumes: VolumeManager,
                 metrics: MetricsCollector,
                 params: cal.ClusterParams = cal.DEFAULT_PARAMS,
                 scheduler_cls=TopologicalScheduler,
                 speculative: bool = False,
                 arbiter: Optional[AdmissionArbiter] = None,
                 on_workflow_done: Optional[Callable] = None):
        self.sim = sim
        self.cluster = cluster
        self.inf = informers
        self.events = events
        self.volumes = volumes
        self.metrics = metrics
        self.p = params
        self.scheduler_cls = scheduler_cls
        self.speculative = speculative
        self.arbiter = arbiter if arbiter is not None else AdmissionArbiter(informers)
        self.on_workflow_done = on_workflow_done
        self._ws: Dict[str, WorkflowState] = {}
        self._started = False

    # ------------------------------------------------------------------ #
    # wiring (event-trigger mechanism, Fig 4)
    # ------------------------------------------------------------------ #
    def start(self):
        if self._started:
            return
        self._started = True
        self.inf.pods.add_handlers(on_update=self._pod_updated,
                                   on_delete=self._pod_deleted)
        self.inf.nodes.add_handlers(on_update=self._node_updated)
        self.events.register("pod-succeeded", self._on_pod_succeeded)
        self.events.register("pod-failed", self._on_pod_failed)
        self.events.register("pod-removed", self._on_pod_removed)

    def _mine(self, pod: PodObj) -> Optional[WorkflowState]:
        # namespace probe first: it alone rejects foreign pods, and the
        # label check only guards cross-engine namespace collisions
        ws = self._ws.get(pod.namespace)
        if ws is None or pod.labels.get("engine") != self.name:
            return None
        return ws

    def _pod_updated(self, pod: PodObj):
        ws = self._mine(pod)
        if ws is None:
            return
        if pod.phase == RUNNING:
            self.metrics.note_start_rec(ws.rec, pod.task_id)
            if self.speculative and not pod.labels.get("twin"):
                self._arm_straggler_check(ws, pod)
        elif pod.phase == SUCCEEDED:
            self.events.emit("pod-succeeded", pod)
        elif pod.phase == FAILED:
            self.events.emit("pod-failed", pod)

    def _pod_deleted(self, pod: PodObj):
        if pod.labels.get("engine") == self.name:
            self.arbiter.pod_removed(pod)
            self.events.emit("pod-removed", pod)

    def _node_updated(self, node):
        # a restored node (chaos plane) re-opens headroom, but no pod
        # event follows it — without this wake, losing every running
        # pod to a node kill leaves the arbiter's pending queue with no
        # pod-removal trigger and the run strands silently.  Normal
        # runs emit no node MODIFIED events, so this is chaos-only.
        if node.ready:
            self.arbiter.evaluate()

    # ------------------------------------------------------------------ #
    # workflow input interface
    # ------------------------------------------------------------------ #
    def submit(self, wf: Workflow):
        self.start()
        ws = WorkflowState(wf=wf, scheduler=self.scheduler_cls(wf))
        ws.create_cb = lambda task: self._admitted(ws, task)
        self._ws[ws.ns] = ws
        ws.rec = self.metrics.note_submitted(wf)
        self.cluster.create_namespace(ws.ns, cb=lambda _ns: self._ns_ready(ws))

    def _ns_ready(self, ws: WorkflowState):
        self.metrics.note_ns_created(ws.wf)
        ws.pvc = self.volumes.provision(ws.ns, cb=lambda _p: self._submit_ready(ws))

    # ------------------------------------------------------------------ #
    # task container creator + resource gate
    # ------------------------------------------------------------------ #
    def _ready_tasks(self, ws: WorkflowState) -> List[str]:
        # ready_pool ⊇ {deps satisfied, not created/completed}; filter +
        # definition-order sort reproduce the old all-tasks scan exactly
        out = [tid for tid in ws.ready_pool
               if tid not in ws.completed and tid not in ws.created]
        if len(out) > 1:
            out.sort(key=ws.order_idx.__getitem__)
        return ws.scheduler.order_ready(out)

    def _submit_ready(self, ws: WorkflowState):
        if ws.done:
            return
        ready = [ws.wf.tasks[t] for t in self._ready_tasks(ws)]
        self.arbiter.submit(ws.ns, ws.wf.tenant, ready, ws.create_cb)

    def _admitted(self, ws: WorkflowState, task: Task) -> bool:
        # a grant may arrive after the workflow moved on (late wake-up);
        # the False return tells the arbiter not to count the grant
        if ws.done or task.id in ws.created or task.id in ws.completed:
            return False
        self._create_pod(ws, task)
        return True

    def _create_pod(self, ws: WorkflowState, task: Task, twin: bool = False,
                    attempt: int = 0):
        name = task.id + ("-twin" if twin else "")
        if twin:
            labels = {"engine": self.name, "task": task.id,
                      "tenant": ws.wf.tenant, "twin": "1"}
            if task.virtual:
                labels["virtual"] = "1"
        else:
            # one immutable labels dict per (workflow, task), shared by
            # every incarnation (retries) — pod labels are never
            # mutated after creation
            labels = ws.labels_cache.get(task.id)
            if labels is None:
                labels = {"engine": self.name, "task": task.id,
                          "tenant": ws.wf.tenant}
                if task.virtual:
                    labels["virtual"] = "1"
                ws.labels_cache[task.id] = labels
        cpu, mem = task.resource_request()
        payload = None
        if task.payload is not None:
            vol = self.volumes.volume(ws.pvc)
            payload = (lambda t=task, v=vol: t.payload(v, t))
        pod = PodObj(name=name, namespace=ws.ns, task_id=task.id,
                     workflow=ws.wf.name, cpu_m=cpu, mem_mi=mem,
                     duration_s=task.run_time(), payload=payload,
                     volume=ws.pvc, labels=labels, tenant=ws.wf.tenant)
        ws.created.add(task.id)
        ws.ready_pool.discard(task.id)
        if ws.disrupted_at and not twin:
            # replacement for a pod lost to a node kill/drain: close
            # the disruption window (time-to-reschedule percentile)
            t0 = ws.disrupted_at.pop(task.id, None)
            if t0 is not None:
                self.metrics.note_rescheduled(self.sim.now() - t0)
        # charge headroom until the informer observes the pod — retried
        # pods and twins bypass admission but must not double-spend
        # (the ledger is idempotent per pod name, so transient-fault
        # retries of the same create re-use the original reservation)
        self.arbiter.reserve(ws.ns, name, ws.wf.tenant, cpu, mem)
        self.metrics.note_first_create_rec(ws.rec)
        self.cluster.create_pod(
            pod,
            error_cb=lambda reason, existing: self._on_create_error(
                ws, task, reason, existing, twin, attempt))

    def _fault_backoff(self, attempt: int) -> float:
        """Capped exponential backoff for retryable apiserver faults,
        with seeded jitter (chaos stream) to de-synchronize retry
        storms — the §4.5 AlreadyExists delete+retry generalized."""
        delay = min(self.p.api_fault_backoff_s * (2 ** attempt),
                    self.p.api_fault_backoff_max_s)
        chaos = self.cluster.chaos
        if chaos is not None:
            delay *= 0.5 + 0.5 * chaos.backoff_jitter()
        return delay

    def _retry_create(self, ws: WorkflowState, task: Task, twin: bool,
                      attempt: int):
        if ws.done:
            return               # workflow tore down while backing off
        self._create_pod(ws, task, twin=twin, attempt=attempt)

    def _delete_pod(self, ws: WorkflowState, name: str,
                    cb: Optional[Callable] = None, attempt: int = 0):
        """``delete_pod`` with the transient-fault retry policy: every
        engine-side deletion routes through here so a chaos-injected
        "Unavailable" is re-issued after ``_fault_backoff`` instead of
        silently dropping the deletion (which would strand the §4.6
        trigger chain waiting on the DELETED event)."""
        def on_error(_reason, _key):
            if ws.done:
                return           # namespace cascade owns cleanup now
            if attempt >= self.p.max_api_fault_retries:
                raise RuntimeError(
                    f"{ws.ns}/{name}: apiserver unavailable after "
                    f"{attempt} delete retries")
            self.sim.after(self._fault_backoff(attempt), self._delete_pod,
                           note="api-retry", args=(ws, name, cb, attempt + 1))
        self.cluster.delete_pod(ws.ns, name, cb=cb, error_cb=on_error)

    def _on_create_error(self, ws: WorkflowState, task: Task, reason: str,
                         existing: PodObj, twin: bool = False,
                         attempt: int = 0):
        # §4.5: duplicate pod -> destroy it, back off, request creation again
        if reason == "AlreadyExists":
            self._delete_pod(
                ws, existing.name,
                cb=lambda _p: self.sim.after(
                    self.p.create_retry_backoff,
                    lambda: self._create_pod(ws, task)))
        elif reason == "NamespaceNotFound" and not ws.done:
            self.cluster.create_namespace(
                ws.ns, cb=lambda _ns: self._create_pod(ws, task))
        elif reason == "Unavailable" and not ws.done:
            # transient apiserver fault (chaos plane): retryable —
            # capped exponential backoff + jitter, then raise (a real
            # outage must not masquerade as a hung run)
            if attempt >= self.p.max_api_fault_retries:
                raise RuntimeError(
                    f"{ws.ns}/{task.id}: apiserver unavailable after "
                    f"{attempt} create retries")
            self.sim.after(self._fault_backoff(attempt), self._retry_create,
                           note="api-retry",
                           args=(ws, task, twin, attempt + 1))

    # ------------------------------------------------------------------ #
    # event callbacks (the §4.6 trigger chain)
    # ------------------------------------------------------------------ #
    def _on_pod_succeeded(self, pod: PodObj):
        ws = self._mine(pod)
        if ws is None or ws.done:
            return
        task_id = pod.task_id
        if task_id not in ws.completed:
            self.metrics.note_finish_rec(ws.rec, task_id)
        # destruction module removes the finished pod (twin too)
        self._delete_pod(ws, pod.name)
        if task_id in ws.speculated:
            other = task_id + ("-twin" if pod.name == task_id else "")
            if other != pod.name:
                self._delete_pod(ws, other)

    def _on_pod_removed(self, pod: PodObj):
        ws = self._mine(pod)
        if ws is None or ws.done:
            return
        if pod.phase != SUCCEEDED:
            return                       # failed-pod removals handled elsewhere
        tid = pod.task_id
        first_completion = tid not in ws.completed
        if first_completion:
            ws.note_completed(tid)
            if len(ws.completed) == len(ws.wf.tasks):
                self._workflow_complete(ws)
            else:
                # trigger the subsequent task pods right now
                self._submit_ready(ws)

    def _on_pod_failed(self, pod: PodObj):
        ws = self._mine(pod)
        if ws is None or ws.done:
            return
        tid = pod.task_id
        if tid in ws.completed:          # twin already finished the task
            self._delete_pod(ws, pod.name)
            return
        if getattr(pod, "evicted", False):
            # preempted by the admission pipeline — or disrupted by a
            # node kill/drain (node_lost) or a descheduler offload
            # (rebalanced): not a failure — the task re-enters the
            # ready pool and re-queues through admission (it must not
            # steal back the freed headroom), with no retry-budget
            # charge
            if getattr(pod, "node_lost", False):
                ws.rec.node_lost += 1
                if not pod.name.endswith("-twin"):
                    ws.disrupted_at[tid] = self.sim.now()
            elif getattr(pod, "rebalanced", False):
                ws.rec.rebalanced += 1
            else:
                ws.rec.preempted += 1

            def requeue(_p):
                if ws.done:
                    return               # evicted in the same instant the
                #                          workflow tore down: the namespace
                #                          cascade owns cleanup — re-adding
                #                          the task to ready_pool here would
                #                          double-count it into a dead run
                if pod.name.endswith("-twin"):
                    return               # the RUNNING primary still owns the
                #                          task — touching created/ready here
                #                          would spawn a duplicate primary
                ws.created.discard(tid)
                if tid not in ws.completed and ws.unmet[tid] == 0:
                    ws.ready_pool.add(tid)
                self._submit_ready(ws)
            self._delete_pod(ws, pod.name, cb=requeue)
            return
        n = ws.retries.get(tid, 0) + 1
        ws.retries[tid] = n
        ws.rec.retries += 1
        task = ws.wf.tasks[tid]
        if n > self.p.max_retries:
            if self.p.on_retry_exhausted == "fail-workflow":
                # quarantine the blast radius to this workflow: the other
                # tenants' runs must not die with it (§4.5 at 10k scale)
                self._fail_workflow(
                    ws, f"{tid} exceeded {self.p.max_retries} retries")
                return
            raise RuntimeError(f"{ws.ns}/{tid} exceeded retries")
        # remove the failed pod, then request generation again (§4.5)
        def recreate(_p):
            if ws.done:
                return                   # failed while the workflow was
            #                              already being torn down — a new
            #                              pod would land in the dying
            #                              namespace and resurrect state
            #                              the cascade just removed
            ws.created.discard(tid)
            if tid not in ws.completed and ws.unmet[tid] == 0:
                ws.ready_pool.add(tid)   # retry: eligible again
            if pod.name.endswith("-twin"):
                return                   # only the primary is retried
            self._create_pod(ws, task)
        self._delete_pod(ws, pod.name, cb=recreate)

    # ------------------------------------------------------------------ #
    # straggler mitigation (speculative twin)
    # ------------------------------------------------------------------ #
    def _arm_straggler_check(self, ws: WorkflowState, pod: PodObj):
        expected = max(pod.duration_s, 0.1)
        wait = max(self.p.straggler_min_wait, self.p.straggler_factor * expected)

        def check():
            live = self.cluster.pods.get((pod.namespace, pod.name))
            if (live is not None and live.phase == RUNNING
                    and live.task_id not in ws.completed
                    and live.task_id not in ws.speculated):
                ws.speculated.add(pod.task_id)
                self._create_pod(ws, ws.wf.tasks[pod.task_id], twin=True)

        self.sim.after(wait, check)

    def _fail_workflow(self, ws: WorkflowState, reason: str):
        """Terminal failure of ONE workflow: record it, then the same
        teardown as success — the other tenants' runs must not die
        with it."""
        self.metrics.note_failed(ws.wf, reason)
        self._teardown(ws, "workflow-failed")

    # ------------------------------------------------------------------ #
    # completion
    # ------------------------------------------------------------------ #
    def _workflow_complete(self, ws: WorkflowState):
        self._teardown(ws, "workflow-complete")

    def _teardown(self, ws: WorkflowState, event: str):
        """Release admission state, destroy the namespace (cascading
        pods/PVCs), and hand the completion back to the gateway so
        closed-loop streams keep flowing."""
        ws.done = True
        self.arbiter.forget_namespace(ws.ns)

        def ns_gone(_ns):
            self.metrics.note_ns_deleted(ws.wf)
            self.volumes.release(ws.ns)
            self.events.emit(event, ws.wf)
            # drop the per-workflow state only now: ns deletion takes
            # ns_delete_latency (≫ informer latency), so every in-flight
            # pod-update delivery for this namespace has already landed —
            # deleting at teardown start would change _mine()/_pod_updated
            # behavior for those late events.  Keeps engine memory
            # O(in-flight), not O(total workflows) (1M-workflow tier).
            self._ws.pop(ws.ns, None)
            if self.on_workflow_done:
                self.on_workflow_done(ws.wf)

        self.cluster.delete_namespace(ws.ns, cb=ns_gone)
