"""Baseline workflow submission approaches (§5.3).

BatchJobEngine — the paper's "Batch Job": a shell script drives kubectl
level by level. Every operation is a kubectl CLI round-trip; a level's
pods are polled with `kubectl get` until ALL succeed, then deleted, and
only then does the next level start (the barrier the paper criticizes:
ready successors wait for the slowest sibling).

ArgoLikeEngine — an Argo-workflow-controller model: one reconcile loop
per workflow at ``argo_reconcile`` cadence. Cycle k detects completions
(API list + controller processing), deletes completed pods (podGC
onPodCompletion), and *requeues* the DAG so newly-unblocked steps are
created in cycle k+1 — the two-phase step transition that dominates
Argo's lifecycle numbers in the paper.

DirectSubmitEngine — the motivation (Fig 1): all task pods thrown at
the cluster at once; the disordered scheduler then executes them in an
order unrelated to the DAG. Used to demonstrate the inconsistency
KubeAdaptor exists to fix (tests + consistency benchmark).

All baselines talk straight to the apiserver (no informer), so
``Cluster.api_calls`` also reproduces the apiserver-pressure claim.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core import calibration as cal
from repro_torch.core.cluster import (FAILED, PENDING, RUNNING, SUCCEEDED, Cluster,
                                PodObj)
from repro_torch.core.dag import Task, Workflow
from repro_torch.core.metrics import MetricsCollector
from repro_torch.core.sim import Sim
from repro_torch.core.volumes import VolumeManager


def _mk_pod(engine: str, ns: str, wf: Workflow, task: Task,
            volumes: VolumeManager, pvc: Optional[str]) -> PodObj:
    labels = {"engine": engine, "task": task.id}
    if task.virtual:
        labels["virtual"] = "1"
    cpu, mem = task.resource_request()
    payload = None
    if task.payload is not None:
        vol = volumes.volume(pvc) if pvc else None
        payload = (lambda t=task, v=vol: t.payload(v, t))
    return PodObj(name=task.id, namespace=ns, task_id=task.id,
                  workflow=wf.name, cpu_m=cpu, mem_mi=mem,
                  duration_s=task.run_time(), payload=payload,
                  volume=pvc, labels=labels)


class _TrackingMixin:
    """Watch-based start/finish bookkeeping (metrics only, no control)."""

    def _track(self, cluster: Cluster, metrics: MetricsCollector, engine: str):
        def on_event(ev):
            pod = ev.obj
            if pod.labels.get("engine") != engine:
                return
            ws = self._by_ns.get(pod.namespace)
            if ws is None:
                return
            if ev.type == "MODIFIED" and pod.phase == RUNNING:
                metrics.note_start(ws["wf"], pod.task_id)
            if ev.type == "MODIFIED" and pod.phase == SUCCEEDED:
                metrics.note_finish(ws["wf"], pod.task_id)
        cluster.watch("pod", on_event)


class BatchJobEngine(_TrackingMixin):
    name = "batchjob"

    def __init__(self, sim: Sim, cluster: Cluster, volumes: VolumeManager,
                 metrics: MetricsCollector,
                 params: cal.ClusterParams = cal.DEFAULT_PARAMS,
                 on_workflow_done: Optional[Callable] = None):
        self.sim = sim
        self.cluster = cluster
        self.volumes = volumes
        self.metrics = metrics
        self.p = params
        self.on_workflow_done = on_workflow_done
        self._by_ns: Dict[str, Dict] = {}
        self._track(cluster, metrics, self.name)

    def submit(self, wf: Workflow):
        ns = wf.namespace()
        ws = {"wf": wf, "levels": wf.levels(), "level": 0, "pvc": None}
        self._by_ns[ns] = ws
        self.metrics.note_submitted(wf)
        # kubectl create namespace && kubectl apply pvc
        self.sim.after(self.p.kubectl_latency, lambda: self.cluster.create_namespace(
            ns, cb=lambda _n: self._ns_ready(ws)))

    def _ns_ready(self, ws):
        self.metrics.note_ns_created(ws["wf"])
        ws["pvc"] = self.volumes.provision(
            ws["wf"].namespace(), cb=lambda _p: self._run_level(ws))

    def _run_level(self, ws):
        wf: Workflow = ws["wf"]
        if ws["level"] >= len(ws["levels"]):
            self._finish(ws)
            return
        tasks = [wf.tasks[t] for t in ws["levels"][ws["level"]]]

        # one `kubectl apply -f level.yaml` for the whole batch
        def apply():
            for t in tasks:
                self.cluster.create_pod(_mk_pod(self.name, wf.namespace(), wf,
                                                t, self.volumes, ws["pvc"]))
            self.sim.after(self.p.batch_poll_interval,
                           lambda: self._poll_level(ws, tasks))

        self.sim.after(self.p.kubectl_latency, apply)

    def _poll_level(self, ws, tasks: List[Task]):
        """`kubectl get pod <name>` per task — the paper's 'continual
        checking of the status of the task pod' (width-dependent cost)."""
        wf: Workflow = ws["wf"]
        ns = wf.namespace()
        states: Dict[str, str] = {}
        # one CLI round-trip + one status fetch per pod in the level
        cost = self.p.kubectl_latency + self.p.batch_pod_poll * len(tasks)

        def check():
            for t in tasks:
                pods = {p.name: p for p in self.cluster.list_pods(ns)}
                p = pods.get(t.id)
                states[t.id] = p.phase if p is not None else "Missing"
            done()

        def done():
            failed = [t for t in tasks if states.get(t.id) == FAILED]
            if failed:
                for t in failed:   # kubectl delete + re-apply
                    self.cluster.delete_pod(
                        ns, t.id,
                        cb=lambda _x, t=t: self.cluster.create_pod(
                            _mk_pod(self.name, ns, wf, t, self.volumes,
                                    ws["pvc"])))
                self.sim.after(self.p.batch_poll_interval,
                               lambda: self._poll_level(ws, tasks))
            elif all(states.get(t.id) == SUCCEEDED for t in tasks):
                self._delete_level(ws, tasks)
            else:
                self.sim.after(self.p.batch_poll_interval,
                               lambda: self._poll_level(ws, tasks))

        self.sim.after(cost, check)

    def _delete_level(self, ws, tasks: List[Task]):
        wf: Workflow = ws["wf"]
        ns = wf.namespace()
        remaining = {t.id for t in tasks}

        def deleted(pod):
            if pod is not None:
                remaining.discard(pod.name)
            if not remaining:
                ws["level"] += 1
                self._run_level(ws)

        def delete_all():   # one `kubectl delete -f level.yaml`
            for t in tasks:
                self.cluster.delete_pod(ns, t.id, cb=deleted)

        self.sim.after(self.p.kubectl_latency, delete_all)

    def _finish(self, ws):
        wf: Workflow = ws["wf"]
        def gone(_n):
            self.metrics.note_ns_deleted(wf)
            self.volumes.release(wf.namespace())
            if self.on_workflow_done:
                self.on_workflow_done(wf)
        self.sim.after(self.p.kubectl_latency,
                       lambda: self.cluster.delete_namespace(wf.namespace(), cb=gone))


class ArgoLikeEngine(_TrackingMixin):
    name = "argo"

    def __init__(self, sim: Sim, cluster: Cluster, volumes: VolumeManager,
                 metrics: MetricsCollector,
                 params: cal.ClusterParams = cal.DEFAULT_PARAMS,
                 on_workflow_done: Optional[Callable] = None):
        self.sim = sim
        self.cluster = cluster
        self.volumes = volumes
        self.metrics = metrics
        self.p = params
        self.on_workflow_done = on_workflow_done
        self._by_ns: Dict[str, Dict] = {}
        self._track(cluster, metrics, self.name)

    def submit(self, wf: Workflow):
        ns = wf.namespace()
        ws = {"wf": wf, "completed": set(), "created": set(),
              "to_create": [], "pvc": None, "done": False}
        self._by_ns[ns] = ws
        self.metrics.note_submitted(wf)
        # CRD submission + controller pickup
        self.sim.after(self.p.argo_workflow_init,
                       lambda: self.cluster.create_namespace(
                           ns, cb=lambda _n: self._ns_ready(ws)))

    def _ns_ready(self, ws):
        self.metrics.note_ns_created(ws["wf"])
        ws["pvc"] = self.volumes.provision(
            ws["wf"].namespace(), cb=lambda _p: self._bootstrap(ws))

    def _bootstrap(self, ws):
        ws["to_create"] = self._ready(ws)
        self._reconcile(ws)

    def _ready(self, ws) -> List[str]:
        wf: Workflow = ws["wf"]
        out = []
        for tid, t in wf.tasks.items():
            if tid in ws["completed"] or tid in ws["created"]:
                continue
            if all(d in ws["completed"] for d in t.inputs):
                out.append(tid)
        return out

    def _reconcile(self, ws):
        """One controller cycle: API list + process + act; requeue."""
        if ws["done"]:
            return
        wf: Workflow = ws["wf"]
        ns = wf.namespace()

        def process():
            # phase 1: create pods queued by the PREVIOUS cycle — the
            # controller instantiates step templates one at a time
            delay = 0.0
            for tid in ws["to_create"]:
                if tid not in ws["created"]:
                    ws["created"].add(tid)
                    self.sim.after(delay, lambda t=tid: self.cluster.create_pod(
                        _mk_pod(self.name, ns, wf, wf.tasks[t],
                                self.volumes, ws["pvc"])))
                    delay += self.p.argo_pod_overhead
            ws["to_create"] = []
            # phase 2: detect completions, GC their pods, queue successors
            pods = {p.name: p for p in self.cluster.list_pods(ns)}
            for name, pod in pods.items():
                if pod.phase == SUCCEEDED and name not in ws["completed"]:
                    ws["completed"].add(name)
                    self.cluster.delete_pod(ns, name)
                elif pod.phase == FAILED:
                    ws["created"].discard(name)       # retried next cycle
                    self.cluster.delete_pod(ns, name)
            ws["to_create"] = self._ready(ws)
            if len(ws["completed"]) == len(wf.tasks):
                self._finish(ws)
            else:
                self.sim.after(self.p.argo_reconcile, lambda: self._reconcile(ws))

        # API list + DAG-processing overhead per cycle
        self.sim.after(self.p.api_latency + self.p.argo_controller_overhead,
                       process)

    def _finish(self, ws):
        ws["done"] = True
        wf: Workflow = ws["wf"]
        def gone(_n):
            self.metrics.note_ns_deleted(wf)
            self.volumes.release(wf.namespace())
            if self.on_workflow_done:
                self.on_workflow_done(wf)
        self.cluster.delete_namespace(wf.namespace(), cb=gone)


class DirectSubmitEngine(_TrackingMixin):
    """Fig 1's problem: submit everything, let the scheduler 'decide'."""

    name = "direct"

    def __init__(self, sim: Sim, cluster: Cluster, volumes: VolumeManager,
                 metrics: MetricsCollector,
                 params: cal.ClusterParams = cal.DEFAULT_PARAMS,
                 on_workflow_done: Optional[Callable] = None):
        self.sim = sim
        self.cluster = cluster
        self.volumes = volumes
        self.metrics = metrics
        self.p = params
        self.on_workflow_done = on_workflow_done
        self._by_ns: Dict[str, Dict] = {}
        self._track(cluster, metrics, self.name)

    def submit(self, wf: Workflow):
        ns = wf.namespace()
        ws = {"wf": wf, "deleted": set(), "done": False}
        self._by_ns[ns] = ws
        self.metrics.note_submitted(wf)
        self.cluster.create_namespace(ns, cb=lambda _n: self._all_in(ws))

    def _all_in(self, ws):
        wf: Workflow = ws["wf"]
        self.metrics.note_ns_created(wf)
        for t in wf.tasks.values():
            self.cluster.create_pod(_mk_pod(self.name, wf.namespace(), wf, t,
                                            self.volumes, None))
        self._poll(ws)

    def _poll(self, ws):
        wf: Workflow = ws["wf"]
        ns = wf.namespace()
        pods = self.cluster.list_pods(ns)
        for p in pods:
            if p.phase == SUCCEEDED:
                self.cluster.delete_pod(ns, p.name)
                ws["deleted"].add(p.name)
        if len(ws["deleted"]) == len(wf.tasks) and not ws["done"]:
            ws["done"] = True
            def gone(_n):
                self.metrics.note_ns_deleted(wf)
                if self.on_workflow_done:
                    self.on_workflow_done(wf)
            self.cluster.delete_namespace(ns, cb=gone)
            return
        self.sim.after(self.p.batch_poll_interval, lambda: self._poll(ws))
