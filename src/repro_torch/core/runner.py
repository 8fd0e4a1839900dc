"""Experiment harness: the ControlPlane builder + one-call runner.

Architecture (multi-tenant control plane):

    ┌────────────────────────── ControlPlane ─────────────────────────┐
    │  Sim ── Cluster ── VolumeManager ── MetricsCollector            │
    │                                                                 │
    │  WorkflowGateway ──submit──▶ engine ──admission──▶ Arbiter      │
    │   streams:                   kubeadaptor | batchjob |           │
    │     tenant, arrival          argo | direct                      │
    │     (serial/concurrent/      (baselines skip the informer       │
    │      poisson), priority,      stack and the arbiter)            │
    │      fair-share weight                                          │
    └─────────────────────────────────────────────────────────────────┘

``ControlPlane`` composes sim/cluster/informers/events/volumes/metrics/
engine/gateway for any engine and exposes the tenancy knobs: call
``add_stream`` once per tenant workload (arrival mode, concurrency,
Poisson rate, priority, fair-share weight, hard quota caps, SLO
deadline), pick an admission policy (``fifo`` / ``priority`` /
``fair-share`` / ``drf`` / ``quota`` / ``preempt`` — see
repro.core.policy), then ``run``.

``run_experiment`` keeps the original one-workflow signature — it is a
ControlPlane with a single default-tenant serial stream, which is
exactly the paper's serialized injector experiment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core import calibration as cal
from repro_torch.core.autoscaler import Autoscaler, AutoscalePolicy
from repro_torch.core.baselines import ArgoLikeEngine, BatchJobEngine, DirectSubmitEngine
from repro_torch.core.chaos import ChaosInjector, ChaosSchedule
from repro_torch.core.cluster import Cluster
from repro_torch.core.dag import Workflow
from repro_torch.core.descheduler import Descheduler, DeschedulePolicy
from repro_torch.core.engine import KubeAdaptorEngine
from repro_torch.core.events import EventRegistry
from repro_torch.core.gateway import BackpressurePolicy, DurableGateway
from repro_torch.core.informer import InformerSet
from repro_torch.core.injector import StreamSpec, WorkflowGateway
from repro_torch.core.metrics import MetricsCollector
from repro_torch.core.policy import POLICY_PRESETS
from repro_torch.core.resources import AdmissionArbiter
from repro_torch.core.schedulers import SCHEDULERS
from repro_torch.core.sim import Sim
from repro_torch.core.volumes import VolumeManager

ENGINES = {
    "kubeadaptor": KubeAdaptorEngine,
    "batchjob": BatchJobEngine,
    "argo": ArgoLikeEngine,
    "direct": DirectSubmitEngine,
}


@dataclass
class RunResult:
    metrics: MetricsCollector
    cluster: Cluster
    sim: Sim
    engine: object
    api_calls: int
    gateway: Optional[WorkflowGateway] = None
    arbiter: Optional[AdmissionArbiter] = None
    gate: Optional[DurableGateway] = None
    chaos: Optional[ChaosInjector] = None
    descheduler: Optional[Descheduler] = None
    autoscaler: Optional[Autoscaler] = None


class ControlPlane:
    """Builder/composer for one experiment stack of any engine."""

    def __init__(self, engine_name: str = "kubeadaptor",
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
                 chaos: Optional[ChaosSchedule] = None,
                 placement: str = "first-fit",
                 deschedule: Optional[DeschedulePolicy] = None,
                 autoscale: Optional[AutoscalePolicy] = None,
                 gateway: Optional[BackpressurePolicy] = None,
                 wal_path: Optional[str] = None,
                 shard_index: int = 0):
        if engine_name not in ENGINES:
            raise ValueError(f"unknown engine {engine_name!r}; "
                             f"expected one of {sorted(ENGINES)}")
        if admission_policy not in POLICY_PRESETS:
            raise ValueError(f"unknown admission policy {admission_policy!r}; "
                             f"expected one of {sorted(POLICY_PRESETS)}")
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; "
                             f"expected one of {sorted(SCHEDULERS)}")
        self.engine_name = engine_name
        self.params = params
        self.sample_resources = sample_resources
        self.sim = Sim(queue=queue)
        self.cluster = Cluster(self.sim, params, cluster_cfg,
                               payload_mode=payload_mode, seed=seed,
                               retain_pod_log=retain_pod_log,
                               lifecycle=lifecycle, placement=placement)
        self.volumes = VolumeManager(self.sim, self.cluster, params)
        self.metrics = MetricsCollector(self.sim, self.cluster, params,
                                        sample_mode=sample_mode,
                                        usage_mode=usage_mode,
                                        fold_completed=fold_completed)
        self.arbiter: Optional[AdmissionArbiter] = None
        # seeded fault injection (ISSUE 7): chaos=None performs zero
        # draws — bit-identical to a chaos-free build
        self.chaos: Optional[ChaosInjector] = None
        if chaos is not None:
            self.chaos = ChaosInjector(self.sim, self.cluster, chaos)
        # periodic evict-to-rebalance daemon (ISSUE 8): None arms
        # nothing — zero events, bit-identical to a descheduler-free run
        self.descheduler: Optional[Descheduler] = None
        if deschedule is not None:
            self.descheduler = Descheduler(self.sim, self.cluster,
                                           deschedule)

        if engine_name == "kubeadaptor":
            self.informers = InformerSet(self.sim, self.cluster, params)
            self.events = EventRegistry(self.sim,
                                        batched=self.cluster.lifecycle == "fast")
            self.arbiter = AdmissionArbiter(
                self.informers, policy=admission_policy,
                on_defer=self.metrics.note_admission_deferred,
                on_quota_reject=self.metrics.note_quota_reject,
                evict=self.cluster.evict_pod,
                preempt_cooldown_s=params.preempt_cooldown_s)
            self.engine = KubeAdaptorEngine(
                self.sim, self.cluster, self.informers, self.events,
                self.volumes, self.metrics, params,
                scheduler_cls=SCHEDULERS[scheduler],
                speculative=speculative, arbiter=self.arbiter)
        else:
            self.informers = None
            self.events = None
            self.engine = ENGINES[engine_name](
                self.sim, self.cluster, self.volumes, self.metrics, params)

        # durable submission front door (ISSUE 10): gateway=None is
        # exactly the old wiring — zero events, zero draws, bit-identical
        if wal_path is not None and gateway is None:
            raise ValueError("wal_path requires a gateway policy")
        self.gate: Optional[DurableGateway] = None
        send = self.engine.submit
        if gateway is not None:
            self.gate = DurableGateway(self.sim, self.engine.submit, gateway,
                                       seed=seed, shard=shard_index,
                                       wal_path=wal_path, chaos=self.chaos,
                                       arbiter=self.arbiter,
                                       metrics=self.metrics)
            self.metrics.gateway_active = True
            send = self.gate.offer
        self.gateway = WorkflowGateway(self.sim, send, seed=seed,
                                       capture_trace=capture_trace)
        if self.gate is not None:
            self.gate.inner = self.gateway
            self.engine.on_workflow_done = self.gate.workflow_done
        else:
            self.engine.on_workflow_done = self.gateway.workflow_done

        # elastic node pools (ISSUE 9): None arms nothing — zero events,
        # zero draws, the full roster stays provisioned (bit-identical).
        # Built last so its depth signal can read the arbiter's queue.
        self.autoscaler: Optional[Autoscaler] = None
        if autoscale is not None:
            arbiter = self.arbiter
            pending_fn = ((lambda: len(arbiter.pending))
                          if arbiter is not None else None)
            self.autoscaler = Autoscaler(self.sim, self.cluster, autoscale,
                                         cluster_cfg=cluster_cfg,
                                         pending_fn=pending_fn)

    # -- tenancy knobs -------------------------------------------------------
    def add_stream(self, workflow: Workflow, repeats: int = 1,
                   tenant: str = "default", arrival: str = "serial",
                   concurrency: int = 1, rate: float = 1.0, burst: int = 1,
                   priority: int = 0, weight: float = 1.0,
                   quota_cpu_m: int = 0, quota_mem_mi: int = 0,
                   deadline_s: float = 0.0) -> StreamSpec:
        """Register one tenant workload.  ``quota_cpu_m``/``quota_mem_mi``
        are hard admission caps (0 = uncapped) enforced by the pipeline's
        Filter stage; ``deadline_s`` is the tenant's SLO — a completed
        workflow *hits* when submission->teardown stays within it
        (tracked per tenant by MetricsCollector, 0 = no SLO)."""
        spec = StreamSpec(workflow=workflow, repeats=repeats, tenant=tenant,
                          arrival=arrival, concurrency=concurrency, rate=rate,
                          burst=burst, priority=priority, weight=weight,
                          quota_cpu_m=quota_cpu_m, quota_mem_mi=quota_mem_mi,
                          deadline_s=deadline_s)
        if self.arbiter is not None:
            self.arbiter.set_tenant(tenant, priority=priority, weight=weight,
                                    quota_cpu_m=quota_cpu_m,
                                    quota_mem_mi=quota_mem_mi)
        if deadline_s > 0:
            self.metrics.set_tenant_deadline(tenant, deadline_s)
        return self.gateway.add_stream(spec)

    def add_trace(self, records, tenants: Optional[dict] = None, make=None):
        """Replay an arrival trace (see ``WorkflowGateway.load_trace``).

        ``records``: iterable of ``{"t", "tenant", "topology"}`` dicts.
        ``tenants``: optional ``{name: {"priority", "weight"}}`` map
        registered on the arbiter. ``make``: ``topology -> Workflow``
        factory; defaults to the paper topologies in configs/workflows.
        """
        if make is None:
            from repro_torch.configs.workflows import get_workflow_spec
            from repro_torch.core.dag import make_workflow
            cache: dict = {}

            def make(topo):
                wfb = cache.get(topo)
                if wfb is None:
                    wfb = cache[topo] = make_workflow(
                        topo, get_workflow_spec(topo))
                return wfb

        if tenants:
            for name, share in tenants.items():
                if self.arbiter is not None:
                    self.arbiter.set_tenant(
                        name, priority=int(share.get("priority", 0)),
                        weight=float(share.get("weight", 1.0)),
                        quota_cpu_m=int(share.get("quota_cpu_m", 0)),
                        quota_mem_mi=int(share.get("quota_mem_mi", 0)))
                if float(share.get("deadline_s", 0.0)) > 0:
                    self.metrics.set_tenant_deadline(
                        name, float(share["deadline_s"]))
        return self.gateway.load_trace(records, make)

    def record_trace(self, path: Optional[str] = None):
        """Capture the realized arrival trace; emits ``arrival_trace/v2``
        (with gateway rejection/retry/shed events) when the durable
        gateway is armed, ``v1`` otherwise."""
        return self.gateway.record_trace(path, gate=self.gate)

    # -- execution -----------------------------------------------------------
    def run(self, horizon_s: float = 500_000.0) -> RunResult:
        if self.sample_resources:
            self.metrics.start_sampling()
            self.gateway.on_drained = self.metrics.stop_sampling
        self.gateway.start()
        self.sim.run(until=horizon_s)
        if not self.sim.idle() and self.gateway.pending():
            raise RuntimeError(
                f"{self.engine_name} did not finish within horizon "
                f"({self.gateway.queued()} workflows queued, "
                f"{self.gateway.pending() - self.gateway.queued()} in flight)")
        return RunResult(metrics=self.metrics, cluster=self.cluster,
                         sim=self.sim, engine=self.engine,
                         api_calls=self.cluster.api_calls,
                         gateway=self.gateway, arbiter=self.arbiter,
                         gate=self.gate, chaos=self.chaos,
                         descheduler=self.descheduler,
                         autoscaler=self.autoscaler)


def run_experiment(engine_name: str, workflow: Workflow, repeats: int = 1,
                   params: cal.ClusterParams = cal.DEFAULT_PARAMS,
                   cluster_cfg: cal.PaperCluster = cal.DEFAULT_CLUSTER,
                   payload_mode: str = "virtual", seed: int = 0,
                   speculative: bool = False,
                   sample_resources: bool = True,
                   horizon_s: float = 500_000.0) -> RunResult:
    """The paper's experiment: serial injection of ``repeats`` instances."""
    plane = ControlPlane(engine_name, params=params, cluster_cfg=cluster_cfg,
                         payload_mode=payload_mode, seed=seed,
                         speculative=speculative,
                         sample_resources=sample_resources)
    plane.gateway.load([workflow.with_instance(i) for i in range(repeats)])
    return plane.run(horizon_s=horizon_s)
