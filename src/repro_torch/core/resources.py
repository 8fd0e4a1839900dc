"""Resource gathering & allocation (§4.3) + the admission pipeline driver.

``ResourceGatherer`` is the paper's module: it reads NodeLister/
PodLister from the informer cache (never the apiserver), computes
cluster headroom as

    available = sum(Allocatable of ready nodes)        (master excluded —
              - sum(Requests of non-terminal pods)      it isn't in the
                                                        node list at all)

and gates task-pod creation on fit, so KubeAdaptor admits exactly as
many concurrent task pods as the cluster can hold instead of flooding
the scheduler queue.

``AdmissionArbiter`` promotes that stateless gate into the control
plane's shared admission point, now a thin driver over the staged
pipeline in ``repro.core.policy`` (ISSUE 4):

    QueueOrder   fifo / priority / fair-share / drf plugins own their
                 specialized O(1)-ish walk structures (policy/ordering)
    Filter       hard per-tenant quota caps (policy/filters), consulted
                 inside the walks, inert until a cap is registered
    Reserve      the reservation ledger closing the informer-latency
                 double-spend window (policy/reservations)
    Permit       grant bookkeeping — ``_create_bookkeep`` fires the
                 engine callback and updates tenant counters
    Preempt      starvation-triggered eviction of lower-priority
                 RUNNING pods (policy/preemption), armed by the
                 ``preempt`` preset

The arbiter keeps the cross-stage state the walks share: the pending
queue (re-evaluated whenever any tenant's pod frees resources), the
value-count multisets behind the ``_no_fit_possible`` early exit, the
deferral ledger, and the tenant registry (``set_tenant`` now carries
quota caps next to priority/weight).  Every scheduling decision of the
pre-pipeline monolith is preserved bit-for-bit: the legacy policies'
binding-sequence hashes are pinned by tests/test_scale_core.py and
tests/test_policy_pipeline.py, and the specialized walks still match
the generic re-sort loop (``_evaluate_generic``, kept as the reference
and the path for custom/legacy policy objects).
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cluster import PENDING, RUNNING
from repro_torch.core.dag import Task
from repro_torch.core.informer import InformerSet
from repro_torch.core.policy import (POLICY_PRESETS, AdmissionRequest,
                               DominantShareOrder, FairShareOrder, FifoOrder,
                               PipelineSpec, Preemptor, PriorityOrder,
                               QueueOrder, ReservationLedger, TenantQuotaFilter,
                               TenantShare, make_order, resolve_policy)

# legacy aliases: the monolith's policy classes live on as the ordering
# plugins (same names importable from here, same three-entry registry —
# new names live in repro.core.policy.QUEUE_ORDERS / POLICY_PRESETS)
FifoPolicy = FifoOrder
PriorityPolicy = PriorityOrder
FairSharePolicy = FairShareOrder

ADMISSION_POLICIES = {
    "fifo": FifoOrder,
    "priority": PriorityOrder,
    "fair-share": FairShareOrder,
}


class ResourceGatherer:
    def __init__(self, informers: InformerSet):
        self.inf = informers
        self._alloc_cache: Tuple[int, int] = (0, 0)
        self._alloc_gen = -1

    def allocatable(self) -> Tuple[int, int]:
        nodes = self.inf.nodes
        if nodes.generation != self._alloc_gen:
            cpu = mem = 0
            for node in nodes.lister():
                if node.ready:
                    cpu += node.cpu_alloc
                    mem += node.mem_alloc
            self._alloc_cache = (cpu, mem)
            self._alloc_gen = nodes.generation
        return self._alloc_cache

    def requested(self) -> Tuple[int, int]:
        pods = self.inf.pods
        return pods.nonterminal_cpu, pods.nonterminal_mem

    def _requested_scan(self) -> Tuple[int, int]:
        """Reference cache scan; equals ``requested()`` at all times
        (the informer aggregates are exact — see test_scale_core)."""
        cpu = mem = 0
        for pod in self.inf.pods.lister():
            if pod.phase in (PENDING, RUNNING):
                cpu += pod.cpu_m
                mem += pod.mem_mi
        return cpu, mem

    def available(self) -> Tuple[int, int]:
        (ca, ma), (cr, mr) = self.allocatable(), self.requested()
        return ca - cr, ma - mr

    def fits(self, task: Task) -> bool:
        cpu, mem = task.resource_request()
        ac, am = self.available()
        return cpu <= ac and mem <= am

    def admit(self, tasks: List[Task]) -> List[Task]:
        """Greedy admission of a ready set within current headroom."""
        ac, am = self.available()
        out = []
        for t in tasks:
            cpu, mem = t.resource_request()
            if cpu <= ac and mem <= am:
                out.append(t)
                ac -= cpu
                am -= mem
        return out


class AdmissionArbiter(ResourceGatherer):
    """Stateful, policy-driven admission shared by all live workflows —
    the pipeline driver (stages in repro.core.policy)."""

    def __init__(self, informers: InformerSet, policy: str = "fifo",
                 on_defer: Optional[Callable[[str], None]] = None,
                 on_quota_reject: Optional[Callable[[str], None]] = None,
                 evict: Optional[Callable[[str, str], bool]] = None,
                 preempt: Optional[bool] = None,
                 preempt_cooldown_s: float = 5.0):
        super().__init__(informers)
        spec = resolve_policy(policy)
        self.order_plugin = make_order(spec).bind(self)
        # back-compat alias: the order plugin carries the old policy
        # object's order()/may_backfill() surface
        self.policy = self.order_plugin
        self.filters = [TenantQuotaFilter().bind(self)]
        self.ledger = ReservationLedger()
        if preempt is None:
            preempt = isinstance(spec, PipelineSpec) and spec.preempt
        self.preemptor = (Preemptor(cooldown_s=preempt_cooldown_s).bind(self)
                          if preempt else None)
        self.evict = evict
        self.on_defer = on_defer
        self.on_quota_reject = on_quota_reject
        self.pending: Dict[Tuple[str, str], AdmissionRequest] = {}
        self.tenants: Dict[str, TenantShare] = {}
        self.admitted = 0
        self.grant_batches = 0             # evaluates granting >= 1 request
        self.deferrals = 0
        self.quota_rejects = 0
        self.preemptions = 0               # RUNNING pods evicted
        self.preemption_log: List[dict] = []
        self.max_pending = 0               # peak admission-queue depth
        # submission-edge outcomes, fed by the DurableGateway so bench
        # rows and tenant_summary read them here instead of reaching
        # into gateway internals (ISSUE 10); all zero when no gate
        self.gateway_rejects = 0
        self.gateway_retries = 0
        self.gateway_shed = 0
        self._seq = 0
        self._quota_active = False         # any tenant with a cap?
        self._fresh: List[AdmissionRequest] = []   # not yet deferral-checked
        self._min_cpu = Counter()      # value -> count over pending requests
        self._min_mem = Counter()
        # only plugins with a specialized walk take the fast path;
        # legacy order/may_backfill objects run the generic loop
        self._fast = callable(getattr(self.order_plugin, "walk", None))

    def counters(self) -> Dict[str, int]:
        """Compact counter export (shard result records): everything
        the benchmarks read off the arbiter, no object graph."""
        return {"admitted": self.admitted,
                "grant_batches": self.grant_batches,
                "deferrals": self.deferrals,
                "quota_rejects": self.quota_rejects,
                "preemptions": self.preemptions,
                "max_pending": self.max_pending,
                "gateway_rejects": self.gateway_rejects,
                "gateway_retries": self.gateway_retries,
                "gateway_shed": self.gateway_shed}

    def note_gateway(self, kind: str):
        """Submission-edge event from the DurableGateway."""
        if kind == "reject":
            self.gateway_rejects += 1
        elif kind == "retry":
            self.gateway_retries += 1
        elif kind == "shed":
            self.gateway_shed += 1
        else:
            raise ValueError(f"unknown gateway event {kind!r}")

    # -- tenant registry ----------------------------------------------------
    def set_tenant(self, name: str, priority: int = 0, weight: float = 1.0,
                   quota_cpu_m: int = 0, quota_mem_mi: int = 0):
        self.tenants[name] = TenantShare(priority=priority, weight=weight,
                                         quota_cpu_m=quota_cpu_m,
                                         quota_mem_mi=quota_mem_mi)
        if quota_cpu_m or quota_mem_mi:
            self._quota_active = True

    def tenant(self, name: str) -> TenantShare:
        if name not in self.tenants:
            self.tenants[name] = TenantShare()
        return self.tenants[name]

    # -- Reserve stage ------------------------------------------------------
    @property
    def reserved(self):
        return self.ledger.reserved

    def reserve(self, namespace: str, name: str, tenant: str,
                cpu: int, mem: int):
        """Charge headroom for a pod whose creation is in flight but not
        yet visible in the informer cache. Engines call this for EVERY
        pod they create (granted, retried, or speculative twin), closing
        the watch+informer latency double-spend window."""
        self.ledger.reserve(namespace, name, tenant, cpu, mem,
                            self.inf.pods.sim.now())

    def available(self) -> Tuple[int, int]:
        self.ledger.sync(self.inf.pods)
        ac, am = super().available()
        return ac - self.ledger.cpu, am - self.ledger.mem

    def tenant_usage_cpu(self) -> Dict[str, int]:
        """CPU currently held per tenant: informer-visible non-terminal
        pods plus not-yet-visible reservations (O(tenants) — the
        fair-share walk reads this once per grant round)."""
        self.ledger.sync(self.inf.pods)
        usage = dict(self.inf.pods.nonterminal_cpu_by_tenant)
        for tenant, cpu in self.ledger.cpu_by_tenant.items():
            usage[tenant] = usage.get(tenant, 0) + cpu
        return usage

    def tenant_usage(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """(cpu, mem) held per tenant — one reservation sync, both
        axes; the drf walk reads this once per grant round."""
        self.ledger.sync(self.inf.pods)
        pods = self.inf.pods
        cpu = dict(pods.nonterminal_cpu_by_tenant)
        for tenant, c in self.ledger.cpu_by_tenant.items():
            cpu[tenant] = cpu.get(tenant, 0) + c
        mem = dict(pods.nonterminal_mem_by_tenant)
        for tenant, m in self.ledger.mem_by_tenant.items():
            mem[tenant] = mem.get(tenant, 0) + m
        return cpu, mem

    # -- Filter stage -------------------------------------------------------
    def _filters_allow(self, req: AdmissionRequest) -> bool:
        """Side-effect-free filter probe (no reject accounting)."""
        for f in self.filters:
            if not f.permits(req):
                return False
        return True

    def _permits(self, req: AdmissionRequest) -> bool:
        """Consulted by the walks at the exact point the headroom
        fit-check passes; inert until a tenant registers a cap."""
        if not self._quota_active:
            return True
        if self._filters_allow(req):
            return True
        if not req.quota_rejected:
            req.quota_rejected = True
            self.quota_rejects += 1
            self.tenant(req.tenant).quota_rejects += 1
            if self.on_quota_reject:
                self.on_quota_reject(req.tenant)
        return False

    # -- request lifecycle --------------------------------------------------
    def submit(self, namespace: str, tenant: str, tasks: List[Task],
               create: Callable[[Task], None]):
        """Queue admission requests (idempotent per (namespace, task))
        and immediately evaluate the pending set."""
        if not tasks:
            # nothing new to queue: every submit with no ready tasks
            # rides the pod-removal chain, whose informer delete
            # callback already evaluated at this instant with this
            # exact state — a re-evaluate is a provable no-op
            return
        for task in tasks:
            cpu, mem = task.resource_request()
            req = AdmissionRequest(namespace, tenant, task, create,
                                   seq=self._seq, cpu=cpu, mem=mem)
            self._seq += 1
            key = req.key()
            if key not in self.pending:
                self.pending[key] = req
                self._index_add(req)
        if len(self.pending) > self.max_pending:
            self.max_pending = len(self.pending)
        self.evaluate()

    def _index_add(self, req: AdmissionRequest):
        self._fresh.append(req)
        self._min_cpu[req.cpu] += 1
        self._min_mem[req.mem] += 1
        self.order_plugin.on_add(req)

    def _counters_remove(self, req: AdmissionRequest):
        self._min_cpu[req.cpu] -= 1
        if not self._min_cpu[req.cpu]:
            del self._min_cpu[req.cpu]
        self._min_mem[req.mem] -= 1
        if not self._min_mem[req.mem]:
            del self._min_mem[req.mem]

    def _index_remove(self, req: AdmissionRequest):
        self._counters_remove(req)
        self.order_plugin.on_remove(req)

    # -- Permit stage -------------------------------------------------------
    def _create_bookkeep(self, req: AdmissionRequest) -> bool:
        """Fire the grant callback; True when it consumed headroom (a
        stale grant the engine declined consumes none)."""
        if req.create(req.task) is not False:
            self.admitted += 1
            self.tenant(req.tenant).granted += 1
            return True
        return False

    def _grant(self, req: AdmissionRequest) -> bool:
        del self.pending[req.key()]
        self._index_remove(req)
        return self._create_bookkeep(req)

    def _mark_deferred(self):
        """Every request still pending after an evaluate has waited at
        least once. Only requests submitted since the last evaluate can
        be newly deferred, so the check is O(new), not O(pending)."""
        if self._fresh:
            pending = self.pending
            for req in self._fresh:
                if not req.deferred and pending.get(req.key()) is req:
                    req.deferred = True
                    self.deferrals += 1
                    self.tenant(req.tenant).deferred += 1
                    if self.on_defer:
                        self.on_defer(req.tenant)
            self._fresh.clear()

    def _no_fit_possible(self, ac: int, am: int) -> bool:
        """True when headroom is below every pending request on at
        least one axis — no walk can grant anything."""
        return (ac < min(self._min_cpu) if self._min_cpu else False) or \
               (am < min(self._min_mem) if self._min_mem else False)

    def evaluate(self):
        """Drive the pipeline once: grant as many pending requests as
        headroom, the ordering plugin's walk, and the filters allow,
        then mark deferrals and give the Preempt stage its shot."""
        before = self.admitted
        if not self._fast:
            self._evaluate_generic()
        else:
            # available() is called unconditionally, exactly like the
            # generic loop: its reservation-sync side effect must run
            # at the same instants or reservations outlive their
            # informer visibility window and headroom diverges
            ac, am = self.available()
            if self.pending:
                self.order_plugin.walk(ac, am)
        if self.admitted != before:
            self.grant_batches += 1        # one multi-grant admission round
        self._mark_deferred()
        if self.preemptor is not None:
            self.preemptor.maybe_preempt()

    # -- generic loop (reference + custom-policy path) -----------------------
    def _evaluate_generic(self):
        ac, am = self.available()
        policy = self.order_plugin
        dynamic = getattr(policy, "dynamic_order", False)
        progress = True
        while progress and self.pending:
            progress = False
            blocked: List[AdmissionRequest] = []
            for req in policy.order(list(self.pending.values()), self):
                cpu, mem = req.task.resource_request()
                if cpu <= ac and mem <= am:
                    if not self._permits(req):
                        continue   # capped: skips, never bars others
                    if all(policy.may_backfill(b, req, self)
                           for b in blocked):
                        if self._grant(req):
                            ac -= cpu
                            am -= mem
                        progress = True
                        if dynamic:
                            break  # re-rank with the new usage
                        continue
                blocked.append(req)
            if not dynamic:
                break              # one sorted pass granted all that fit

    def pod_removed(self, pod):
        """A pod freed resources: drop its reservation (if still held —
        unless it belongs to a newer incarnation of a reused name) and
        wake pending requests of every tenant."""
        self.ledger.release_if_current((pod.namespace, pod.name), pod.created)
        if self.pending:
            self.evaluate()

    def forget_namespace(self, namespace: str):
        for key in [k for k in self.pending if k[0] == namespace]:
            req = self.pending.pop(key)
            self._index_remove(req)
        self.ledger.drop_namespace(namespace)
