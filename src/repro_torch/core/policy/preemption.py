"""Preempt stage: evict lower-priority RUNNING pods for a starved
high-priority request.

Runs after every evaluate that leaves requests pending.  A request is
*starved* when all of:

  1. it is the ordering plugin's ``starvation_candidate()`` — the
     highest-priority oldest pending request (priority-aware orders
     only; fifo/fair-share return None and never preempt);
  2. it has been deferred at least once (waited a full evaluate);
  3. it is blocked by shared headroom, not by its tenant's own quota
     cap (evicting other tenants cannot help a capped tenant);
  4. tenants with strictly lower priority currently hold resources.

Victims are chosen deterministically — lowest tenant priority first,
then latest-started first (minimize wasted work), then name — and a
plan executes only if it fully covers the beneficiary's deficit
(matching kube-scheduler's "preemption must make the pod schedulable"
rule).  Eviction goes through the arbiter's ``evict`` callback
(``Cluster.evict_pod``); the evicted pod surfaces as a FAILED pod with
``evicted=True`` and the engine returns its task to the ready pool
WITHOUT charging the retry budget.  Freed headroom becomes visible to
admission through the normal informer path, and the beneficiary's
class is walked first on the next evaluate, so the freed room cannot
be stolen by lower classes (priority ordering bars them behind the
still-blocked request).

A per-tenant cooldown (``ClusterParams.preempt_cooldown_s``) bounds
eviction churn while a plan's deletions are still in flight.  Every
executed plan is appended to ``arbiter.preemption_log`` with the
condition snapshot it fired under — the starvation invariant is
asserted over this log by tests/test_policy_pipeline.py.
"""
from __future__ import annotations

from repro_torch.core.cluster import RUNNING


class Preemptor:
    def __init__(self, cooldown_s: float = 5.0):
        self.cooldown_s = cooldown_s
        self._last_plan_t: dict = {}         # beneficiary tenant -> sim t

    def bind(self, arbiter) -> "Preemptor":
        self.arb = arbiter
        return self

    def maybe_preempt(self):
        arb = self.arb
        if arb.evict is None or not arb.pending:
            return
        cand = arb.order_plugin.starvation_candidate()
        if cand is None or not cand.deferred:
            return
        if not arb._permits(cand):
            return                           # capped: eviction can't help
        prio = arb.tenant(cand.tenant).priority
        # cheap gate: does any strictly-lower-priority tenant hold
        # resources at all? O(tenants), runs on every starved evaluate
        by_tenant = arb.inf.pods.nonterminal_cpu_by_tenant
        if not any(cpu > 0 and arb.tenant(t).priority < prio
                   for t, cpu in by_tenant.items()):
            return
        sim = arb.inf.pods.sim
        now = sim.now()
        last = self._last_plan_t.get(cand.tenant)
        if last is not None and now - last < self.cooldown_s:
            return
        ac, am = arb.available()
        need_cpu = cand.cpu - ac
        need_mem = cand.mem - am
        if need_cpu <= 0 and need_mem <= 0:
            return                           # not actually blocked
        victims = self._plan(prio, need_cpu, need_mem)
        if victims is None:
            return                           # can't cover the deficit
        self._last_plan_t[cand.tenant] = now
        evicted = []
        for pod in victims:
            if arb.evict(pod.namespace, pod.name):
                evicted.append(pod)
                arb.preemptions += 1
                arb.tenant(pod.tenant).preempted += 1
        arb.preemption_log.append({
            "t": now,
            "tenant": cand.tenant,
            "priority": prio,
            "task": cand.task.id,
            "namespace": cand.namespace,
            "deficit_cpu_m": max(need_cpu, 0),
            "deficit_mem_mi": max(need_mem, 0),
            "victims": [(p.namespace, p.name,
                         p.tenant) for p in evicted],
        })

    def _plan(self, prio: int, need_cpu: int, need_mem: int):
        """Smallest deterministic victim prefix covering the deficit,
        or None when even evicting every eligible pod would not."""
        arb = self.arb
        cands = []
        for pod in arb.inf.pods.lister():
            if pod.phase != RUNNING or pod.labels.get("virtual") == "1":
                continue
            vt = pod.tenant
            vprio = arb.tenant(vt).priority
            if vprio >= prio:
                continue
            cands.append((vprio, -pod.started, pod.namespace, pod.name, pod))
        cands.sort(key=lambda c: c[:4])
        victims = []
        for _vprio, _neg_started, _ns, _name, pod in cands:
            if need_cpu <= 0 and need_mem <= 0:
                break
            victims.append(pod)
            need_cpu -= pod.cpu_m
            need_mem -= pod.mem_mi
        if need_cpu > 0 or need_mem > 0:
            return None
        return victims
