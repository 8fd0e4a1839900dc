"""Reserve stage: the reservation ledger shared by every policy.

A pod granted admission is invisible to the informer cache for one
watch+informer latency window; without a ledger two workflows could
double-spend the same headroom inside it.  The ledger charges cpu/mem
for every pod whose creation is in flight and reconciles against the
informer cache by *candidates only*: a reservation can become droppable
only if its cache entry was written since the last sync (the pod
informer's ``touched`` list — this ledger is its single consumer) or it
was added since then, so the sync is O(changes) while producing exactly
the full scan's drop set (the argument that carried the 10k-workflow
tier, see ``sync``).

Per-tenant cpu AND mem running totals are kept so quota filtering and
dominant-resource ranking read tenant usage at O(1).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core.cluster import PENDING, RUNNING


class ReservationLedger:
    def __init__(self):
        # (ns, pod name) -> (tenant, cpu, mem, reserved_at)
        self.reserved: Dict[Tuple[str, str], Tuple[str, int, int, float]] = {}
        self.cpu = 0
        self.mem = 0
        self.cpu_by_tenant: Dict[str, int] = {}
        self.mem_by_tenant: Dict[str, int] = {}
        self._fresh: List[Tuple[str, str]] = []     # added since last sync

    def reserve(self, namespace: str, name: str, tenant: str,
                cpu: int, mem: int, now: float):
        """Charge headroom for a pod whose creation is in flight but
        not yet visible in the informer cache (idempotent per pod
        name).  The timestamp lets ``release_if_current`` tell which
        incarnation of a reused pod name a reservation belongs to."""
        key = (namespace, name)
        if key not in self.reserved:
            self.reserved[key] = (tenant, cpu, mem, now)
            self.cpu += cpu
            self.mem += mem
            by_c, by_m = self.cpu_by_tenant, self.mem_by_tenant
            by_c[tenant] = by_c.get(tenant, 0) + cpu
            by_m[tenant] = by_m.get(tenant, 0) + mem
            self._fresh.append(key)

    def _uncharge(self, held: Tuple[str, int, int, float]):
        tenant, cpu, mem, _t = held
        self.cpu -= cpu
        self.mem -= mem
        by_c, by_m = self.cpu_by_tenant, self.mem_by_tenant
        left = by_c[tenant] - cpu
        if left:
            by_c[tenant] = left
        else:
            del by_c[tenant]
        left = by_m[tenant] - mem
        if left:
            by_m[tenant] = left
        else:
            del by_m[tenant]

    def drop(self, key: Tuple[str, str]):
        held = self.reserved.pop(key, None)
        if held is not None:
            self._uncharge(held)

    def release_if_current(self, key: Tuple[str, str], pod_created: float):
        """A pod was removed from the apiserver: drop its reservation
        unless the reservation was made *after* the removed pod was
        created — then it belongs to a replacement incarnation (a
        retried pod re-created under the same name before the old
        DELETED event reached the informer) and must survive."""
        held = self.reserved.get(key)
        if held is not None and held[3] <= pod_created:
            self.drop(key)

    def drop_namespace(self, namespace: str):
        for key in [k for k in self.reserved if k[0] == namespace]:
            self.drop(key)

    def sync(self, pods_informer):
        """Drop reservations for pods the informer now sees as
        non-terminal — from that point the informer aggregates account
        for them.  (A FAILED/SUCCEEDED cache entry can be a *previous*
        incarnation of a retried pod name, so it doesn't count.)

        Only candidate keys are checked instead of the whole ledger:
        any key already checked and kept, with an untouched cache
        entry, would be kept again — exactly the full scan's drop set,
        at O(changes) cost."""
        touched = pods_informer.touched
        fresh = self._fresh
        reserved = self.reserved
        if not reserved:
            if touched:
                touched.clear()
            if fresh:
                fresh.clear()
            return
        cache = pods_informer.cache
        for candidates in (touched, fresh):
            for key in candidates:
                held = reserved.get(key)
                if held is None:
                    continue
                pod = cache.get(key)
                if pod is not None and pod.phase in (PENDING, RUNNING):
                    del reserved[key]
                    self._uncharge(held)
        if touched:
            touched.clear()
        if fresh:
            fresh.clear()
