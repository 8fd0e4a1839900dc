"""Filter stage plugins: hard per-tenant admission caps.

``TenantQuotaFilter`` enforces the ROADMAP's "hard caps enforced at
admission, not just shares": a tenant's *admitted* usage — informer
visible non-terminal pods plus not-yet-visible reservations — may
never exceed its registered quota, under ANY ordering policy.  The
check runs at the exact point a walk's headroom fit-check passes, so
with no quotas registered (``arbiter`` short-circuits before the
filter is consulted) legacy runs cannot diverge.

Scope: the cap gates *admission*.  Retried pods and speculative twins
re-reserve without re-admission (fault tolerance must not deadlock on
a full quota); they are bounded by the admission the original pod
passed, plus at most one twin.
"""
from __future__ import annotations

from repro_torch.core.policy.pipeline import AdmissionFilter, AdmissionRequest


class TenantQuotaFilter(AdmissionFilter):
    name = "tenant-quota"

    def permits(self, req: AdmissionRequest) -> bool:
        arb = self.arb
        share = arb.tenant(req.tenant)
        qc, qm = share.quota_cpu_m, share.quota_mem_mi
        if not qc and not qm:
            return True
        pods = arb.inf.pods
        ledger = arb.ledger
        tenant = req.tenant
        if qc:
            used = (pods.nonterminal_cpu_by_tenant.get(tenant, 0)
                    + ledger.cpu_by_tenant.get(tenant, 0))
            if used + req.cpu > qc:
                return False
        if qm:
            used = (pods.nonterminal_mem_by_tenant.get(tenant, 0)
                    + ledger.mem_by_tenant.get(tenant, 0))
            if used + req.mem > qm:
                return False
        return True
