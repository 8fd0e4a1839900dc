"""Stage contracts of the pluggable admission pipeline.

The arbiter (core/resources.py) is a thin driver over four stages,
mirroring the Kubernetes scheduler framework's extension points:

    QueueOrder   which pending request is considered next, and the
                 specialized grant walk over that order
    Filter       hard per-request admission gates consulted inside the
                 walks (tenant quota caps); a filtered request stays
                 pending but never bars other tenants' grants
    Reserve      the reservation ledger charging headroom for pods in
                 the informer-latency window (policy/reservations.py),
                 shared by every policy
    Permit       grant bookkeeping — the arbiter fires the engine's
                 create callback and updates tenant/grant counters
    Preempt      after an evaluate that left a starved high-priority
                 request pending, evict lower-priority RUNNING pods
                 (policy/preemption.py)

``QueueOrder`` subclasses with a specialized ``walk`` run the fast
path; plugins that only implement ``order``/``may_backfill`` run the
generic re-sort loop (the reference semantics every walk must match
bit-for-bit — pinned by tests/test_policy_pipeline.py against hashes
recorded on the pre-pipeline monolith). See policy/README.md for the
full contract a new plugin must honour.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from repro_torch.core.dag import Task


@dataclass(slots=True)
class AdmissionRequest:
    namespace: str
    tenant: str
    task: Task
    create: Callable[[Task], None]
    seq: int
    cpu: int = 0                   # cached task.resource_request()
    mem: int = 0
    deferred: bool = False
    quota_rejected: bool = False   # counted once per request

    def key(self) -> Tuple[str, str]:
        return (self.namespace, self.task.id)


@dataclass
class TenantShare:
    priority: int = 0
    weight: float = 1.0
    quota_cpu_m: int = 0           # hard cap on admitted cpu (0 = none)
    quota_mem_mi: int = 0          # hard cap on admitted mem (0 = none)
    granted: int = 0               # pods admitted over the run
    deferred: int = 0              # requests that had to wait at least once
    quota_rejects: int = 0         # requests ever bounced off the cap
    preempted: int = 0             # RUNNING pods evicted from this tenant

    @property
    def has_quota(self) -> bool:
        return bool(self.quota_cpu_m or self.quota_mem_mi)


class QueueOrder:
    """Ordering stage: owns the policy's index structures and walk.

    The arbiter calls ``on_add``/``on_remove`` as requests enter and
    leave the pending set, and ``walk(ac, am)`` once per evaluate on
    the fast path.  A subclass that does not override ``walk`` runs
    through the generic re-sort loop via ``order``/``may_backfill``
    (the pre-scale-out reference semantics).
    """

    name = "queue-order"
    # ranking depends on state every grant changes — the generic loop
    # must re-order after each grant (fair-share/drf set this)
    dynamic_order = False

    def bind(self, arbiter) -> "QueueOrder":
        self.arb = arbiter
        return self

    # -- index maintenance (fast path) ----------------------------------
    def on_add(self, req: AdmissionRequest):
        pass

    def on_remove(self, req: AdmissionRequest):
        pass

    # -- fast path: specialized walk; overriding enables it -------------
    walk = None                    # type: Optional[Callable]

    # -- starvation probe for the Preempt stage --------------------------
    def starvation_candidate(self) -> Optional[AdmissionRequest]:
        """Highest-urgency pending request the last walk could not
        grant, or None.  Only priority-aware orders implement this —
        preemption needs a victim/beneficiary priority relation."""
        return None

    # -- generic-loop contract (reference + custom policies) -------------
    def order(self, pending: List[AdmissionRequest],
              arbiter) -> List[AdmissionRequest]:
        return sorted(pending, key=lambda r: r.seq)

    def may_backfill(self, blocked: AdmissionRequest,
                     candidate: AdmissionRequest, arbiter) -> bool:
        return True


class LegacyOrder(QueueOrder):
    """Adapter for pre-pipeline policy objects (``order`` +
    ``may_backfill`` and nothing else) — they keep running through the
    generic loop exactly as before."""

    def __init__(self, policy):
        self.policy = policy
        self.name = getattr(policy, "name", type(policy).__name__)
        self.dynamic_order = getattr(policy, "dynamic_order", False)

    def order(self, pending, arbiter):
        return self.policy.order(pending, arbiter)

    def may_backfill(self, blocked, candidate, arbiter):
        return self.policy.may_backfill(blocked, candidate, arbiter)


class AdmissionFilter:
    """Filter stage: a hard gate on individual grants.

    ``permits`` is consulted inside the walks at the exact point the
    headroom fit-check passes.  A rejected request stays pending and is
    re-checked on later evaluates; rejection must NOT bar other
    requests (unlike a headroom block under priority ordering) — a
    tenant at its cap starves only itself.
    """

    name = "filter"

    def bind(self, arbiter) -> "AdmissionFilter":
        self.arb = arbiter
        return self

    def permits(self, req: AdmissionRequest) -> bool:
        return True


@dataclass
class PipelineSpec:
    """Resolved composition of one admission pipeline."""

    order: str = "fifo"            # QUEUE_ORDERS key
    preempt: bool = False          # enable the Preempt stage
    name: str = ""                 # preset name (defaults to order)

    def __post_init__(self):
        if not self.name:
            self.name = self.order
