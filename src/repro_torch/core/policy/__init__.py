"""Pluggable admission pipeline (see README.md for the stage contract).

Policy names resolve through two registries:

* ``QUEUE_ORDERS`` — ordering plugins: fifo, fifo-merge, priority,
  fair-share, drf.
* ``POLICY_PRESETS`` — every name ``ControlPlane(admission_policy=...)``
  accepts: fifo/priority/fair-share/drf plus composite presets that
  switch on extra stages (``quota`` = fifo-merge ordering — per-tenant
  FIFO queues, O(1) per capped tenant per round — with caps expected
  from the tenancy knobs; ``preempt`` = priority ordering with the
  Preempt stage armed).

The Filter stage (quota caps) is always present but short-circuits
until a tenant registers a cap, so orderings and caps compose freely —
``fair-share`` with quotas is valid, ``quota`` without caps degrades
to fifo.
"""
from __future__ import annotations

from repro_torch.core.policy.filters import TenantQuotaFilter
from repro_torch.core.policy.ordering import (QUEUE_ORDERS, DominantShareOrder,
                                        FairShareOrder, FifoMergeOrder,
                                        FifoOrder, PriorityOrder)
from repro_torch.core.policy.pipeline import (AdmissionFilter, AdmissionRequest,
                                        LegacyOrder, PipelineSpec, QueueOrder,
                                        TenantShare)
from repro_torch.core.policy.preemption import Preemptor
from repro_torch.core.policy.reservations import ReservationLedger

POLICY_PRESETS = {
    "fifo": PipelineSpec(order="fifo"),
    "priority": PipelineSpec(order="priority"),
    "fair-share": PipelineSpec(order="fair-share"),
    "drf": PipelineSpec(order="drf"),
    "quota": PipelineSpec(order="fifo-merge", name="quota"),
    "preempt": PipelineSpec(order="priority", preempt=True, name="preempt"),
}


def resolve_policy(policy) -> PipelineSpec:
    """Accept a preset name, a PipelineSpec, a QueueOrder (class or
    instance), or a legacy order/may_backfill object."""
    if isinstance(policy, str):
        if policy not in POLICY_PRESETS:
            raise KeyError(policy)
        return POLICY_PRESETS[policy]
    if isinstance(policy, PipelineSpec):
        return policy
    return policy            # instantiated by the arbiter (see make_order)


def make_order(policy) -> QueueOrder:
    """Instantiate the QueueOrder for any accepted ``policy`` form."""
    spec = resolve_policy(policy)
    if isinstance(spec, PipelineSpec):
        return QUEUE_ORDERS[spec.order]()
    if isinstance(spec, type):
        spec = spec()
    if isinstance(spec, QueueOrder):
        return spec
    return LegacyOrder(spec)  # pre-pipeline policy object


__all__ = [
    "AdmissionFilter", "AdmissionRequest", "DominantShareOrder",
    "FairShareOrder", "FifoMergeOrder", "FifoOrder", "LegacyOrder",
    "PipelineSpec", "POLICY_PRESETS", "Preemptor", "PriorityOrder",
    "QUEUE_ORDERS", "QueueOrder", "ReservationLedger", "TenantQuotaFilter",
    "TenantShare", "make_order", "resolve_policy",
]
