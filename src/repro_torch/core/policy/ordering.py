"""QueueOrder plugins: the admission-ordering stage.

fifo / priority / fair-share are the pre-pipeline monolith's three
policies, relocated here with their specialized O(1)-ish walks intact —
the executed grant sequence is bit-identical to the monolith (pinned
hashes in tests/test_policy_pipeline.py and tests/test_scale_core.py).
``drf`` is the first post-pipeline plugin: dominant-resource fair
share, closing the "fair-share ranks by CPU only" gap — a tenant's
rank is its *dominant* share, max(cpu/allocatable_cpu,
mem/allocatable_mem), divided by its weight.

Every walk reproduces the generic re-sort loop's grant sequence
EXACTLY (same order, same deferral counts): fifo walks the seq-ordered
pending dict; priority walks a bisect-maintained (-priority, seq) list
and stops once a blocked higher class makes further grants illegal;
fair-share and drf lazily merge per-tenant FIFO queues through a heap,
identical to sorting every request by (ratio, seq).  All stop early
when headroom is below the smallest pending request.  The Filter stage
hooks into each walk at the exact point the headroom fit-check passes
(``arb._permits``); with no quotas registered it is a constant-time
no-op, so legacy runs cannot diverge.
"""
from __future__ import annotations

import heapq
from bisect import bisect_left, insort
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.policy.pipeline import AdmissionRequest, QueueOrder


class FifoOrder(QueueOrder):
    name = "fifo"

    def order(self, pending: List[AdmissionRequest],
              arbiter) -> List[AdmissionRequest]:
        return sorted(pending, key=lambda r: r.seq)

    def may_backfill(self, blocked, candidate, arbiter) -> bool:
        # FIFO is work-conserving: smaller later tasks may slip past a
        # blocked one (the paper gatherer's greedy behaviour)
        return True

    def walk(self, ac: int, am: int):
        # generic fifo: one pass in seq order, always-backfill — i.e.
        # first-fit down the queue. The pending dict IS seq-ordered, so
        # walk it directly; pending deletion is deferred past the loop
        # (grants never mutate the dict — the engine's create path only
        # schedules sim events and charges reservations).
        arb = self.arb
        if arb._no_fit_possible(ac, am):
            return
        grants: List[AdmissionRequest] = []
        for req in arb.pending.values():
            if req.cpu <= ac and req.mem <= am and arb._permits(req):
                grants.append(req)
                arb._counters_remove(req)
                if arb._create_bookkeep(req):
                    ac -= req.cpu
                    am -= req.mem
                    if arb._no_fit_possible(ac, am):
                        break      # nothing further can fit
        for req in grants:
            del arb.pending[req.key()]


class PriorityOrder(QueueOrder):
    name = "priority"

    def __init__(self):
        # (-tenant priority, seq, request), bisect-sorted
        self._order: List[Tuple[int, int, AdmissionRequest]] = []

    def order(self, pending: List[AdmissionRequest],
              arbiter) -> List[AdmissionRequest]:
        def rank(r: AdmissionRequest):
            return (-arbiter.tenant(r.tenant).priority, r.seq)
        return sorted(pending, key=rank)

    def may_backfill(self, blocked, candidate, arbiter) -> bool:
        # never jump a *higher*-priority blocked request — a stream of
        # small low-priority tasks must not starve a big high-priority
        # one; backfill within the same class is fine (FIFO there)
        return (arbiter.tenant(candidate.tenant).priority
                >= arbiter.tenant(blocked.tenant).priority)

    def on_add(self, req: AdmissionRequest):
        insort(self._order,
               (-self.arb.tenant(req.tenant).priority, req.seq, req))

    def on_remove(self, req: AdmissionRequest):
        order = self._order
        # seq is unique, so tuple comparison never reaches the
        # request; a 2-tuple probe sorts just before its entry
        i = bisect_left(order, (-self.arb.tenant(req.tenant).priority,
                                req.seq))
        if i < len(order) and order[i][2] is req:
            del order[i]
        else:   # priority changed since insert: find by identity
            for j, entry in enumerate(order):
                if entry[2] is req:
                    del order[j]
                    break

    def starvation_candidate(self) -> Optional[AdmissionRequest]:
        # head of the (-priority, seq) order = the highest-priority
        # oldest pending request; after a walk it is blocked by
        # headroom or quota (anything fitting was granted)
        arb = self.arb
        order = self._order
        while order:
            req = order[0][2]
            if arb.pending.get(req.key()) is not req:
                del order[0]       # ghost entry from a grant/forget
                continue
            return req
        return None

    def walk(self, ac: int, am: int):
        # generic priority: one pass in (-priority, seq) order; a
        # blocked request bars every strictly-lower class behind it, so
        # the walk may stop at the first lower class after a block.
        # A quota-capped request is skipped WITHOUT barring lower
        # classes — it starves on its own cap, not on shared headroom.
        arb = self.arb
        if arb._no_fit_possible(ac, am):
            return
        order = self._order
        grants: List[AdmissionRequest] = []
        max_blocked_prio: Optional[int] = None
        i = 0
        while i < len(order):
            req = order[i][2]
            if arb.pending.get(req.key()) is not req:
                del order[i]       # ghost entry from a priority change
                continue
            prio = arb.tenant(req.tenant).priority
            if max_blocked_prio is not None and prio < max_blocked_prio:
                break              # all remaining are lower still
            if req.cpu <= ac and req.mem <= am:
                if not arb._permits(req):
                    i += 1
                    continue
                del order[i]
                grants.append(req)
                arb._counters_remove(req)
                if arb._create_bookkeep(req):
                    ac -= req.cpu
                    am -= req.mem
                    if arb._no_fit_possible(ac, am):
                        break
                continue           # entries shifted left: same index
            if max_blocked_prio is None or prio > max_blocked_prio:
                max_blocked_prio = prio
            i += 1
        for req in grants:
            del arb.pending[req.key()]


class _TenantMergeOrder(QueueOrder):
    """Shared lazy-merge walk over per-tenant FIFO queues.

    The generic dynamic-order loop re-sorts all requests by
    (ratio, seq) and grants the first fit, once per grant.  The merge
    pops requests in exactly that order (seq ties across equal-ratio
    tenants included) without materializing it.  Subclasses define the
    per-round usage snapshot and the tenant ranking over it.

    Batched multi-grant (ISSUE 5): one walk call grants EVERY fitting
    request.  The pre-batched walk re-entered per grant — a fresh
    usage snapshot (O(tenants) dict copies + a ledger sync) and a full
    heap rebuild each time, the per-grant constant that capped the
    >100k-workflow tier.  The single-pass walk instead updates
    incrementally after each grant, which is EXACTLY the generic
    loop's re-sort semantics because within one evaluate:

    * headroom only shrinks, so a request that already failed its
      fit-check can never fit later in the pass — re-checking it (what
      a round restart does) cannot grant it;
    * a grant changes only the GRANTING tenant's usage (the informer
      cache cannot move mid-evaluate; the only ledger change is the
      grant's own reservation), and ``_rank`` depends only on the
      tenant's own usage entry — so re-ranking the whole heap equals
      re-ranking that one tenant;
    * ``_walk_sync`` after each grant runs the same O(changes) ledger
      sync the per-round ``_round_usage`` ran (its only live candidate
      is the reservation just charged), so quota/rank state matches
      the round-restart value even when the reservation is immediately
      dropped against a stale non-terminal cache entry;
    * the granting tenant re-enters at its HEAD (not past the granted
      position): its earlier requests must be re-probed under the
      tenant's increased usage — a quota cap that now binds at the
      head sits the tenant out for the rest of the pass, exactly as a
      round restart would.

    Equivalence is pinned by the fast==generic tests for fair-share,
    drf, and the capped merge walks (tests/test_scale_core.py,
    tests/test_policy_pipeline.py, tests/test_informer_views.py).
    Contract for subclasses: ``_rank(tenant, usage)`` and
    ``_walk_rank(tenant)`` must read only ``tenant``'s own usage —
    that locality is what makes frozen-at-push heap ranks exact.
    """

    dynamic_order = True
    # False = strict FIFO inside a tenant: nothing passes a blocked
    # head for ANY reason (the fifo-merge/quota discipline)
    intra_tenant_backfill = True

    def __init__(self):
        # per-tenant FIFO of requests (lazy-deleted during the walk)
        self._by_tenant: Dict[str, Deque[AdmissionRequest]] = {}

    def on_add(self, req: AdmissionRequest):
        self._by_tenant.setdefault(req.tenant, deque()).append(req)

    # fair-share per-tenant deques are lazy-deleted during the walk:
    # on_remove is a no-op

    def _round_usage(self):
        """Usage snapshot for the generic order() reference path; must
        trigger the same reservation sync the walk's ``_walk_sync``
        does."""
        raise NotImplementedError

    def _rank(self, tenant: str, usage) -> float:
        raise NotImplementedError

    # -- walk-path ranking: live references instead of per-walk copies.
    # A rank read at heap-push time equals the copied-snapshot rank at
    # the same instant, and between pushes only the GRANTING tenant's
    # entries move (reserve() updates the ledger maps in place), so
    # frozen-at-push heap entries stay exactly the generic pass's
    # ranks.  Ledger re-sync after a grant is O(changes): its only
    # live candidate is the reservation the grant just charged.
    def _walk_sync(self):
        arb = self.arb
        arb.ledger.sync(arb.inf.pods)

    def _walk_rank(self, tenant: str) -> float:
        raise NotImplementedError

    def order(self, pending: List[AdmissionRequest],
              arbiter) -> List[AdmissionRequest]:
        usage = self._round_usage()

        def rank(r: AdmissionRequest):
            return (self._rank(r.tenant, usage), r.seq)
        ordered = sorted(pending, key=rank)
        if not arbiter._quota_active:
            return ordered
        # head-of-line under caps, mirroring the walk: once a tenant's
        # first-ranked request is quota-blocked (checked BEFORE the
        # headroom fit, same as the walk's pop), the tenant
        # contributes nothing more this pass.  _permits is the
        # counting probe — both paths count the same blocked heads,
        # once per request.
        out: List[AdmissionRequest] = []
        capped: set = set()
        for r in ordered:
            if r.tenant in capped:
                continue
            if not arbiter._permits(r):
                capped.add(r.tenant)
                continue
            out.append(r)
        return out

    def may_backfill(self, blocked, candidate, arbiter) -> bool:
        return True

    def walk(self, ac: int, am: int):
        arb = self.arb
        pending = arb.pending
        by_tenant = self._by_tenant
        if not pending:
            return
        # one sync per WALK (the per-round re-sync it replaces is a
        # no-op mid-evaluate except for grant reservations, which are
        # re-synced at O(changes) after each grant)
        self._walk_sync()
        if arb._no_fit_possible(ac, am):
            return
        rank = self._walk_rank
        heap = []
        for tenant, q in by_tenant.items():
            while q and pending.get(q[0].key()) is not q[0]:
                q.popleft()        # granted/forgotten leftovers
            if q:
                heap.append((rank(tenant), q[0].seq, tenant, 0))
        heapq.heapify(heap)
        backfill = self.intra_tenant_backfill
        while heap:
            ratio, _seq, tenant, idx = heapq.heappop(heap)
            q = by_tenant[tenant]
            req = q[idx]           # push-time staleness check keeps
            #                        entries live
            if not arb._permits(req):
                # quota head-of-line (checked before the headroom
                # fit): the tenant sits out this pass — its queue
                # is NOT re-scanned behind the capped head (at a
                # 1000-workflow backlog that rescan made every
                # evaluate O(pending))
                continue
            if req.cpu <= ac and req.mem <= am:
                if arb._grant(req):
                    ac -= req.cpu
                    am -= req.mem
                # batched multi-grant: keep walking instead of
                # re-entering.  Only this tenant's rank can have
                # changed; it restarts at its head (see class doc).
                self._walk_sync()
                if arb._no_fit_possible(ac, am):
                    return
                while q and pending.get(q[0].key()) is not q[0]:
                    q.popleft()
                if q:
                    heapq.heappush(heap, (rank(tenant), q[0].seq, tenant, 0))
                continue
            if not backfill:
                continue           # strict FIFO within the tenant
            nxt = idx + 1
            while nxt < len(q) and pending.get(q[nxt].key()) is not q[nxt]:
                nxt += 1
            if nxt < len(q):
                heapq.heappush(heap, (ratio, q[nxt].seq, tenant, nxt))


class FifoMergeOrder(_TenantMergeOrder):
    """FIFO admission realized as a k-way merge of per-tenant queues —
    the ``quota`` preset's ordering.  Discipline: strict FIFO inside a
    tenant (nothing passes a blocked head — a tenant at its quota cap
    or out of headroom waits in line), arrival order across tenant
    heads, work-conserving across tenants.  Unlike the global ``fifo``
    walk, a capped tenant costs O(1) per round instead of an
    O(own-backlog) rescan per evaluate, which is what lets hard quotas
    run at the 1000-workflow tier."""

    name = "fifo-merge"
    intra_tenant_backfill = False

    def _round_usage(self):
        # ranking ignores usage, but the quota filter reads the
        # reservation ledger + informer aggregates: sync once per
        # walk, the same cadence every dynamic-order policy keeps
        arb = self.arb
        arb.ledger.sync(arb.inf.pods)
        return None

    def _rank(self, tenant: str, usage) -> float:
        return 0.0                 # heap ties on head seq = arrival order

    def _walk_rank(self, tenant: str) -> float:
        return 0.0

    def order(self, pending: List[AdmissionRequest],
              arbiter) -> List[AdmissionRequest]:
        # generic-loop reference: only tenant HEADS are candidates
        # (strict intra-tenant FIFO), merged in arrival order; a
        # quota-blocked head drops its tenant from the pass (counted
        # by the _permits probe, exactly like the walk's pop)
        self._round_usage()
        heads: Dict[str, AdmissionRequest] = {}
        for r in pending:
            h = heads.get(r.tenant)
            if h is None or r.seq < h.seq:
                heads[r.tenant] = r
        out = sorted(heads.values(), key=lambda r: r.seq)
        if arbiter._quota_active:
            out = [r for r in out if arbiter._permits(r)]
        return out


class FairShareOrder(_TenantMergeOrder):
    """Weighted max-min: most-underserved tenant (in-use cpu / weight)
    goes first; FIFO inside a tenant."""

    name = "fair-share"

    def _round_usage(self):
        return self.arb.tenant_usage_cpu()

    def _rank(self, tenant: str, usage) -> float:
        share = self.arb.tenant(tenant)
        return usage.get(tenant, 0) / max(share.weight, 1e-9)

    def _walk_rank(self, tenant: str) -> float:
        arb = self.arb
        held = (arb.inf.pods.nonterminal_cpu_by_tenant.get(tenant, 0)
                + arb.ledger.cpu_by_tenant.get(tenant, 0))
        return held / max(arb.tenant(tenant).weight, 1e-9)


class DominantShareOrder(_TenantMergeOrder):
    """Dominant-resource fairness (DRF): rank tenants by their dominant
    share — max(cpu held / allocatable cpu, mem held / allocatable mem)
    — divided by weight.  A memory-hog tenant can no longer monopolize
    the cluster by looking underserved on the CPU axis."""

    name = "drf"

    def _round_usage(self):
        cpu_map, mem_map = self.arb.tenant_usage()
        cpu_a, mem_a = self.arb.allocatable()
        return (cpu_map, mem_map, max(cpu_a, 1), max(mem_a, 1))

    def _rank(self, tenant: str, usage) -> float:
        cpu_map, mem_map, cpu_a, mem_a = usage
        share = self.arb.tenant(tenant)
        dominant = max(cpu_map.get(tenant, 0) / cpu_a,
                       mem_map.get(tenant, 0) / mem_a)
        return dominant / max(share.weight, 1e-9)

    def _walk_rank(self, tenant: str) -> float:
        arb = self.arb
        pods = arb.inf.pods
        ledger = arb.ledger
        cpu_a, mem_a = arb.allocatable()
        cpu = (pods.nonterminal_cpu_by_tenant.get(tenant, 0)
               + ledger.cpu_by_tenant.get(tenant, 0))
        mem = (pods.nonterminal_mem_by_tenant.get(tenant, 0)
               + ledger.mem_by_tenant.get(tenant, 0))
        dominant = max(cpu / max(cpu_a, 1), mem / max(mem_a, 1))
        return dominant / max(arb.tenant(tenant).weight, 1e-9)


QUEUE_ORDERS = {
    "fifo": FifoOrder,
    "fifo-merge": FifoMergeOrder,
    "priority": PriorityOrder,
    "fair-share": FairShareOrder,
    "drf": DominantShareOrder,
}
