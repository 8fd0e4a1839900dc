"""Informer: list-watch local cache + listers + event handlers (§3.2).

The KubeAdaptor's central performance mechanism: instead of polling the
apiserver, each Informer subscribes to a watch stream once, mirrors the
objects into a local cache, and fires registered callbacks on state
changes. Listers read the cache at ZERO apiserver cost — compare
``Cluster.api_calls`` between KubeAdaptor and the polling baselines to
see the pressure difference the paper describes.

Scale-out fast path (ISSUE 2): the informer consumes the cluster's
*batched* watch stream (one sim event per kind per delivery instant)
and applies each batch in one cache-sync event; listers serve a
generation-cached list instead of copying the cache per call; handlers
dispatch from per-event-type callback lists built at registration time.
Every cache write is a snapshot, which lets the pod informer maintain
exact running aggregates — non-terminal requested cpu/mem, total and
per tenant — so admission's ``requested()`` is O(1) instead of a cache
scan.

Zero-copy views (ISSUE 5): snapshots are the cluster's
generation-stamped copy-on-write records (``_FastCopy.snapshot``) —
one materialized copy per actual state change, shared by the watch
event, the cache entry, the listers and resync.  A cache write whose
object is identical to the cached entry (the steady-state resync
case) is skipped outright: no generation bump, no lister
invalidation, no aggregate churn, no reservation-sync candidate.  The
skip is exact — an unchanged entry cannot change any aggregate, any
lister's contents, or any reservation's droppability.

Chaos-plane interaction (ISSUE 7): node kill/drain/restore emit node
MODIFIED watch events — the only producers of such events besides
``fail_node``/``restore_node`` — so the node cache, the
generation-cached node lister, and ``ResourceGatherer.allocatable()``
(keyed on ``nodes.generation``) all see cordons the same way they see
any other node change, and the engine's node-update handler re-wakes
admission when capacity returns.  Pods failed by a node loss arrive
as ordinary pod MODIFIED events (phase Failed, ``node_lost=True``),
so the non-terminal requested-resource aggregates shed the lost pods
with no special casing.  Normal runs emit zero node events, which is
why registering the node-update handler costs nothing in bit-identity.

Resync now *reconciles*: keys whose objects vanished from the listed
set without a DELETED watch event (a missed event) are dropped and
their ``on_delete`` handlers fired. A key must be stale for two
consecutive resyncs before it is dropped — one resync interval is far
longer than the watch+informer pipeline, so an in-flight DELETED event
can never race the reconciler and double-fire.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

from repro_torch.core import calibration as cal
from repro_torch.core.cluster import (ADDED, DELETED, PENDING, RUNNING, Cluster,
                                WatchEvent)
from repro_torch.core.sim import Sim

_NON_TERMINAL = (PENDING, RUNNING)


def _key(kind: str, obj: Any) -> Any:
    if kind == "pod":
        return (obj.namespace, obj.name)
    if kind == "pvc":
        return (obj.namespace, obj.name)
    return obj.name


class Informer:
    """One resource kind's cache (podInformer / nodeInformer / ...)."""

    def __init__(self, sim: Sim, cluster: Cluster, kind: str,
                 params: cal.ClusterParams = cal.DEFAULT_PARAMS):
        self.sim = sim
        self.cluster = cluster
        self.kind = kind
        self.p = params
        self.cache: Dict[Any, Any] = {}
        self.events_seen = 0
        self.generation = 0                  # bumps on every cache write
        self._add_cbs: List[Callable] = []
        self._update_cbs: List[Callable] = []
        self._delete_cbs: List[Callable] = []
        self._lister_gen = -1
        self._lister_cache: Dict[Optional[str], List[Any]] = {}
        self._stale_once: Set[Any] = set()   # reconcile grace (see resync)
        # exact running aggregates over the pod cache (snapshots make
        # cache writes the only mutation point, so these always equal a
        # full scan — pinned by tests/test_scale_core.py)
        self._track_pods = kind == "pod"
        self.nonterminal_cpu = 0
        self.nonterminal_mem = 0
        self.nonterminal_cpu_by_tenant: Dict[str, int] = {}
        self.nonterminal_mem_by_tenant: Dict[str, int] = {}
        # keys written (set or pop) since the arbiter last reconciled
        # its reservation ledger — lets the sync touch only keys whose
        # droppability can have changed instead of scanning the ledger
        # (single consumer: policy.ReservationLedger.sync clears)
        self.touched: List[Any] = []
        self._list_fn = {
            "pod": cluster.list_pods,
            "node": cluster.list_nodes,
            "namespace": cluster.list_namespaces,
            "pvc": cluster.list_pvcs,
        }.get(kind, lambda: [])
        cluster.watch_batch(kind, self._on_watch_batch)
        self._initial_list()
        self._schedule_resync()

    # ---- cache writes (the only mutation points) ------------------------
    def _cache_set(self, k: Any, obj: Any):
        old = self.cache.get(k)
        if old is obj:
            return                 # unchanged shared view: nothing to do
        self.generation += 1
        if self._track_pods:
            self.touched.append(k)
            if old is not None and old.phase in _NON_TERMINAL:
                self._untrack(old)
            if obj.phase in _NON_TERMINAL:
                self._track(obj)
        self.cache[k] = obj

    def _cache_pop(self, k: Any) -> Optional[Any]:
        old = self.cache.pop(k, None)
        if old is not None:
            self.generation += 1
            if self._track_pods:
                self.touched.append(k)
                if old.phase in _NON_TERMINAL:
                    self._untrack(old)
        return old

    def _track(self, pod: Any):
        self.nonterminal_cpu += pod.cpu_m
        self.nonterminal_mem += pod.mem_mi
        t = pod.tenant
        by = self.nonterminal_cpu_by_tenant
        by[t] = by.get(t, 0) + pod.cpu_m
        by = self.nonterminal_mem_by_tenant
        by[t] = by.get(t, 0) + pod.mem_mi

    def _untrack(self, pod: Any):
        self.nonterminal_cpu -= pod.cpu_m
        self.nonterminal_mem -= pod.mem_mi
        t = pod.tenant
        self.nonterminal_cpu_by_tenant[t] -= pod.cpu_m
        self.nonterminal_mem_by_tenant[t] -= pod.mem_mi

    # ---- list-watch ------------------------------------------------------
    def _initial_list(self):
        for obj in self._list_fn():
            self._cache_set(_key(self.kind, obj), obj.snapshot())

    def _on_watch_batch(self, evs: List[WatchEvent]):
        # watch_latency already applied by the cluster; informer adds its
        # own processing/cache-sync latency before handlers observe it.
        self.sim.after(self.p.informer_latency, self._apply_batch,
                       note=f"informer:{self.kind}", args=(evs,))

    def _apply_batch(self, evs: List[WatchEvent]):
        """Apply one delivery batch: the fused loop is ``_apply`` per
        event with the cache write inlined (identical event order,
        callbacks and bookkeeping — the function hops were the 10k-tier
        informer profile)."""
        self.events_seen += len(evs)
        cache = self.cache
        track = self._track_pods
        touched = self.touched
        add_cbs, upd_cbs = self._add_cbs, self._update_cbs
        del_cbs = self._delete_cbs
        pod_kind = self.kind == "pod"
        for ev in evs:
            obj = ev.obj
            k = (obj.namespace, obj.name) if pod_kind else _key(self.kind, obj)
            type_ = ev.type
            if type_ == DELETED:
                old = cache.pop(k, None)
                if old is None:
                    continue     # already reconciled away — don't double-fire
                self.generation += 1
                if track:
                    touched.append(k)
                    if old.phase in _NON_TERMINAL:
                        self._untrack(old)
                cbs = del_cbs
            else:
                old = cache.get(k)
                if old is not obj:
                    self.generation += 1
                    if track:
                        touched.append(k)
                        old_live = (old is not None
                                    and old.phase in _NON_TERMINAL)
                        new_live = obj.phase in _NON_TERMINAL
                        # a live->live transition of one pod with
                        # unchanged requests/tenant (Pending->Running,
                        # every pod's hottest update) nets zero on
                        # every aggregate — skip the churn
                        if old_live and new_live \
                                and old.cpu_m == obj.cpu_m \
                                and old.mem_mi == obj.mem_mi \
                                and old.tenant == obj.tenant:
                            pass
                        else:
                            if old_live:
                                self._untrack(old)
                            if new_live:
                                self._track(obj)
                    cache[k] = obj
                cbs = add_cbs if type_ == ADDED else upd_cbs
            for cb in cbs:
                cb(obj)

    def _apply(self, ev: WatchEvent):
        """Single-event reference path (kept for tests/direct callers;
        the batch loop above is its inlined equivalent)."""
        self.events_seen += 1
        k = _key(self.kind, ev.obj)
        type_ = ev.type
        if type_ == DELETED:
            if self._cache_pop(k) is None:
                return       # already reconciled away — don't double-fire
            cbs = self._delete_cbs
        else:
            self._cache_set(k, ev.obj)
            cbs = self._add_cbs if type_ == ADDED else self._update_cbs
        for cb in cbs:
            cb(ev.obj)

    def _schedule_resync(self):
        def resync():
            self._resync_reconcile()      # self-sync §3.2 + stale-key GC
            self._schedule_resync()
        self.sim.after(self.p.resync_interval, resync, daemon=True,
                       note=f"resync:{self.kind}")

    def _resync_reconcile(self):
        listed: Set[Any] = set()
        for obj in self._list_fn():
            k = _key(self.kind, obj)
            listed.add(k)
            # zero-copy: an object unchanged since its last snapshot
            # resyncs to the identical shared view, which _cache_set
            # skips outright
            self._cache_set(k, obj.snapshot())
        stale = [k for k in self.cache if k not in listed]
        drop = [k for k in stale if k in self._stale_once]
        self._stale_once = set(stale).difference(drop)
        for k in drop:
            obj = self._cache_pop(k)
            for cb in self._delete_cbs:
                cb(obj)

    # ---- lister: local-cache reads, no apiserver cost -------------------
    def lister(self, namespace: Optional[str] = None) -> List[Any]:
        """Cached snapshot list, invalidated on cache mutation. Treat
        the returned list as read-only — it is shared between calls."""
        if self._lister_gen != self.generation:
            self._lister_cache.clear()
            self._lister_gen = self.generation
        objs = self._lister_cache.get(namespace)
        if objs is None:
            if namespace is not None and self.kind in ("pod", "pvc"):
                objs = [o for o in self.cache.values()
                        if o.namespace == namespace]
            else:
                objs = list(self.cache.values())
            self._lister_cache[namespace] = objs
        return objs

    def get(self, key) -> Optional[Any]:
        return self.cache.get(key)

    def add_handlers(self, on_add=None, on_update=None, on_delete=None):
        if on_add:
            self._add_cbs.append(on_add)
        if on_update:
            self._update_cbs.append(on_update)
        if on_delete:
            self._delete_cbs.append(on_delete)


class InformerSet:
    """The paper's podInformer + nodeInformer + namespaceInformer."""

    def __init__(self, sim: Sim, cluster: Cluster,
                 params: cal.ClusterParams = cal.DEFAULT_PARAMS):
        self.pods = Informer(sim, cluster, "pod", params)
        self.nodes = Informer(sim, cluster, "node", params)
        self.namespaces = Informer(sim, cluster, "namespace", params)
        self.pvcs = Informer(sim, cluster, "pvc", params)
