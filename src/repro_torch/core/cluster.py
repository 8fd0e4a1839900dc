"""The level-2 cluster: an apiserver + disordered scheduler analogue.

Faithful to the properties the paper builds on:
  * the scheduler is DISORDERED, SCATTERED and UNPREDICTABLE (§3.1):
    each cycle it visits pending pods in random order and scatters them
    over shuffled nodes first-fit — it knows nothing about task
    dependencies (Fig 1's problem);
  * every API interaction costs ``api_latency`` (the apiserver-pressure
    effect the Informer exists to avoid);
  * watch streams deliver object events with ``watch_latency``;
  * pods hold node resources from bind to completion; Succeeded/Failed
    pods release compute but keep their object until deleted (pressure
    on anyone who forgets GC, like the paper's baselines).

Payloads: virtual (declared seconds) or real callables whose wall time
feeds the virtual clock (see core/sim.py).

Scale-out notes (1000 workflows / 100 nodes — see ISSUE 2):
  * a dedicated pending-pod index replaces the per-cycle scan of every
    pod object still alive in the apiserver, and one reusable node
    array (reset to the canonical order each cycle, like the fresh
    ``list(...)`` it replaces) takes the per-pod allocation out of the
    scatter loop;
  * the scatter shuffle burns the exact word stream of the seeded RNG
    via ``ExactShuffler`` — same binding sequence bit-for-bit (pinned
    by tests/test_scale_core.py) — and skips the first-fit scan (never
    the draws) for pods that provably fit no node;
  * watch fan-out batches same-instant events per kind into one sim
    event, with one object snapshot per notification, delivered at the
    same virtual times as the per-event path it replaces.

Pod-lifecycle fast path (10k workflows / 1000 nodes — see ISSUE 3):
the create→bind→running→succeeded→delete chain used to cost one sim
event per pod per hop.  Every hop's *due time* is fixed by a constant
latency, so same-instant hops coalesce into compound batch events that
replay the per-pod callbacks in the exact order the chained events
would have executed:

  * pod creations scheduled at one instant share one apiserver event
    (``_flush_creates``), and deletions share a two-stage batch
    (lookup at +api_latency, removal at +pod_delete_latency);
  * all pods bound in one scheduler cycle start in ONE compound event
    (``_start_batch``) that applies the running transitions, emits the
    watch notifications, and schedules one ``_finish_batch`` per
    distinct completion instant — the timeline of every bound pod is
    determined at bind time (virtual payloads), so the whole
    remaining lifecycle is scheduled in a single pass.

Exactness argument: consecutive hops of one instant draw consecutive
sim sequence numbers (nothing else can schedule between them), so a
batch that replays them back-to-back preserves every same-instant
ordering; hops whose sequence numbers shift (e.g. a finish group
scheduled after its siblings' notifications) only target instants
reachable from distinct constant-latency sums, where no foreign event
can sit between the old and new position.  ``lifecycle="chained"``
(or ``REPRO_LIFECYCLE=chained``) restores the one-event-per-hop path;
tests/test_event_core.py pins both paths to identical binding
sequences and metrics, and tests/test_scale_core.py's pinned hashes
run on the fast path.

Usage accounting: the cluster maintains exact in-use cpu/mem totals
(``cpu_in_use``/``mem_in_use``, updated at bind/release) so ``used()``
is O(1), and fires ``on_usage_change`` after every change — the
event-driven usage accumulator in core/metrics.py hangs off this hook
instead of polling a 0.5 s sampler.  The bind/release path also keeps
per-tenant holding cpu AND mem (quota/DRF accounting, ISSUE 4), and
``evict_pod`` is the admission pipeline's preemption primitive: a
RUNNING pod is killed and released immediately, surfacing as FAILED
with ``evicted=True`` so the engine re-queues the task through
admission without charging the retry budget.

Utilization-scored placement (ISSUE 8): ``placement="scored-spread"``
(least-allocated, the K3s CPU-aware spread) or ``"scored-pack"``
replaces ONLY the first-fit pick inside the scatter cycle — every
shuffle still consumes the identical word stream, so
``placement="first-fit"`` (the default) stays bit-identical to every
pinned binding hash and a scored run is reproducible on both the
native and pure-Python backends.  Node capacities are per node
throughout (heterogeneous ``NodeClass`` mixes flow straight through
the free/ready mirrors, ``kill_node``/``drain_node``/``restore_node``
included); ``node_peak_util``/``hotspot_summary()`` track per-node
bind-time high-water marks, and ``rebalance_evict`` is the periodic
descheduler's offload primitive (``rebalanced=True`` pods requeue
through admission with no retry-budget charge).

Elastic provisioning (ISSUE 9): every node carries a ``provisioned``
bit orthogonal to ``ready``.  The full max roster is materialized at
construction (fixed native-mirror indices), and the autoscaler
(core/autoscaler.py) flips membership with
:meth:`provision_node`/:meth:`deprovision_node` — restore_node-style
ready/free-array writes on the way up, the ``drain_node`` eviction
path on the way down.  A node deprovisioned while chaos holds it down
is NOT resurrected by ``restore_node`` (the autoscaler owns it until
re-provisioned).  The cluster keeps O(1) provisioned-capacity area
integrals (node-, mcore- and MiB-seconds plus in-use areas, windowed
to ``last_event_t`` exactly like the per-node utilization integrals)
so :meth:`cost_summary` reports the cost axis — node-seconds and
time-weighted utilization over *provisioned* time — mergeable across
shards by plain summation.
"""
from __future__ import annotations

import ctypes
import os
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import calibration as cal
from repro_torch.core.shuffle import ExactShuffler
from repro_torch.core.sim import Sim, measure_wall
from repro_torch.core.stats import StreamingStat

PENDING, RUNNING, SUCCEEDED, FAILED = "Pending", "Running", "Succeeded", "Failed"
ADDED, MODIFIED, DELETED = "ADDED", "MODIFIED", "DELETED"

# objects materialized by _FastCopy.snapshot()/clone() since import —
# benchmarks report the delta per run as `informer_copies` (the copy
# traffic the zero-copy views avoid; see ISSUE 5)
SNAPSHOTS_MADE = 0


class _FastCopy:
    """Generation-stamped copy-on-write snapshots (zero-copy informer
    views, ISSUE 5).

    Every mutation of a watched object bumps its revision stamp
    ``_rv``; ``snapshot()`` returns an immutable view of the current
    state, materializing a copy ONLY when a field actually changed
    since the last snapshot — consecutive snapshots of an unchanged
    object are the SAME object, so the informer's resync reconcile,
    its listers and its running aggregates all read shared structures
    instead of per-call clones.  A handed-out snapshot is never
    mutated again (the next mutation bumps ``_rv`` and the next
    snapshot materializes fresh), which preserves the PR-2 guarantee
    that no handler or lister caller can observe future live-object
    state — pinned by tests/test_informer_views.py.

    Code outside cluster.py that mutates a watched field directly must
    bump ``obj._rv`` itself (the cluster's own mutation points all
    do).
    """

    _rv = 0                        # revision stamp (bumped per mutation)
    _snap = None                   # cached snapshot of revision _snap._rv

    def __copy__(self):
        global SNAPSHOTS_MADE
        SNAPSHOTS_MADE += 1
        new = object.__new__(type(self))
        d = new.__dict__
        d.update(self.__dict__)
        d.pop("_snap", None)       # snapshots never chain to older ones
        return new

    clone = __copy__

    def snapshot(self):
        """The current state as an immutable shared view (copy-on-write)."""
        snap = self._snap
        if snap is not None and snap._rv == self._rv:
            return snap
        snap = self.__copy__()
        self._snap = snap
        return snap


@dataclass
class NodeObj(_FastCopy):
    name: str
    cpu_alloc: int
    mem_alloc: int
    cpu_used: int = 0
    mem_used: int = 0
    ready: bool = True
    provisioned: bool = True          # autoscaler pool membership (ISSUE 9)
    slow_factor: float = 1.0          # straggler injection for tests

    def fits(self, cpu: int, mem: int) -> bool:
        return (self.ready and self.cpu_used + cpu <= self.cpu_alloc
                and self.mem_used + mem <= self.mem_alloc)


@dataclass
class PodObj(_FastCopy):
    name: str
    namespace: str
    task_id: str
    workflow: str
    cpu_m: int
    mem_mi: int
    duration_s: float = 0.0
    payload: Optional[Callable[[], Any]] = None
    volume: Optional[str] = None       # PVC name (mount adds latency)
    labels: Dict[str, str] = field(default_factory=dict)
    tenant: str = "default"            # denormalized labels["tenant"] —
    #                                    read on every bind/release/track

    def __post_init__(self):
        if self.tenant == "default" and self.labels:
            self.tenant = self.labels.get("tenant", "default")
    phase: str = PENDING
    node: Optional[str] = None
    created: float = 0.0
    scheduled: float = -1.0
    started: float = -1.0
    finished: float = -1.0
    deleted: float = -1.0
    restarts: int = 0
    evicted: bool = False              # preempted by the admission pipeline
    node_lost: bool = False            # evicted because its node died
    rebalanced: bool = False           # evicted by the descheduler
    _holding: bool = False             # currently holds node resources


@dataclass
class NamespaceObj(_FastCopy):
    name: str
    created: float = 0.0
    deleted: float = -1.0


@dataclass
class PVCObj(_FastCopy):
    name: str
    namespace: str
    bound: bool = False
    created: float = 0.0


class WatchEvent:
    """One watch-stream record (``__slots__``: allocated per event on
    the hot pod-lifecycle path)."""

    __slots__ = ("kind", "type", "obj")

    def __init__(self, kind: str, type: str, obj: Any):
        self.kind = kind     # "pod" | "node" | "namespace" | "pvc"
        self.type = type     # ADDED | MODIFIED | DELETED
        self.obj = obj


class Cluster:
    # placement -> score mode of the fused cycle (0 first-fit scan,
    # 1 spread = maximize post-bind free fraction, 2 pack = minimize)
    PLACEMENTS = {"first-fit": 0, "scored-spread": 1, "scored-pack": 2,
                  "scored": 1}         # "scored" = the spread variant
    SCORE_SCALE = 1 << 20              # integer fixed-point (C mirror)

    def __init__(self, sim: Sim, params: cal.ClusterParams = cal.DEFAULT_PARAMS,
                 cluster_cfg: cal.PaperCluster = cal.DEFAULT_CLUSTER,
                 payload_mode: str = "virtual", seed: int = 0,
                 retain_pod_log: bool = True,
                 lifecycle: Optional[str] = None,
                 placement: str = "first-fit"):
        self.sim = sim
        self.p = params
        if lifecycle is None:
            lifecycle = os.environ.get("REPRO_LIFECYCLE", "fast")
        if lifecycle not in ("fast", "chained"):
            raise ValueError(f"unknown lifecycle {lifecycle!r}; "
                             f"expected 'fast' or 'chained'")
        self.lifecycle = lifecycle
        if placement not in self.PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r}; "
                             f"expected one of {sorted(self.PLACEMENTS)}")
        self.placement = "scored-spread" if placement == "scored" \
            else placement
        self._score_mode = self.PLACEMENTS[placement]
        self._fast = lifecycle == "fast"
        self._watch_lat = params.watch_latency   # hoisted: read per notify
        self.payload_mode = payload_mode
        self.rng = random.Random(seed)
        # sole consumer of self.rng (see shuffle.py buffering contract)
        self._shuffler = ExactShuffler(self.rng)
        self.nodes: Dict[str, NodeObj] = {
            name: NodeObj(name, cpu, mem) for name, cpu, mem in cluster_cfg.nodes()}
        self.pods: Dict[Tuple[str, str], PodObj] = {}
        self.namespaces: Dict[str, NamespaceObj] = {}
        self.pvcs: Dict[Tuple[str, str], PVCObj] = {}
        # per-namespace pvc keys: the teardown cascade and namespaced
        # lists must not scan every live workflow's volume
        self._pvcs_by_ns: Dict[str, List[Tuple[str, str]]] = {}
        self._watchers: Dict[str, List[Callable[[WatchEvent], None]]] = {}
        self._batch_watchers: Dict[str, List[Callable]] = {}
        self._watched: Dict[str, bool] = {}   # any watcher of this kind?
        # kind -> (delivery time, events) for the open same-instant batch
        self._watch_buf: Dict[str, Tuple[float, List[WatchEvent]]] = {}
        self._sched_scheduled = False
        # fast-lifecycle coalescing buffers: (due instant, open batch)
        self._create_buf: Optional[Tuple[float, List]] = None
        self._del_buf: Optional[Tuple[float, List]] = None
        self._start_buf: Optional[Tuple[float, List[PodObj]]] = None
        self.api_calls = 0                   # apiserver pressure counter
        self.pods_created = 0                # pods accepted by the apiserver
        self.retain_pod_log = retain_pod_log
        self.pod_log: List[PodObj] = []      # every pod ever (metrics)
        self.exec_stat = StreamingStat()     # pod create->delete (Succeeded)
        # exact in-use totals (mirror of the node scan) + change hook
        self.cpu_in_use = 0
        self.mem_in_use = 0
        self.on_usage_change: Optional[Callable[[Optional[str]], None]] = None
        # scheduler indexes: unbound Pending pods in creation order (the
        # same visit order as the old full-pod scan), reusable node array
        self._pending_pods: Dict[Tuple[str, str], PodObj] = {}
        self._pods_by_ns: Dict[str, Dict[Tuple[str, str], PodObj]] = {}
        self._node_seq: List[NodeObj] = list(self.nodes.values())
        self._node_perm = self._shuffler.make_perm(len(self._node_seq))
        if self._shuffler.has_native_cycle:
            n = len(self._node_seq)
            # free-capacity mirrors of the node objects, maintained
            # incrementally at bind/release/fail/restore (absolute
            # writes, so the in-place charging the native cycle already
            # did is simply re-asserted) — the per-cycle O(nodes)
            # refill dominated the 1000-node scheduler profile.
            # Every mirror is PER NODE (heterogeneous capacities flow
            # straight through); the alloc arrays are static denominators
            # for the scored placement modes
            self._c_free_cpu = (ctypes.c_int32 * n)()
            self._c_free_mem = (ctypes.c_int32 * n)()
            self._c_ready = (ctypes.c_uint8 * n)()
            self._c_alloc_cpu = (ctypes.c_int32 * n)()
            self._c_alloc_mem = (ctypes.c_int32 * n)()
            self._node_idx: Dict[str, int] = {}
            for i, node in enumerate(self._node_seq):
                self._c_free_cpu[i] = node.cpu_alloc - node.cpu_used
                self._c_free_mem[i] = node.mem_alloc - node.mem_used
                self._c_ready[i] = node.ready
                self._c_alloc_cpu[i] = node.cpu_alloc
                self._c_alloc_mem[i] = node.mem_alloc
                self._node_idx[node.name] = i
            self._c_pod_cap = 0
            self._c_pod_cpu = self._c_pod_mem = self._c_bind = None
            self._c_pod_perm = None
        else:
            self._c_free_cpu = None
        self.max_pending_pods = 0            # peak unbound-pod queue depth
        self.sched_cycles = 0
        self.evictions = 0                   # pods preempted via evict_pod
        self.pods_lost = 0                   # pods failed by node kill/drain
        self.rebalances = 0                  # pods evicted by the descheduler
        # per-node peak utilization high-water marks (max of cpu/mem
        # bound fraction, updated O(1) at bind) — the hotspot-variance
        # bench axis; a node never bound keeps 0.0, which is the skew
        self.node_peak_util: Dict[str, float] = {
            name: 0.0 for name in self.nodes}
        # time-weighted per-node utilization (Σ util·dt, O(1) per bind/
        # release): under a deep backlog every node eventually hits its
        # max packing, so all-time peaks quantize to capacity and stop
        # discriminating placement quality — the time average does not
        self._util_area: Dict[str, float] = {name: 0.0 for name in self.nodes}
        self._util_cur: Dict[str, float] = {name: 0.0 for name in self.nodes}
        self._util_mark: Dict[str, float] = {name: 0.0 for name in self.nodes}
        # provisioned-capacity cost accounting (ISSUE 9): O(1) area
        # integrals over the provisioned roster (node/cpu/mem seconds)
        # and the in-use totals, windowed to last_event_t by
        # cost_summary() exactly like the per-node utilization areas.
        # The full roster starts provisioned; the autoscaler shrinks it
        self._prov_nodes = len(self._node_seq)
        self._prov_cpu = sum(n.cpu_alloc for n in self._node_seq)
        self._prov_mem = sum(n.mem_alloc for n in self._node_seq)
        self._prov_mark = 0.0
        self._prov_node_area = 0.0
        self._prov_cpu_area = 0.0
        self._prov_mem_area = 0.0
        self._prov_peak = self._prov_low = self._prov_nodes
        self._use_mark = 0.0
        self._use_cpu_area = 0.0
        self._use_mem_area = 0.0
        self.provision_flips = 0             # provision+deprovision events
        # fault injection (chaos plane, ISSUE 7): ChaosInjector attaches
        # itself here; None = zero draws, bit-identical behavior
        self.chaos = None
        # bound (resource-holding) cpu/mem per tenant label, kept current
        # at bind/release so samplers never scan the pod table
        self.tenant_holding_cpu: Dict[str, int] = {}
        self.tenant_holding_mem: Dict[str, int] = {}

    # ---- watch ---------------------------------------------------------
    def watch(self, kind: str, cb: Callable[[WatchEvent], None]):
        self._watchers.setdefault(kind, []).append(cb)
        self._watched[kind] = True

    def watch_batch(self, kind: str, cb: Callable[[List[WatchEvent]], None]):
        """Batched stream: one callback per delivery instant with every
        event of ``kind`` that became due at that instant (informers use
        this; per-event ``watch`` remains for simple consumers)."""
        self._batch_watchers.setdefault(kind, []).append(cb)
        self._watched[kind] = True

    def _notify(self, kind: str, type_: str, obj: Any):
        if kind not in self._watched:
            return
        # snapshot the object version at event time (like a real watch
        # stream's resourceVersion) — consumers must not see later state;
        # copy-on-write: consecutive notifications of an unchanged object
        # (and resync list reads) share one materialized view
        ev = WatchEvent(kind, type_, obj.snapshot())
        due = self.sim.t + self._watch_lat
        buf = self._watch_buf.get(kind)
        if buf is not None and buf[0] == due:
            buf[1].append(ev)
            return
        batch = [ev]
        self._watch_buf[kind] = (due, batch)
        self.sim.at(due, self._flush_watch, note=f"watch:{kind}",
                    args=(kind, due, batch))

    def _flush_watch(self, kind: str, due: float, batch: List[WatchEvent]):
        buf = self._watch_buf.get(kind)
        if buf is not None and buf[0] == due:
            del self._watch_buf[kind]
        for cb in self._batch_watchers.get(kind, ()):
            cb(batch)
        for cb in self._watchers.get(kind, ()):
            for ev in batch:
                cb(ev)

    # ---- namespaces / PVC ----------------------------------------------
    def create_namespace(self, name: str, cb: Optional[Callable] = None):
        self.api_calls += 1

        def do():
            if name not in self.namespaces:
                ns = NamespaceObj(name, created=self.sim.now())
                self.namespaces[name] = ns
                self._notify("namespace", ADDED, ns)
            if cb:
                cb(self.namespaces[name])

        self.sim.after(self.p.api_latency + self.p.ns_create_latency, do)

    def delete_namespace(self, name: str, cb: Optional[Callable] = None):
        self.api_calls += 1

        def do():
            ns = self.namespaces.pop(name, None)
            if ns is not None:
                ns.deleted = self.sim.now()
                ns._rv += 1
                # cascade: pods + pvcs in the namespace
                for pod in list(self._pods_by_ns.get(name, {}).values()):
                    self._remove_pod(pod)
                for key in self._pvcs_by_ns.pop(name, ()):
                    self.pvcs.pop(key, None)
                self._notify("namespace", DELETED, ns)
            if cb:
                cb(ns)

        self.sim.after(self.p.api_latency + self.p.ns_delete_latency, do)

    def create_pvc(self, namespace: str, name: str, cb: Optional[Callable] = None):
        self.api_calls += 1

        def bound():
            pvc = self.pvcs.get((namespace, name))
            if pvc is not None:
                pvc.bound = True
                pvc._rv += 1
                self._notify("pvc", MODIFIED, pvc)
                if cb:
                    cb(pvc)

        def do():
            pvc = PVCObj(name, namespace, created=self.sim.now())
            key = (namespace, name)
            if key not in self.pvcs:     # re-create: index entry exists
                self._pvcs_by_ns.setdefault(namespace, []).append(key)
            self.pvcs[key] = pvc
            self._notify("pvc", ADDED, pvc)
            # dynamic provisioning (StorageClass + NFS provisioner pod)
            self.sim.after(self.p.pvc_create_latency, bound)

        self.sim.after(self.p.api_latency, do)

    # ---- pods ------------------------------------------------------------
    def create_pod(self, pod: PodObj, cb: Optional[Callable] = None,
                   error_cb: Optional[Callable] = None):
        self.api_calls += 1
        # transient apiserver fault (chaos plane): the call is charged
        # but fails after the round-trip with a retryable error; only
        # callers that can absorb it (error_cb) are ever faulted
        if (self.chaos is not None and error_cb is not None
                and self.chaos.api_fault_draw()):
            self.sim.after(self.p.api_latency, error_cb,
                           note="api-fault", args=("Unavailable", pod))
            return
        if not self._fast:
            self.sim.after(self.p.api_latency, self._create_now,
                           args=(pod, cb, error_cb))
            return
        # same-instant creations share one apiserver round-trip event
        due = self.sim.t + self.p.api_latency
        buf = self._create_buf
        if buf is not None and buf[0] == due:
            buf[1].append((pod, cb, error_cb))
            return
        batch = [(pod, cb, error_cb)]
        self._create_buf = (due, batch)
        self.sim.at(due, self._flush_creates, note="pod-create",
                    args=(due, batch))

    def _flush_creates(self, due: float, batch: List):
        buf = self._create_buf
        if buf is not None and buf[0] == due:
            self._create_buf = None
        for pod, cb, error_cb in batch:
            self._create_now(pod, cb, error_cb)

    def _create_now(self, pod: PodObj, cb: Optional[Callable],
                    error_cb: Optional[Callable]):
        key = (pod.namespace, pod.name)
        if key in self.pods:
            if error_cb:
                error_cb("AlreadyExists", self.pods[key])
            return
        if pod.namespace not in self.namespaces:
            if error_cb:
                error_cb("NamespaceNotFound", pod)
            return
        pod.created = self.sim.now()
        pod.phase = PENDING
        self.pods[key] = pod
        self.pods_created += 1
        self._pods_by_ns.setdefault(pod.namespace, {})[key] = pod
        self._pending_pods[key] = pod
        if len(self._pending_pods) > self.max_pending_pods:
            self.max_pending_pods = len(self._pending_pods)
        if self.retain_pod_log:
            self.pod_log.append(pod)
        self._notify("pod", ADDED, pod)
        self._kick_scheduler()
        if cb:
            cb(pod)

    def delete_pod(self, namespace: str, name: str,
                   cb: Optional[Callable] = None,
                   error_cb: Optional[Callable] = None):
        self.api_calls += 1
        if (self.chaos is not None and error_cb is not None
                and self.chaos.api_fault_draw()):
            self.sim.after(self.p.api_latency, error_cb,
                           note="api-fault",
                           args=("Unavailable", (namespace, name)))
            return
        if not self._fast:
            self.sim.after(self.p.api_latency, self._delete_lookup,
                           args=(namespace, name, cb))
            return
        # same-instant deletions share the apiserver lookup event and
        # one removal event pod_delete_latency later
        due = self.sim.t + self.p.api_latency
        buf = self._del_buf
        if buf is not None and buf[0] == due:
            buf[1].append((namespace, name, cb))
            return
        batch = [(namespace, name, cb)]
        self._del_buf = (due, batch)
        self.sim.at(due, self._flush_delete_lookups, note="pod-delete",
                    args=(due, batch))

    def _delete_lookup(self, namespace: str, name: str,
                       cb: Optional[Callable]):
        pod = self.pods.get((namespace, name))
        if pod is None:
            if cb:
                cb(None)
            return
        self.sim.after(self.p.pod_delete_latency, self._remove_batch,
                       args=([(pod, cb)],))

    def _flush_delete_lookups(self, due: float, batch: List):
        buf = self._del_buf
        if buf is not None and buf[0] == due:
            self._del_buf = None
        removals = []
        for namespace, name, cb in batch:
            pod = self.pods.get((namespace, name))
            if pod is None:
                if cb:
                    cb(None)
            else:
                removals.append((pod, cb))
        if removals:
            self.sim.after(self.p.pod_delete_latency, self._remove_batch,
                           note="pod-remove", args=(removals,))

    def _remove_batch(self, removals: List):
        for pod, cb in removals:
            self._remove_pod(pod)
            if cb:
                cb(pod)

    def _remove_pod(self, pod: PodObj):
        key = (pod.namespace, pod.name)
        if self.pods.get(key) is not pod:
            return
        self._release(pod)
        pod.deleted = self.sim.now()
        pod._rv += 1
        del self.pods[key]
        self._pending_pods.pop(key, None)
        ns_map = self._pods_by_ns.get(pod.namespace)
        if ns_map is not None:
            ns_map.pop(key, None)
            if not ns_map:
                del self._pods_by_ns[pod.namespace]
        if pod.phase == SUCCEEDED and pod.labels.get("virtual") != "1":
            # paper metric: task-pod execution time, virtual entry/exit
            # pods excluded (matches MetricsCollector.pod_exec_times)
            self.exec_stat.add(pod.deleted - pod.created)
        self._notify("pod", DELETED, pod)

    def _release(self, pod: PodObj):
        if pod._holding and pod.node in self.nodes:
            n = self.nodes[pod.node]
            n.cpu_used -= pod.cpu_m
            n.mem_used -= pod.mem_mi
            n._rv += 1
            pod._holding = False
            pod._rv += 1
            if self._c_free_cpu is not None:
                i = self._node_idx[n.name]
                self._c_free_cpu[i] = n.cpu_alloc - n.cpu_used
                self._c_free_mem[i] = n.mem_alloc - n.mem_used
            now = self.sim.now()
            name = n.name
            fc = n.cpu_used / n.cpu_alloc
            fm = n.mem_used / n.mem_alloc
            self._util_area[name] += \
                self._util_cur[name] * (now - self._util_mark[name])
            self._util_mark[name] = now
            self._util_cur[name] = fc if fc >= fm else fm
            dt = now - self._use_mark
            if dt > 0.0:
                self._use_cpu_area += self.cpu_in_use * dt
                self._use_mem_area += self.mem_in_use * dt
                self._use_mark = now
            self.cpu_in_use -= pod.cpu_m
            self.mem_in_use -= pod.mem_mi
            tenant = pod.tenant
            self.tenant_holding_cpu[tenant] -= pod.cpu_m
            self.tenant_holding_mem[tenant] -= pod.mem_mi
            if self.on_usage_change is not None:
                self.on_usage_change(tenant)

    # ---- the disordered scheduler ---------------------------------------
    def _kick_scheduler(self):
        if not self._sched_scheduled:
            self._sched_scheduled = True
            self.sim.after(self.p.sched_cycle, self._schedule_cycle,
                           note="sched-cycle")

    def _schedule_cycle(self):
        self._sched_scheduled = False
        if not self._pending_pods:
            return
        self.sched_cycles += 1
        pending = list(self._pending_pods.values())
        shuffler = self._shuffler
        node_seq = self._node_seq
        n_nodes = len(node_seq)
        perm = self._node_perm
        shuffler.reset_perm(perm, n_nodes)          # canonical order each cycle
        if shuffler.has_native_cycle:
            self._native_cycle(pending, perm, node_seq, n_nodes)
        else:
            shuffler.shuffle(pending)               # disorderly
            self._python_cycle(pending, perm, node_seq, n_nodes)
        if self._pending_pods:
            self._kick_scheduler()

    def _native_cycle(self, pending, perm, node_seq, n_nodes):
        """Fused scatter cycle in the native helper: one call shuffles
        the pending order, draws, scans and picks nodes for every
        pending pod (identical draw stream and algorithm to
        ``shuffle(pending)`` + ``_python_cycle``); only the binds come
        back to Python, applied in the shuffled pod order."""
        n_pods = len(pending)
        if n_pods > self._c_pod_cap:
            cap = max(64, 2 * n_pods)
            self._c_pod_cpu = (ctypes.c_int32 * cap)()
            self._c_pod_mem = (ctypes.c_int32 * cap)()
            self._c_bind = (ctypes.c_int32 * cap)()
            self._c_pod_perm = (ctypes.c_int32 * cap)()
            self._c_pod_cap = cap
        pod_cpu, pod_mem = self._c_pod_cpu, self._c_pod_mem
        for j, pod in enumerate(pending):
            pod_cpu[j] = pod.cpu_m
            pod_mem[j] = pod.mem_mi
        # free/ready mirrors are already current (see __init__)
        pod_perm = self._c_pod_perm
        self._shuffler.schedule_cycle(perm, n_nodes, self._c_free_cpu,
                                      self._c_free_mem, self._c_ready,
                                      self._c_alloc_cpu, self._c_alloc_mem,
                                      self._score_mode,
                                      n_pods, pod_perm, pod_cpu, pod_mem,
                                      self._c_bind)
        bind = self._c_bind
        for j in range(n_pods):
            idx = bind[j]
            if idx >= 0:
                self._bind(pending[pod_perm[j]], node_seq[idx])

    def _python_cycle(self, pending, perm, node_seq, n_nodes):
        shuffler = self._shuffler
        # upper bounds on any single node's free capacity this cycle:
        # binds only shrink node headroom, so the cycle-start maxima stay
        # valid upper bounds — a pod requesting more than either can fit
        # no node, and its first-fit scan (never its draws) is skipped
        free_cpu_max = free_mem_max = 0
        for node in node_seq:
            if node.ready:
                fc = node.cpu_alloc - node.cpu_used
                fm = node.mem_alloc - node.mem_used
                if fc > free_cpu_max:
                    free_cpu_max = fc
                if fm > free_mem_max:
                    free_mem_max = fm
        score_mode = self._score_mode
        scale = self.SCORE_SCALE
        for pod in pending:
            shuffler.draw_apply(perm, n_nodes)      # scattered
            cpu, mem = pod.cpu_m, pod.mem_mi
            if cpu > free_cpu_max or mem > free_mem_max:
                continue                            # fits no node: skip scan
            if score_mode == 0:
                for idx in perm:
                    node = node_seq[idx]
                    if (node.ready and node.cpu_used + cpu <= node.cpu_alloc
                            and node.mem_used + mem <= node.mem_alloc):
                        self._bind(pod, node)
                        break
                continue
            # scored placement (semantic reference for the fused C
            # scan): integer least-allocated score of the POST-BIND
            # free fractions; spread maximizes, pack minimizes; strict
            # comparison means ties go to the earliest perm position.
            # Same draws, same skip rule — only the pick differs.
            best = None
            best_score = 0
            for idx in perm:
                node = node_seq[idx]
                if not (node.ready and node.cpu_used + cpu <= node.cpu_alloc
                        and node.mem_used + mem <= node.mem_alloc):
                    continue
                fc = node.cpu_alloc - node.cpu_used - cpu
                fm = node.mem_alloc - node.mem_used - mem
                score = (fc * scale) // node.cpu_alloc \
                    + (fm * scale) // node.mem_alloc
                if best is None or (score > best_score if score_mode == 1
                                    else score < best_score):
                    best = node
                    best_score = score
            if best is not None:
                self._bind(pod, best)

    def _bind(self, pod: PodObj, node: NodeObj):
        pod.node = node.name
        pod.scheduled = self.sim.now()
        pod._rv += 1
        node.cpu_used += pod.cpu_m
        node.mem_used += pod.mem_mi
        node._rv += 1
        pod._holding = True
        if self._c_free_cpu is not None:
            i = self._node_idx[node.name]
            self._c_free_cpu[i] = node.cpu_alloc - node.cpu_used
            self._c_free_mem[i] = node.mem_alloc - node.mem_used
        # O(1) hotspot high-water mark + time-weighted load integral
        # (the bench's spread axes)
        frac = node.cpu_used / node.cpu_alloc
        frac_m = node.mem_used / node.mem_alloc
        if frac_m > frac:
            frac = frac_m
        name = node.name
        if frac > self.node_peak_util[name]:
            self.node_peak_util[name] = frac
        self._util_area[name] += \
            self._util_cur[name] * (pod.scheduled - self._util_mark[name])
        self._util_mark[name] = pod.scheduled
        self._util_cur[name] = frac
        dt = pod.scheduled - self._use_mark
        if dt > 0.0:
            self._use_cpu_area += self.cpu_in_use * dt
            self._use_mem_area += self.mem_in_use * dt
            self._use_mark = pod.scheduled
        self.cpu_in_use += pod.cpu_m
        self.mem_in_use += pod.mem_mi
        tenant = pod.tenant
        self.tenant_holding_cpu[tenant] = \
            self.tenant_holding_cpu.get(tenant, 0) + pod.cpu_m
        self.tenant_holding_mem[tenant] = \
            self.tenant_holding_mem.get(tenant, 0) + pod.mem_mi
        if self.on_usage_change is not None:
            self.on_usage_change(tenant)
        self._pending_pods.pop((pod.namespace, pod.name), None)
        start_lat = self.p.pod_start_latency
        if pod.volume:
            start_lat += self.p.pvc_mount_latency
        if not self._fast:
            self.sim.after(start_lat, self._start, args=(pod,))
            return
        # compound timeline: every pod bound in this scheduler cycle
        # shares one start event; the rest of its lifecycle (finish
        # instants, watch notifications) is laid out when it fires
        due = self.sim.t + start_lat
        buf = self._start_buf
        if buf is not None and buf[0] == due:
            buf[1].append(pod)
            return
        batch = [pod]
        self._start_buf = (due, batch)
        self.sim.at(due, self._start_batch, note="pod-start",
                    args=(due, batch))

    def _start_one(self, pod: PodObj) -> float:
        """Apply the Pending→Running transition; returns the completion
        due time, or -1.0 when the pod can no longer start."""
        if self.pods.get((pod.namespace, pod.name)) is not pod:
            return -1.0                              # deleted while starting
        if pod.phase != PENDING:
            return -1.0                              # failed before start
            #                                          (node kill/drain while
            #                                           the start was in flight)
        if not self.nodes[pod.node].ready:
            return -1.0                              # node died mid-start
        pod.phase = RUNNING
        pod.started = self.sim.now()
        pod._rv += 1
        self._notify("pod", MODIFIED, pod)
        dur = pod.duration_s
        if pod.payload is not None and self.payload_mode == "real":
            dur = measure_wall(pod.payload)
        elif pod.payload is not None:
            pod.payload()                            # run, but virtual timing
        dur *= self.nodes[pod.node].slow_factor
        if self.chaos is not None and dur > 0.0:
            # seeded mid-run crash (chaos plane): fires strictly before
            # the success finish, which then no-ops on phase != RUNNING;
            # unlike node loss this charges the §4.5 retry budget
            crash_after = self.chaos.task_crash_draw(dur)
            if crash_after is not None:
                self.sim.at(self.sim.t + crash_after, self._finish,
                            note="chaos-crash", args=(pod, FAILED))
        return self.sim.t + (dur if dur > 0.0 else 0.0)

    def _start(self, pod: PodObj):
        fdue = self._start_one(pod)
        if fdue >= 0.0:
            self.sim.at(fdue, self._finish, args=(pod, SUCCEEDED))

    def _start_batch(self, due: float, pods: List[PodObj]):
        buf = self._start_buf
        if buf is not None and buf[0] == due:
            self._start_buf = None
        # transition every pod first (their RUNNING notifications share
        # one watch batch, in bind order — exactly the chained order),
        # then schedule one finish event per distinct completion instant
        groups: Dict[float, List[PodObj]] = {}
        for pod in pods:
            fdue = self._start_one(pod)
            if fdue < 0.0:
                continue
            g = groups.get(fdue)
            if g is None:
                groups[fdue] = [pod]
            else:
                g.append(pod)
        for fdue, group in groups.items():
            self.sim.at(fdue, self._finish_batch, note="pod-finish",
                        args=(group,))

    def _finish_batch(self, group: List[PodObj]):
        for pod in group:
            self._finish(pod, SUCCEEDED)

    def _finish(self, pod: PodObj, phase: str):
        if self.pods.get((pod.namespace, pod.name)) is not pod:
            return
        if pod.phase != RUNNING:
            return
        pod.phase = phase
        pod.finished = self.sim.now()
        pod._rv += 1
        self._release(pod)                           # compute freed; object stays
        self._notify("pod", MODIFIED, pod)

    def fail_pod(self, namespace: str, name: str):
        pod = self.pods.get((namespace, name))
        if pod is not None and pod.phase == RUNNING:
            self._finish(pod, FAILED)

    def evict_pod(self, namespace: str, name: str) -> bool:
        """Preemption path of the admission pipeline: kill a RUNNING
        pod now, releasing its node resources.  The pod surfaces as
        FAILED with ``evicted=True`` so the engine re-queues its task
        through admission instead of charging the retry budget.
        Returns False when the pod is gone or not RUNNING (the
        arbiter's informer view may lag the apiserver)."""
        self.api_calls += 1
        pod = self.pods.get((namespace, name))
        if pod is None or pod.phase != RUNNING:
            return False
        pod.evicted = True
        pod._rv += 1
        self.evictions += 1
        self._finish(pod, FAILED)
        return True

    def rebalance_evict(self, namespace: str, name: str) -> bool:
        """Descheduler eviction: like :meth:`evict_pod` but flagged
        ``rebalanced`` so recovery metrics split offloads from
        admission preemptions.  The engine requeues the task through
        admission with no retry-budget charge; it lands on a cooler
        node (or pends) via the ordinary scatter cycle."""
        self.api_calls += 1
        pod = self.pods.get((namespace, name))
        if pod is None or pod.phase != RUNNING:
            return False
        pod.evicted = True
        pod.rebalanced = True
        pod._rv += 1
        self.rebalances += 1
        self._finish(pod, FAILED)
        return True

    def node_util(self, node: NodeObj) -> float:
        """Live utilization of one node: max of its bound cpu and mem
        fractions (the descheduler's overload signal)."""
        fc = node.cpu_used / node.cpu_alloc
        fm = node.mem_used / node.mem_alloc
        return fc if fc >= fm else fm

    def hotspot_summary(self) -> Dict[str, float]:
        """Per-node utilization spread — the load-imbalance axes the
        scored placement modes attack.  Two profiles over the node
        population: the bind-time high-water marks (``*_peak_util``;
        note a deep enough backlog saturates every node's peak at its
        max packing) and the time-weighted per-node mean utilizations
        (``*_mean_util`` / ``util_variance`` — the saturation-proof
        hotspot-variance axis benchmarks and CI compare)."""
        n = len(self.node_peak_util)
        if not n:
            return {}
        peaks = list(self.node_peak_util.values())
        # drained sims park t at the horizon; the workload's real time
        # span ends at the last event — use it as the averaging window
        now = min(self.sim.now(),
                  getattr(self.sim, "last_event_t", self.sim.now()))
        means = [(self._util_area[name]
                  + self._util_cur[name]
                  * max(0.0, now - self._util_mark[name]))
                 / now if now > 0 else 0.0
                 for name in self.node_peak_util]
        peak_mean = sum(peaks) / n
        util_mean = sum(means) / n
        return {
            "nodes": float(n),
            "mean_peak_util": peak_mean,
            "max_peak_util": max(peaks),
            "min_peak_util": min(peaks),
            "peak_util_variance": sum(
                (p - peak_mean) ** 2 for p in peaks) / n,
            "mean_util": util_mean,
            "max_mean_util": max(means),
            "min_mean_util": min(means),
            "util_variance": sum(
                (u - util_mean) ** 2 for u in means) / n,
        }

    # ---- node failure (fault-tolerance substrate) -------------------------
    def _fail_resident(self, pod: PodObj):
        """Fail one pod resident on a dying node.  Surfaces like a
        preemption (``evicted=True`` -> engine requeues through
        admission, no retry-budget charge) but flagged ``node_lost``
        so recovery metrics split the two causes."""
        pod.evicted = True
        pod.node_lost = True
        pod._rv += 1
        self.pods_lost += 1
        if pod.phase == PENDING:
            # bound but not yet started: the pending _start event will
            # no-op on the phase guard; release and fail directly (the
            # _finish path only handles RUNNING pods)
            self._pending_pods.pop((pod.namespace, pod.name), None)
            self._release(pod)
            pod.phase = FAILED
            pod.finished = self.sim.now()
            pod._rv += 1
            self._notify("pod", MODIFIED, pod)
        else:
            self._finish(pod, FAILED)

    def kill_node(self, name: str, drain: bool = False) -> int:
        """Chaos primitive: node crash (or graceful spot reclaim when
        ``drain=True``).  Cordons the node out of the scheduler (node
        arrays + informer aggregates track the MODIFIED event) and
        fails every resident pod via :meth:`_fail_resident`; the
        engine's requeue machinery re-admits the tasks with no retry
        charge.  A drain evicts each pod through the apiserver
        (charged to ``api_calls``); a crash charges nothing.  Returns
        the number of pods disrupted.  ``restore_node`` undoes the
        cordon."""
        node = self.nodes[name]
        if not node.ready:
            return 0
        node.ready = False
        node._rv += 1
        if self._c_free_cpu is not None:
            self._c_ready[self._node_idx[name]] = 0
        self._notify("node", MODIFIED, node)
        lost = 0
        for pod in list(self.pods.values()):
            if pod.node == name and pod.phase in (PENDING, RUNNING):
                if drain:
                    self.api_calls += 1      # per-pod eviction round-trip
                self._fail_resident(pod)
                lost += 1
        return lost

    def drain_node(self, name: str) -> int:
        """Spot/preemptible reclaim: like :meth:`kill_node` but each
        resident pod is evicted through the apiserver (api pressure),
        modeling the reclaim grace-period drain."""
        return self.kill_node(name, drain=True)

    def fail_node(self, name: str):
        node = self.nodes[name]
        node.ready = False
        node._rv += 1
        if self._c_free_cpu is not None:
            self._c_ready[self._node_idx[name]] = 0
        self._notify("node", MODIFIED, node)
        for pod in list(self.pods.values()):
            if pod.node == name and pod.phase in (PENDING, RUNNING):
                self._release(pod)
                pod.phase = FAILED
                pod.finished = self.sim.now()
                pod._rv += 1
                self._notify("pod", MODIFIED, pod)

    def restore_node(self, name: str):
        node = self.nodes[name]
        if not node.provisioned:
            # the autoscaler deprovisioned this node while it was down:
            # a late chaos rejoin must not resurrect it — only
            # provision_node (which re-enters here) brings it back
            return
        node.ready = True
        node._rv += 1
        if node.cpu_used or node.mem_used:   # normally zero: failure released
            now = self.sim.now()
            dt = now - self._use_mark
            if dt > 0.0:
                self._use_cpu_area += self.cpu_in_use * dt
                self._use_mem_area += self.mem_in_use * dt
                self._use_mark = now
            self.cpu_in_use -= node.cpu_used
            self.mem_in_use -= node.mem_used
            if self.on_usage_change is not None:
                self.on_usage_change(None)
        node.cpu_used = node.mem_used = 0
        if self._c_free_cpu is not None:
            i = self._node_idx[name]
            self._c_free_cpu[i] = node.cpu_alloc
            self._c_free_mem[i] = node.mem_alloc
            self._c_ready[i] = 1
        self._notify("node", MODIFIED, node)
        self._kick_scheduler()

    # ---- elastic provisioning (autoscaler substrate) ----------------------
    def _accrue_provisioned(self):
        """Advance the provisioned-capacity area integrals to now.
        O(1): the roster totals are maintained incrementally by the
        provision/deprovision flips, so the integral only needs the
        elapsed span times the current totals."""
        now = self.sim.now()
        dt = now - self._prov_mark
        if dt > 0.0:
            self._prov_node_area += self._prov_nodes * dt
            self._prov_cpu_area += self._prov_cpu * dt
            self._prov_mem_area += self._prov_mem * dt
            self._prov_mark = now

    def provision_node(self, name: str):
        """Autoscaler scale-up: bring a deprovisioned node back into
        the roster.  Accrues the cost integrals at the old capacity,
        flips the provisioned bit, then rejoins the scheduler through
        the ordinary :meth:`restore_node` path (ready-array writes,
        node MODIFIED fan-out, scheduler kick) — the native mirrors
        keep their fixed indices because the node object never left
        ``_node_seq``."""
        node = self.nodes[name]
        if node.provisioned:
            return
        self._accrue_provisioned()
        node.provisioned = True
        node._rv += 1
        self._prov_nodes += 1
        self._prov_cpu += node.cpu_alloc
        self._prov_mem += node.mem_alloc
        if self._prov_nodes > self._prov_peak:
            self._prov_peak = self._prov_nodes
        self.provision_flips += 1
        self.restore_node(name)

    def deprovision_node(self, name: str) -> int:
        """Autoscaler scale-down: cordon + drain the node through the
        PR-7 reclaim path (residents requeue with no retry-budget
        charge), then remove its capacity from the provisioned
        roster.  While deprovisioned the node is invisible to chaos
        victim picks and immune to late ``restore_node`` rejoins.
        Returns the number of pods disrupted (zero when the caller
        only drains idle nodes)."""
        node = self.nodes[name]
        if not node.provisioned:
            return 0
        lost = self.drain_node(name) if node.ready else 0
        self._accrue_provisioned()
        node.provisioned = False
        node._rv += 1
        self._prov_nodes -= 1
        self._prov_cpu -= node.cpu_alloc
        self._prov_mem -= node.mem_alloc
        if self._prov_nodes < self._prov_low:
            self._prov_low = self._prov_nodes
        self.provision_flips += 1
        return lost

    def cost_summary(self) -> Dict[str, float]:
        """Provisioned-capacity cost axes: node/cpu/mem-seconds paid
        and the time-weighted utilization of that paid capacity.
        Windowed to ``last_event_t`` like :meth:`hotspot_summary`
        (drained sims park the clock at the horizon).  Every field is
        a plain sum/extremum over the run, so sharded planes merge it
        exactly: areas and flips add, peaks/lows take max/min, and
        the ratios are recomputed from the pooled areas."""
        now = min(self.sim.now(),
                  getattr(self.sim, "last_event_t", self.sim.now()))
        span = max(0.0, now - self._prov_mark)
        node_s = self._prov_node_area + self._prov_nodes * span
        cpu_s = self._prov_cpu_area + self._prov_cpu * span
        mem_s = self._prov_mem_area + self._prov_mem * span
        use_span = max(0.0, now - self._use_mark)
        used_cpu_s = self._use_cpu_area + self.cpu_in_use * use_span
        used_mem_s = self._use_mem_area + self.mem_in_use * use_span
        return {
            "node_seconds": node_s,
            "cpu_mcore_seconds": cpu_s,
            "mem_mib_seconds": mem_s,
            "used_cpu_mcore_seconds": used_cpu_s,
            "used_mem_mib_seconds": used_mem_s,
            "cpu_util_over_provisioned": (
                used_cpu_s / cpu_s if cpu_s > 0 else 0.0),
            "mem_util_over_provisioned": (
                used_mem_s / mem_s if mem_s > 0 else 0.0),
            "provisioned_peak_nodes": float(self._prov_peak),
            "provisioned_low_nodes": float(self._prov_low),
            "provision_flips": float(self.provision_flips),
        }

    # ---- reads (each list is an apiserver round-trip — the pressure the
    # Informer cache avoids; watch-driven callers never come here) ----------
    def list_pods(self, namespace: Optional[str] = None) -> List[PodObj]:
        self.api_calls += 1
        if namespace is None:
            return list(self.pods.values())
        return list(self._pods_by_ns.get(namespace, {}).values())

    def list_nodes(self) -> List[NodeObj]:
        self.api_calls += 1
        return list(self.nodes.values())

    def list_namespaces(self) -> List[NamespaceObj]:
        self.api_calls += 1
        return list(self.namespaces.values())

    def list_pvcs(self, namespace: Optional[str] = None) -> List[PVCObj]:
        self.api_calls += 1
        if namespace is None:
            return list(self.pvcs.values())
        pvcs = self.pvcs
        return [pvcs[k] for k in self._pvcs_by_ns.get(namespace, ())
                if k in pvcs]

    def allocatable(self) -> Tuple[int, int]:
        cpu = sum(n.cpu_alloc for n in self.nodes.values() if n.ready)
        mem = sum(n.mem_alloc for n in self.nodes.values() if n.ready)
        return cpu, mem

    def used(self) -> Tuple[int, int]:
        # exact running totals, O(1); equals the node scan at all times
        # (pinned by tests/test_event_core.py)
        return self.cpu_in_use, self.mem_in_use

    def used_scan(self) -> Tuple[int, int]:
        """Reference node scan; equals ``used()`` at every instant."""
        cpu = sum(n.cpu_used for n in self.nodes.values())
        mem = sum(n.mem_used for n in self.nodes.values())
        return cpu, mem
