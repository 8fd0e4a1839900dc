"""Deterministic chaos plane (ISSUE 7): seeded fault injection.

Three fault families, all drawn from ONE dedicated RNG stream so a
fixed chaos seed replays bit-for-bit and ``chaos=None`` performs zero
draws (the scheduler RNG is untouched — every PR-6 pinned binding hash
holds):

  * node crashes / spot-reclaim drains — seeded exponential
    inter-arrival timers pick a ready node and call
    ``Cluster.kill_node`` / ``Cluster.drain_node``; resident pods fail
    with ``evicted=True`` + ``node_lost=True`` and ride the PR-4
    requeue machinery back through admission with no retry-budget
    charge.  An optional seeded downtime restores the node later
    (``restore_node``), re-adding its capacity to the native scheduler
    arrays and the informer aggregates.
  * transient apiserver faults — each ``create_pod``/``delete_pod``
    call flips a seeded coin and may return a retryable
    ``"Unavailable"`` error; the engine absorbs it with capped
    exponential backoff + jitter (generalizing the AlreadyExists
    delete+retry path, see engine.py).
  * task crashes — a started pod may be killed mid-run at a seeded
    point of its duration; unlike node loss this IS a failure and
    charges the §4.5 retry budget (the deterministic driver for the
    ``on_retry_exhausted`` paths).

Determinism argument: every draw happens inside the single-threaded
sim event loop, in event order.  Timer chains draw their next
inter-arrival when they fire; per-call fault coins and per-start crash
plans draw exactly when the triggering call executes.  Two runs with
the same workload, seed and schedule therefore consume the identical
draw sequence — pinned by tests/test_chaos_plane.py.  The stream is
spawned via sha256 (``chaos_stream_seed``), decorrelated from the
scheduler seed and from the sha256-spawned shard seeds, and
``ChaosSchedule.spawn(shard)`` derives per-shard schedules the same
way the sharded plane spawns per-shard scheduler seeds.

``ChaosSchedule`` is a frozen, picklable value object (it crosses the
fork boundary inside ``ShardSpec``); ``ChaosInjector`` is the live
per-plane driver holding the RNG, the timers and the recovery
counters.

Heterogeneous node classes (ISSUE 8) need no special casing here:
victims are picked uniformly over the READY names in the canonical
node order, so big and small nodes are equally likely targets, and
``kill_node``/``drain_node``/``restore_node`` write each node's OWN
``cpu_alloc``/``mem_alloc`` back into the native free/ready mirrors —
killing a 16-core node removes 16 cores, restoring it returns 16
(pinned by tests/test_placement.py's hetero drain/restore
regression).  The descheduler (core/descheduler.py) composes the same
way: it draws nothing, so chaos replay identity is unaffected.

The autoscaler (core/autoscaler.py, ISSUE 9) also draws nothing, but
it shrinks the provisioned roster: victims are picked only among
PROVISIONED ready nodes (never the last one), and a chaos rejoin of a
node the autoscaler deprovisioned while it was down is a no-op — only
``provision_node`` brings reclaimed capacity back.  With no autoscaler
every node stays provisioned, so the candidate lists and the draw
stream are bit-identical to the PR-7/PR-8 pins.
"""
from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, replace
from typing import Optional, Tuple


def chaos_stream_seed(seed: int) -> int:
    """Decorrelate the chaos stream from every other consumer of the
    run seed (scheduler RNG, arrival RNGs, shard seeds) — same
    sha256-spawn scheme as ``shard.shard_seed`` under its own tag."""
    h = hashlib.sha256(f"repro-chaos/{seed}".encode()).digest()
    return int.from_bytes(h[:8], "big")


def chaos_shard_seed(seed: int, shard: int) -> int:
    h = hashlib.sha256(f"repro-chaos-shard/{seed}/{shard}".encode()).digest()
    return int.from_bytes(h[:8], "big")


@dataclass(frozen=True)
class ChaosSchedule:
    """Declarative, picklable fault plan.  All rates default to off:
    ``ChaosSchedule()`` injects nothing (but still arms the stream, so
    use ``chaos=None`` for the guaranteed-untouched baseline)."""

    seed: int = 0
    # seeded node-event streams: mean exponential inter-arrival seconds
    # (0 = stream off); kills model crashes, drains model spot reclaims
    node_kill_interval_s: float = 0.0
    node_drain_interval_s: float = 0.0
    node_downtime_s: float = 0.0     # restore after this long (0 = stays down)
    max_node_events: int = 0         # cap kills+drains (0 = unbounded)
    start_after_s: float = 0.0       # grace period before the first draw
    # explicit scripted events: (t, "kill"|"drain"|"restore", node_name)
    events: Tuple[Tuple[float, str, str], ...] = ()
    # per-apiserver-call probability of a retryable "Unavailable" error
    api_fault_rate: float = 0.0
    # per-pod-start probability of a mid-run crash (charges retries)
    task_crash_rate: float = 0.0
    # submission-transport faults at the durable gateway (ISSUE 10):
    # per-admitted-submission probability the gate->engine hop drops
    # the submission (recovered by WAL redelivery) or duplicates it
    # (suppressed by exactly-once dedup); no-ops without a gateway
    gateway_drop_rate: float = 0.0
    gateway_dup_rate: float = 0.0

    def spawn(self, shard: int) -> "ChaosSchedule":
        """The schedule for one shard of a sharded plane: same plan,
        decorrelated per-shard seed (mirrors ``shard.shard_seed``)."""
        return replace(self, seed=chaos_shard_seed(self.seed, shard))

    @property
    def active(self) -> bool:
        return bool(self.node_kill_interval_s > 0.0
                    or self.node_drain_interval_s > 0.0
                    or self.events
                    or self.api_fault_rate > 0.0
                    or self.task_crash_rate > 0.0
                    or self.gateway_drop_rate > 0.0
                    or self.gateway_dup_rate > 0.0)


class ChaosInjector:
    """Live fault driver for one control-plane stack.

    Attaches itself as ``cluster.chaos`` — the cluster consults it at
    every apiserver call (fault coin) and pod start (crash plan), and
    the engine uses :meth:`backoff_jitter` for its retry delays.  All
    timer events are daemons: an un-restored schedule must never keep
    the sim alive past the workload.
    """

    def __init__(self, sim, cluster, schedule: ChaosSchedule):
        self.sim = sim
        self.cluster = cluster
        self.schedule = schedule
        self.rng = random.Random(chaos_stream_seed(schedule.seed))
        # recovery accounting (exported via counters(), merged by shard)
        self.node_kills = 0
        self.node_drains = 0
        self.node_restores = 0
        self.pods_lost = 0
        self.api_faults = 0
        self.task_crashes = 0
        self.gateway_drops = 0
        self.gateway_dups = 0
        self.node_downtime_s = 0.0       # accumulated on restore
        self._node_events = 0
        self._down_since: dict = {}      # node -> kill/drain instant
        cluster.chaos = self
        self._arm()

    # -- timers -----------------------------------------------------------
    def _arm(self):
        s = self.schedule
        for t, action, node in s.events:
            self.sim.at(t, self._scripted, daemon=True,
                        note=f"chaos:{action}", args=(action, node))
        if s.node_kill_interval_s > 0.0:
            self._arm_stream("kill", s.node_kill_interval_s, first=True)
        if s.node_drain_interval_s > 0.0:
            self._arm_stream("drain", s.node_drain_interval_s, first=True)

    def _arm_stream(self, action: str, mean_s: float, first: bool = False):
        dt = self.rng.expovariate(1.0 / mean_s)
        if first:
            dt += self.schedule.start_after_s
        self.sim.after(dt, self._fire_stream, daemon=True,
                       note=f"chaos:{action}", args=(action, mean_s))

    def _fire_stream(self, action: str, mean_s: float):
        cap = self.schedule.max_node_events
        if cap and self._node_events >= cap:
            return                       # stream exhausted: stop rearming
        victim = self._pick_victim()
        if victim is not None:
            self._node_event(action, victim)
        self._arm_stream(action, mean_s)

    def _scripted(self, action: str, node: str):
        if action == "restore":
            self._restore(node)
            return
        if node in self.cluster.nodes and self.cluster.nodes[node].ready:
            self._node_event(action, node)

    def _pick_victim(self) -> Optional[str]:
        # canonical node order (the cluster's _node_seq) so the draw is
        # identical across queue backends and shuffle backends; only
        # PROVISIONED ready nodes are candidates — chaos must not kill
        # capacity the autoscaler has already reclaimed, and without an
        # autoscaler every node is provisioned so the candidate list
        # (and therefore the draw stream) is unchanged
        ready = [n.name for n in self.cluster._node_seq
                 if n.ready and n.provisioned]
        if len(ready) <= 1:
            return None        # never take the last provisioned node down
        return ready[self.rng.randrange(len(ready))]

    def _node_event(self, action: str, node: str):
        self._node_events += 1
        if action == "drain":
            lost = self.cluster.drain_node(node)
            self.node_drains += 1
        else:
            lost = self.cluster.kill_node(node)
            self.node_kills += 1
        self.pods_lost += lost
        self._down_since[node] = self.sim.now()
        if self.schedule.node_downtime_s > 0.0:
            self.sim.after(self.schedule.node_downtime_s, self._restore,
                           daemon=True, note="chaos:restore", args=(node,))

    def _restore(self, node: str):
        since = self._down_since.pop(node, None)
        if since is None or self.cluster.nodes[node].ready:
            return
        if not self.cluster.nodes[node].provisioned:
            # the autoscaler deprovisioned this node while it was down;
            # a chaos rejoin must not resurrect reclaimed capacity
            # (restore_node has the same guard — don't count a restore)
            return
        self.node_downtime_s += self.sim.now() - since
        self.node_restores += 1
        self.cluster.restore_node(node)

    # -- per-call draws (consulted by cluster.py / engine.py) -------------
    def api_fault_draw(self) -> bool:
        """One seeded coin per guarded apiserver call."""
        rate = self.schedule.api_fault_rate
        if rate <= 0.0:
            return False
        if self.rng.random() < rate:
            self.api_faults += 1
            return True
        return False

    def task_crash_draw(self, duration_s: float) -> Optional[float]:
        """Crash plan for one started pod: seconds until the mid-run
        kill (strictly < duration), or None to run clean."""
        rate = self.schedule.task_crash_rate
        if rate <= 0.0:
            return None
        if self.rng.random() >= rate:
            return None
        self.task_crashes += 1
        return self.rng.random() * duration_s

    def gateway_fault_draw(self) -> Optional[str]:
        """One seeded draw per gateway transport hop: ``"drop"`` loses
        the submission in flight (the WAL redelivers), ``"dup"``
        delivers it twice (the dedup set suppresses the copy), None
        passes clean.  Zero draws when both rates are 0 — a gateway-
        armed, fault-free run replays the PR-7 chaos stream exactly."""
        drop, dup = (self.schedule.gateway_drop_rate,
                     self.schedule.gateway_dup_rate)
        if drop <= 0.0 and dup <= 0.0:
            return None
        u = self.rng.random()
        if u < drop:
            self.gateway_drops += 1
            return "drop"
        if u < drop + dup:
            self.gateway_dups += 1
            return "dup"
        return None

    def backoff_jitter(self) -> float:
        """Uniform [0,1) jitter factor for the engine's retry backoff
        (seeded: replays bit-for-bit with the rest of the stream)."""
        return self.rng.random()

    # -- accounting -------------------------------------------------------
    def counters(self) -> dict:
        """Recovery accounting; plain ints/floats so per-shard dicts
        merge by summation (see shard.ShardedRunResult.chaos_counters)."""
        return {
            "node_kills": self.node_kills,
            "node_drains": self.node_drains,
            "node_restores": self.node_restores,
            "pods_lost": self.pods_lost,
            "api_faults": self.api_faults,
            "task_crashes": self.task_crashes,
            "gateway_drops": self.gateway_drops,
            "gateway_dups": self.gateway_dups,
            "node_downtime_s": round(self.node_downtime_s, 9),
        }
