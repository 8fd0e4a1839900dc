"""Durable submission front door (ISSUE 10): WAL + admission backpressure.

The ROADMAP's millions-of-users item asks for a pkbs-style submission
service: a durable queue in front of the arbiter shards, admission
backpressure instead of unbounded pending, and ``qstat``-style
introspection.  This module supplies all three as a wrapper around the
multi-stream ``WorkflowGateway`` (core/injector.py):

* ``SubmissionWAL`` — a per-shard append-only submission log.  Every
  record is deterministic (monotonic submission id, tenant, arrival
  ``t``, workflow spec digest) and sha256-chained: ``chain_n =
  sha256(chain_{n-1} + line_n)``, so any mutation, drop, or reorder of
  the log is detectable from the head hash alone.  Records live in
  bounded in-memory segments; an optional file sink (one JSON line per
  record, flushed per append) survives a worker crash.  On restart the
  WAL loads the file, truncates a torn tail line (a crash mid-write),
  and *replays*: each regenerated submission is verified field-for-field
  against the logged record at its id — the log is the authority for
  what the outside world already submitted, so a diverging replay
  raises ``WalReplayError`` instead of silently double-running — and
  exactly-once dedup guarantees each submission id reaches the engine
  at most once even when the chaos plane drops or duplicates the
  transport hop.

* ``BackpressurePolicy`` — frozen, picklable (crosses the fork inside
  ``ShardSpec``).  ``max_pending`` bounds the submissions admitted past
  the gate and not yet finished; a breach rejects the submission with a
  deterministic retry-after timer.  The retry jitter draws from a
  dedicated sha256-spawned stream (``repro-gate/{seed}/{shard}``), so
  scheduler / chaos / shuffle word streams are untouched and every
  pinned binding hash holds; an unsaturated gateway performs zero
  draws and adds zero sim events — bit-identical to no gateway at all.
  ``shed`` picks the victim when pressure persists: ``reject-newest``
  sheds the arriving submission once its client retries are exhausted,
  ``shed-oldest`` bounds the retry room by evicting its oldest entry,
  ``fair-shed`` evicts from the tenant hogging the retry room.

* ``GatewayStats`` — the qstat surface: per-tenant
  queued/admitted/running/done/rejected/retried/shed counters plus the
  current retry-after horizon, snapshotted as plain dicts that merge
  across shards exactly like the PR-6 metrics partials
  (``merge_gateway_snapshots``: counters sum, peaks max).

Determinism argument: every WAL append, admission check, and retry
draw happens inside the single-threaded sim loop in event order.  Two
runs with the same workload, seed, and policy consume the identical
gate-stream draw sequence; a mid-run shard kill replays the WAL prefix
under verification and regenerates the suffix, so the merged metrics
are bit-identical to a never-crashed run (pinned by
tests/test_gateway.py).
"""
from __future__ import annotations

import hashlib
import json
import os
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

__all__ = ["BackpressurePolicy", "DurableGateway", "GatewayStats",
           "SubmissionWAL", "WalReplayError", "gate_stream_seed",
           "workflow_digest", "merge_gateway_snapshots"]

SHED_MODES = ("reject-newest", "shed-oldest", "fair-shed")
WAL_GENESIS = hashlib.sha256(b"repro-wal/genesis").hexdigest()
WAL_SEGMENT = 4096


def gate_stream_seed(seed: int, shard: int) -> int:
    """Decorrelate the gateway's retry-jitter stream from every other
    consumer of the run seed (scheduler RNG, chaos streams, shard
    seeds) — same sha256-spawn scheme under its own tag."""
    digest = hashlib.sha256(
        f"repro-gate/{seed}/{shard}".encode("ascii")).digest()
    return int.from_bytes(digest[:8], "big")


def workflow_digest(tenant: str, name: str, instance: int) -> str:
    """Deterministic spec digest for one submission (the WAL's replay
    verification key: same tenant/topology/instance => same digest)."""
    return hashlib.sha256(
        f"{tenant}/{name}#{instance}".encode("utf-8")).hexdigest()[:16]


def _wal_line(rec: dict) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


class WalReplayError(RuntimeError):
    """The WAL is corrupt, or a restarted shard's regenerated arrivals
    diverged from the logged submissions — never silently continue."""


class SubmissionWAL:
    """Append-only, sha256-chained submission log for one shard.

    In-memory segments always; ``path`` adds the crash-durable file
    sink.  When the file already holds records (a prior incarnation
    died mid-run), appends replay against that prefix: each record is
    verified field-for-field and NOT rewritten; appends beyond the
    prefix extend the file.  ``replayed`` counts verified prefix
    records — the observable proof a restart recovered from the log.
    """

    def __init__(self, path: Optional[str] = None,
                 segment_size: int = WAL_SEGMENT):
        if segment_size < 1:
            raise ValueError("segment_size must be >= 1")
        self.path = path
        self.segment_size = segment_size
        self.segments: List[List[dict]] = []
        self.count = 0
        self.chain = WAL_GENESIS
        self.replayed = 0
        self._expected: List[dict] = []
        self._sink = None
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._expected = self._load_and_trim(path)
            self._sink = open(path, "a")

    @staticmethod
    def _load_and_trim(path: str) -> List[dict]:
        """Load the durable prefix; verify the chain line by line; drop
        (and truncate away) a torn tail line from a crash mid-write."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return []
        records: List[dict] = []
        chain = WAL_GENESIS
        valid_len = 0
        offset = 0
        for chunk in raw.split(b"\n"):
            if not chunk:
                offset += 1
                continue
            line = chunk.decode("utf-8", errors="replace")
            complete = raw[offset + len(chunk):offset + len(chunk) + 1] \
                == b"\n"
            try:
                rec = json.loads(line)
                ok = (isinstance(rec, dict)
                      and rec.get("id") == len(records)
                      and _wal_line(rec) == line)
            except ValueError:
                ok = False
            if not ok or not complete:
                if complete:
                    raise WalReplayError(
                        f"corrupt WAL record at id {len(records)} in "
                        f"{path}")
                break               # torn tail: the crash interrupted a write
            chain = hashlib.sha256((chain + line).encode()).hexdigest()
            records.append(rec)
            offset += len(chunk) + 1
            valid_len = offset
        if valid_len < len(raw):
            os.truncate(path, valid_len)
        return records

    def append(self, tenant: str, t: float, digest: str) -> dict:
        rec = {"id": self.count, "tenant": tenant, "t": t, "digest": digest}
        line = _wal_line(rec)
        if self.count < len(self._expected):
            exp = self._expected[self.count]
            if exp != rec:
                raise WalReplayError(
                    f"WAL replay diverged at submission {self.count}: "
                    f"logged {exp}, regenerated {rec}")
            self.replayed += 1
        elif self._sink is not None:
            self._sink.write(line + "\n")
            self._sink.flush()
        if not self.segments or len(self.segments[-1]) >= self.segment_size:
            self.segments.append([])
        self.segments[-1].append(rec)
        self.chain = hashlib.sha256((self.chain + line).encode()).hexdigest()
        self.count += 1
        return rec

    def records(self) -> List[dict]:
        return [rec for seg in self.segments for rec in seg]

    def verify(self) -> bool:
        """Recompute the chain over the in-memory segments and compare
        with the running head — the integrity check."""
        chain = WAL_GENESIS
        for seg in self.segments:
            for rec in seg:
                chain = hashlib.sha256(
                    (chain + _wal_line(rec)).encode()).hexdigest()
        return chain == self.chain

    def close(self):
        if self._sink is not None:
            self._sink.close()
            self._sink = None


@dataclass(frozen=True)
class BackpressurePolicy:
    """Admission backpressure at the submission edge (frozen: crosses
    the fork boundary inside ``ShardSpec`` unchanged — per-shard
    decorrelation comes from the gate stream seed, not the policy)."""

    max_pending: int = 64          # admitted-but-unfinished cap per shard
    per_tenant_cap: int = 0        # per-tenant in-flight cap (0 = uncapped)
    shed: str = "reject-newest"
    retry_after_s: float = 5.0     # client retry-after base (jittered)
    max_client_retries: int = 8    # rejects before a submission sheds

    def __post_init__(self):
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if self.per_tenant_cap < 0 or self.max_client_retries < 0:
            raise ValueError("per_tenant_cap / max_client_retries "
                             "must be >= 0")
        if self.retry_after_s <= 0:
            raise ValueError("retry_after_s must be > 0")
        if self.shed not in SHED_MODES:
            raise ValueError(f"unknown shed mode {self.shed!r}; "
                             f"expected one of {SHED_MODES}")


_COUNTERS = ("submissions", "admitted", "rejected", "retried", "shed",
             "done")
_GAUGES = ("queued", "running")
_FAULTS = ("dropped", "duplicated", "deduped", "redelivered")


class GatewayStats:
    """qstat-style introspection: per-tenant counters and gauges, plus
    gateway-level peaks and the retry-after horizon.  ``snapshot()``
    emits plain dicts; ``merge_gateway_snapshots`` unions shards."""

    def __init__(self, policy: BackpressurePolicy):
        self.policy = policy
        self.tenants: Dict[str, Dict[str, int]] = {}
        self.peak_pending = 0       # max admitted-but-unfinished depth
        self.peak_waiting = 0       # max retry-room depth
        self.retry_horizon_t = 0.0  # latest scheduled retry instant
        self.dropped = 0            # chaos transport drops (recovered)
        self.duplicated = 0         # chaos transport duplicates
        self.deduped = 0            # deliveries suppressed by the id set
        self.redelivered = 0        # WAL-recovery delivery attempts

    def row(self, tenant: str) -> Dict[str, int]:
        r = self.tenants.get(tenant)
        if r is None:
            r = self.tenants[tenant] = {k: 0 for k in _COUNTERS + _GAUGES}
        return r

    def bump(self, tenant: str, key: str, n: int = 1):
        self.row(tenant)[key] += n

    def snapshot(self, wal: Optional[SubmissionWAL] = None) -> dict:
        p = self.policy
        totals = {k: 0 for k in _COUNTERS + _GAUGES}
        tenants = {}
        for tenant in sorted(self.tenants):
            r = dict(self.tenants[tenant])
            tenants[tenant] = r
            for k in totals:
                totals[k] += r[k]
        snap = {
            "policy": {"max_pending": p.max_pending,
                       "per_tenant_cap": p.per_tenant_cap,
                       "shed": p.shed,
                       "retry_after_s": p.retry_after_s,
                       "max_client_retries": p.max_client_retries},
            "tenants": tenants,
            "totals": totals,
            "peak_pending": self.peak_pending,
            "peak_waiting": self.peak_waiting,
            "retry_horizon_t": round(self.retry_horizon_t, 9),
            "faults": {"dropped": self.dropped,
                       "duplicated": self.duplicated,
                       "deduped": self.deduped,
                       "redelivered": self.redelivered},
        }
        if wal is not None:
            snap["wal"] = {"records": wal.count, "replayed": wal.replayed,
                           "chain": wal.chain}
        return snap


def merge_gateway_snapshots(snaps) -> dict:
    """Exact cross-shard merge (the PR-6 partial discipline): counters
    and gauges sum (tenants are shard-disjoint, so key-union), per-shard
    peaks and the retry horizon take the max, WAL record counts sum
    (the per-shard chain heads are per-log and are not merged)."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return {}
    out = {"policy": dict(snaps[0]["policy"]), "tenants": {},
           "totals": {k: 0 for k in _COUNTERS + _GAUGES},
           "peak_pending": 0, "peak_waiting": 0, "retry_horizon_t": 0.0,
           "faults": {k: 0 for k in _FAULTS}}
    any_wal = any("wal" in s for s in snaps)
    if any_wal:
        out["wal"] = {"records": 0, "replayed": 0}
    for s in snaps:
        for tenant, r in s["tenants"].items():
            mine = out["tenants"].setdefault(
                tenant, {k: 0 for k in _COUNTERS + _GAUGES})
            for k, v in r.items():
                mine[k] = mine.get(k, 0) + v
        for k, v in s["totals"].items():
            out["totals"][k] = out["totals"].get(k, 0) + v
        out["peak_pending"] = max(out["peak_pending"], s["peak_pending"])
        out["peak_waiting"] = max(out["peak_waiting"], s["peak_waiting"])
        out["retry_horizon_t"] = max(out["retry_horizon_t"],
                                     s["retry_horizon_t"])
        for k, v in s["faults"].items():
            out["faults"][k] = out["faults"].get(k, 0) + v
        if "wal" in s:
            out["wal"]["records"] += s["wal"]["records"]
            out["wal"]["replayed"] += s["wal"]["replayed"]
    out["tenants"] = {t: out["tenants"][t] for t in sorted(out["tenants"])}
    return out


class _Sub:
    """One logged submission riding through the gate."""

    __slots__ = ("id", "wf", "tenant", "attempts", "delivered", "shed")

    def __init__(self, sub_id: int, wf, tenant: str):
        self.id = sub_id
        self.wf = wf
        self.tenant = tenant
        self.attempts = 0
        self.delivered = False
        self.shed = False


class DurableGateway:
    """The durable front door: sits between ``WorkflowGateway`` (its
    ``send_to``) and ``engine.submit``, logging every submission to the
    WAL and enforcing the backpressure policy at submit time.

    Wiring (see ``ControlPlane``): ``WorkflowGateway(send_to=gate.offer)``
    and ``engine.on_workflow_done = gate.workflow_done``; ``gate.inner``
    points back at the stream gateway so completions and sheds keep the
    closed-loop streams flowing and the drain accounting exact.

    When no submission is ever rejected the gate adds zero sim events
    and performs zero RNG draws — bit-identical to running without it.
    """

    def __init__(self, sim, deliver: Callable, policy: BackpressurePolicy,
                 seed: int = 0, shard: int = 0,
                 wal_path: Optional[str] = None,
                 chaos=None, arbiter=None, metrics=None):
        self.sim = sim
        self.deliver_to = deliver
        self.policy = policy
        self.shard = shard
        self.rng = random.Random(gate_stream_seed(seed, shard))
        self.wal = SubmissionWAL(path=wal_path)
        self.chaos = chaos
        self.arbiter = arbiter
        self.metrics = metrics
        self.inner = None                       # owning WorkflowGateway
        self.stats = GatewayStats(policy)
        self.events: List[tuple] = []           # (t, id, tenant, kind)
        self._by_ns: Dict[str, _Sub] = {}
        self._waiting: Dict[int, _Sub] = {}     # insertion order = age
        self._delivered_ids = set()
        self._in_flight = 0
        self._tenant_running: Dict[str, int] = {}

    # -- introspection ----------------------------------------------------
    def pending(self) -> int:
        """Admitted-but-unfinished depth (the enforced bound)."""
        return self._in_flight

    def waiting(self) -> int:
        """Submissions parked in the retry room."""
        return len(self._waiting)

    def snapshot(self) -> dict:
        return self.stats.snapshot(wal=self.wal)

    def trace_events(self) -> List[dict]:
        """Gateway decisions for ``arrival_trace/v2`` capture."""
        return [{"t": t, "id": sub_id, "tenant": tenant, "event": kind}
                for t, sub_id, tenant, kind in self.events]

    # -- submission path ---------------------------------------------------
    def offer(self, wf):
        """One submission arriving at the gate (the stream gateway's
        ``send_to``): log it, then admit / reject under the policy."""
        tenant = wf.tenant
        rec = self.wal.append(
            tenant, self.sim.now(),
            workflow_digest(tenant, wf.name, wf.instance))
        sub = _Sub(rec["id"], wf, tenant)
        self._by_ns[wf.namespace()] = sub
        self.stats.bump(tenant, "submissions")
        self._try_admit(sub)

    def _has_room(self, tenant: str) -> bool:
        p = self.policy
        if self._in_flight >= p.max_pending:
            return False
        if p.per_tenant_cap and \
                self._tenant_running.get(tenant, 0) >= p.per_tenant_cap:
            return False
        return True

    def _try_admit(self, sub: _Sub):
        if self._has_room(sub.tenant):
            self._admit(sub)
        else:
            self._reject(sub)

    def _admit(self, sub: _Sub):
        self._in_flight += 1
        self._tenant_running[sub.tenant] = \
            self._tenant_running.get(sub.tenant, 0) + 1
        self.stats.bump(sub.tenant, "admitted")
        self.stats.bump(sub.tenant, "running")
        if self._in_flight > self.stats.peak_pending:
            self.stats.peak_pending = self._in_flight
        self._transport(sub)

    def _transport(self, sub: _Sub):
        """The gate -> engine hop, where the chaos plane may drop or
        duplicate the submission; the WAL makes both harmless."""
        fault = (self.chaos.gateway_fault_draw()
                 if self.chaos is not None else None)
        if fault == "drop":
            # the record is already durable: recover by redelivery
            self.stats.dropped += 1
            self.sim.after(self.policy.retry_after_s, self._redeliver,
                           args=(sub,), note="gate:redeliver")
            return
        self._deliver(sub)
        if fault == "dup":
            self.stats.duplicated += 1
            self._deliver(sub)      # second transport copy: deduped below

    def _deliver(self, sub: _Sub):
        if sub.id in self._delivered_ids:
            self.stats.deduped += 1     # exactly-once: id already landed
            return
        self._delivered_ids.add(sub.id)
        sub.delivered = True
        self.deliver_to(sub.wf)

    def _redeliver(self, sub: _Sub):
        self.stats.redelivered += 1
        self._transport(sub)

    def _reject(self, sub: _Sub):
        t = self.sim.now()
        self.stats.bump(sub.tenant, "rejected")
        self._note("reject", sub.tenant)
        self.events.append((t, sub.id, sub.tenant, "reject"))
        if sub.attempts >= self.policy.max_client_retries:
            self._shed(sub)
            return
        sub.attempts += 1
        # deterministic retry-after: base * [0.5, 1.5) jitter from the
        # dedicated gate stream (the only draws this module makes)
        delay = self.policy.retry_after_s * (0.5 + self.rng.random())
        due = t + delay
        if due > self.stats.retry_horizon_t:
            self.stats.retry_horizon_t = due
        self._waiting[sub.id] = sub
        self.stats.bump(sub.tenant, "queued")
        self.sim.after(delay, self._retry, args=(sub,), note="gate:retry")
        self._enforce_waiting_cap()
        # measure AFTER eviction: the gauge reports the enforced bound,
        # not the one-element transient while the victim is picked
        if len(self._waiting) > self.stats.peak_waiting:
            self.stats.peak_waiting = len(self._waiting)

    def _enforce_waiting_cap(self):
        if self.policy.shed == "reject-newest":
            return                  # client-side retries: no server room
        while len(self._waiting) > self.policy.max_pending:
            self._shed(self._pick_victim())

    def _pick_victim(self) -> _Sub:
        if self.policy.shed == "fair-shed":
            by_tenant: Dict[str, int] = {}
            for sub in self._waiting.values():
                by_tenant[sub.tenant] = by_tenant.get(sub.tenant, 0) + 1
            hog = min(by_tenant, key=lambda t: (-by_tenant[t], t))
            for sub in self._waiting.values():     # oldest of the hog
                if sub.tenant == hog:
                    return sub
        return next(iter(self._waiting.values()))  # shed-oldest: global

    def _retry(self, sub: _Sub):
        if sub.shed or sub.id not in self._waiting:
            return                  # shed while parked: timer is a no-op
        del self._waiting[sub.id]
        self.stats.bump(sub.tenant, "queued", -1)
        self.stats.bump(sub.tenant, "retried")
        self._note("retry", sub.tenant)
        self.events.append((self.sim.now(), sub.id, sub.tenant, "retry"))
        self._try_admit(sub)

    def _shed(self, sub: _Sub):
        sub.shed = True
        if self._waiting.pop(sub.id, None) is not None:
            self.stats.bump(sub.tenant, "queued", -1)
        self.stats.bump(sub.tenant, "shed")
        self._note("shed", sub.tenant)
        self.events.append((self.sim.now(), sub.id, sub.tenant, "shed"))
        self._by_ns.pop(sub.wf.namespace(), None)
        if self.inner is not None:
            # release the owning stream (closed-loop flow + drain
            # accounting) one event later: eviction chains on deep
            # closed-loop queues must not recurse through the gate
            self.sim.after(0.0, self.inner.workflow_done, args=(sub.wf,),
                           note="gate:shed-release")

    def _note(self, kind: str, tenant: str):
        if self.arbiter is not None:
            self.arbiter.note_gateway(kind)
        if self.metrics is not None:
            self.metrics.note_gateway(kind, tenant)

    # -- completion routing -----------------------------------------------
    def workflow_done(self, wf):
        sub = self._by_ns.pop(wf.namespace(), None)
        if sub is not None:
            self._in_flight -= 1
            self._tenant_running[sub.tenant] -= 1
            self.stats.bump(sub.tenant, "running", -1)
            self.stats.bump(sub.tenant, "done")
        if self.inner is not None:
            self.inner.workflow_done(wf)

    def close(self):
        self.wal.close()
