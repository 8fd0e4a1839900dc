"""Workflow injection (§4.4) — from serial side-car to multi-tenant gateway.

The paper's injector maps to three sub-modules: the Workflow Parser
reads ConfigMap JSON (configs/workflows.py), the Workflow Sending
Module pushes workflows over the in-process "gRPC" channel (a small
fixed latency), and the Next Workflow Trigger Module responds to the
engine's completion events by sending the next instance.

Two front-ends share that machinery:

* ``WorkflowInjector`` — the paper's strictly-serial injector, kept
  verbatim for the single-stream reproduction experiments.
* ``WorkflowGateway`` — the multi-tenant generalization: N concurrent
  *streams* (one queue per tenant workload), each with a pluggable
  arrival process:

    serial      next-trigger, exactly the paper's behaviour
    concurrent  keep ``concurrency`` instances of the stream in flight
    poisson     seeded exponential inter-arrival times at ``rate``/s,
                ``burst`` instances per arrival, independent of
                completions (open-loop traffic)
    trace       exact replay of recorded ``(t, tenant, topology)``
                arrival records (``load_trace``) — open-loop like
                poisson, but driven by a real cluster log instead of a
                synthetic process

  Streams are drained from ``collections.deque`` (O(1) pops); the
  gateway allocates globally unique instance ids per workflow name so
  namespaces and metric keys never collide across tenants.

  The gateway also *captures*: every dispatch (any arrival mode) is
  logged at its pre-gRPC instant and ``record_trace()`` emits the run
  as an ``arrival_trace/v1`` document, so a live run's arrivals can be
  replayed exactly via ``load_trace`` — closing the ROADMAP's
  capture/replay loop.
"""
from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.core.dag import Workflow, make_workflow
from repro_torch.core.sim import Sim

GRPC_LATENCY = 0.02

ARRIVAL_MODES = ("serial", "concurrent", "poisson", "trace")

# v1: tenants + arrivals.  v2 adds a "gateway" section (the durable
# gate's policy echo plus its reject/retry/shed decision log) so a
# --trace replay is exact under backpressure.  load_trace only reads
# "arrivals", so v1 and v2 files both replay.
TRACE_SCHEMAS = ("arrival_trace/v1", "arrival_trace/v2")


class WorkflowInjector:
    """The paper's serial injector: one workflow in flight at a time."""

    def __init__(self, sim: Sim, send_to: Callable[[Workflow], None],
                 grpc_latency: float = GRPC_LATENCY):
        self.sim = sim
        self.send_to = send_to
        self.grpc_latency = grpc_latency
        self.queue: Deque[Workflow] = deque()
        self.sent = 0
        self.on_drained: Optional[Callable[[], None]] = None

    # -- workflow parser -------------------------------------------------
    def load_configmap(self, name: str, data, repeats: int = 1):
        base = make_workflow(name, data)
        for i in range(repeats):
            self.queue.append(base.with_instance(i))

    def load(self, workflows: List[Workflow]):
        self.queue.extend(workflows)

    # -- sending module ----------------------------------------------------
    def start(self):
        self._send_next()

    def _send_next(self):
        if not self.queue:
            if self.on_drained:
                self.on_drained()
            return
        wf = self.queue.popleft()
        self.sent += 1
        self.sim.after(self.grpc_latency, lambda: self.send_to(wf))

    # -- next-workflow trigger ----------------------------------------------
    def request_next(self, _wf: Optional[Workflow] = None):
        self._send_next()


@dataclass
class StreamSpec:
    """One tenant workload: a workflow repeated under an arrival process."""

    workflow: Workflow
    repeats: int = 1
    tenant: str = "default"
    arrival: str = "serial"        # serial | concurrent | poisson
    concurrency: int = 1           # in-flight cap for "concurrent"
    rate: float = 1.0              # arrivals per second for "poisson"
    burst: int = 1                 # instances per poisson arrival
    priority: int = 0              # admission priority (higher wins)
    weight: float = 1.0            # fair-share weight
    quota_cpu_m: int = 0           # hard admission cap (0 = uncapped)
    quota_mem_mi: int = 0
    deadline_s: float = 0.0        # per-workflow SLO deadline (0 = none)

    def __post_init__(self):
        if self.arrival not in ARRIVAL_MODES:
            raise ValueError(f"unknown arrival mode {self.arrival!r}; "
                             f"expected one of {ARRIVAL_MODES}")
        if self.arrival == "poisson" and self.rate <= 0:
            raise ValueError("poisson arrival needs rate > 0")
        if self.concurrency < 1 or self.burst < 1 or self.repeats < 0:
            raise ValueError("concurrency/burst must be >= 1, repeats >= 0")
        if self.quota_cpu_m < 0 or self.quota_mem_mi < 0 or self.deadline_s < 0:
            raise ValueError("quota caps / deadline must be >= 0")


class _Stream:
    def __init__(self, spec: StreamSpec, queue: Deque[Workflow]):
        self.spec = spec
        self.queue = queue
        self.in_flight = 0
        self.sent = 0

    def drained(self) -> bool:
        return not self.queue and self.in_flight == 0


class WorkflowGateway:
    """Multi-stream workflow source feeding one engine ``submit``.

    The engine's ``on_workflow_done`` must be wired to
    :meth:`workflow_done`; the gateway routes each completion back to
    the owning stream (closed-loop modes) and fires ``on_drained`` once
    every stream's queue is empty and nothing is in flight.
    """

    def __init__(self, sim: Sim, send_to: Callable[[Workflow], None],
                 grpc_latency: float = GRPC_LATENCY, seed: int = 0,
                 capture_trace: bool = True):
        self.sim = sim
        self.send_to = send_to
        self.grpc_latency = grpc_latency
        self.rng = random.Random(seed)
        self.streams: List[_Stream] = []
        self.sent = 0
        self.on_drained: Optional[Callable[[], None]] = None
        self._by_ns: Dict[str, _Stream] = {}
        self._instances: Dict[str, int] = {}     # workflow name -> next id
        self._started = False
        # every dispatch as (virtual t, tenant, topology) — the raw
        # material of record_trace (one small tuple per workflow).
        # capture_trace=False skips the log (record_trace unavailable):
        # at 1M workflows the tuples alone cost ~100 MB per shard.
        self.capture_trace = capture_trace
        self.trace_log: List[tuple] = []

    # -- stream registration ----------------------------------------------
    def add_stream(self, spec: StreamSpec) -> StreamSpec:
        base = spec.workflow
        if base.tenant != spec.tenant:
            base = base.with_tenant(spec.tenant)
        q: Deque[Workflow] = deque()
        for _ in range(spec.repeats):
            nxt = self._instances.get(base.name, 0)
            self._instances[base.name] = nxt + 1
            q.append(base.with_instance(nxt))
        stream = _Stream(spec, q)
        self.streams.append(stream)
        if self._started:
            self._kick(stream)
        return spec

    def load(self, workflows: List[Workflow], **spec_kw):
        """Convenience: one serial stream over an explicit instance list."""
        if not workflows:
            return
        spec = StreamSpec(workflow=workflows[0], repeats=0, **spec_kw)
        stream = _Stream(spec, deque(workflows))
        for wf in workflows:
            nxt = self._instances.get(wf.name, 0)
            self._instances[wf.name] = max(nxt, wf.instance + 1)
        self.streams.append(stream)
        if self._started:
            self._kick(stream)

    def load_trace(self, records, make: Callable[[str], Workflow]):
        """Replay an arrival trace exactly: each record —
        ``{"t": seconds, "tenant": name, "topology": key}`` — submits
        one instance of ``make(topology)`` (re-tenanted) at its
        recorded virtual time.  Ties keep file order.  Returns the
        trace stream (its queue holds ``(t, workflow)`` pairs)."""
        arrivals = sorted(
            ((float(rec["t"]), i, rec) for i, rec in enumerate(records)),
            key=lambda a: (a[0], a[1]))
        q: Deque = deque()
        for t, _i, rec in arrivals:
            if t < 0:
                raise ValueError(f"trace arrival at negative t={t}")
            base = make(rec["topology"])
            tenant = rec.get("tenant", "default")
            if base.tenant != tenant:
                base = base.with_tenant(tenant)
            nxt = self._instances.get(base.name, 0)
            self._instances[base.name] = nxt + 1
            q.append((t, base.with_instance(nxt)))
        first = q[0][1] if q else Workflow("trace-empty", {})
        stream = _Stream(StreamSpec(workflow=first, repeats=0,
                                    arrival="trace"), q)
        self.streams.append(stream)
        if self._started:
            self._kick(stream)
        return stream

    # -- sending module ----------------------------------------------------
    def start(self):
        if self._started:
            return
        self._started = True
        for stream in self.streams:
            self._kick(stream)
        if not self.streams:
            self._check_drained()

    def _kick(self, stream: _Stream):
        mode = stream.spec.arrival
        if mode == "serial":
            self._send_one(stream)
        elif mode == "concurrent":
            for _ in range(stream.spec.concurrency):
                self._send_one(stream)
        elif mode == "poisson":
            self._schedule_arrival(stream)
        elif mode == "trace":
            self._schedule_trace(stream)

    def _send_one(self, stream: _Stream):
        if not stream.queue:
            self._check_drained()
            return
        wf = stream.queue.popleft()
        stream.in_flight += 1
        stream.sent += 1
        self.sent += 1
        self._by_ns[wf.namespace()] = stream
        if self.capture_trace:
            self.trace_log.append((self.sim.now(), wf.tenant, wf.name))
        self.sim.after(self.grpc_latency, lambda: self.send_to(wf))

    def _schedule_arrival(self, stream: _Stream):
        if not stream.queue:
            return
        gap = self.rng.expovariate(stream.spec.rate)

        def arrive():
            for _ in range(stream.spec.burst):
                if stream.queue:
                    self._send_one(stream)
            self._schedule_arrival(stream)

        self.sim.after(gap, arrive)

    def _schedule_trace(self, stream: _Stream):
        if not stream.queue:
            self._check_drained()
            return
        due = stream.queue[0][0]

        def arrive():
            # every record due at this instant arrives in file order
            while stream.queue and stream.queue[0][0] <= self.sim.t:
                _t, wf = stream.queue.popleft()
                stream.in_flight += 1
                stream.sent += 1
                self.sent += 1
                self._by_ns[wf.namespace()] = stream
                if self.capture_trace:
                    self.trace_log.append(
                        (self.sim.now(), wf.tenant, wf.name))
                self.sim.after(self.grpc_latency,
                               lambda w=wf: self.send_to(w))
            self._schedule_trace(stream)

        self.sim.at(due, arrive, note="trace-arrival")

    # -- trace capture (arrival_trace/v1 + v2) ------------------------------
    def record_trace(self, path: Optional[str] = None, gate=None) -> dict:
        """Emit the run's dispatches as an ``arrival_trace/v1`` document
        (the exact format ``load_trace`` / ``ControlPlane.add_trace`` /
        ``bench_scale --trace`` replay).  Each dispatch is recorded at
        its pre-gRPC instant, so a replay reproduces every submission
        time exactly (round-trip pinned by tests/test_policy_pipeline).

        The ``topology`` key is the workflow's base name — a replay's
        ``make`` factory must resolve it (the default factory knows the
        paper topologies).  Tenant shares (priority / weight / quota
        caps / deadline) come from the registered stream specs.

        ``gate``: a ``DurableGateway`` — upgrades the document to
        ``arrival_trace/v2``, adding the gate's policy echo and its
        reject/retry/shed decision log (``gateway.events``) so a replay
        under the same policy reproduces every admission decision.
        Without a gate the schema stays ``v1`` byte-for-byte.
        """
        if not self.capture_trace and self.sent:
            raise RuntimeError("record_trace needs capture_trace=True — "
                               "this gateway was built with capture off")
        tenants: Dict[str, dict] = {}
        for stream in self.streams:
            spec = stream.spec
            share = {"priority": spec.priority, "weight": spec.weight}
            if spec.quota_cpu_m:
                share["quota_cpu_m"] = spec.quota_cpu_m
            if spec.quota_mem_mi:
                share["quota_mem_mi"] = spec.quota_mem_mi
            if spec.deadline_s:
                share["deadline_s"] = spec.deadline_s
            tenants[spec.tenant] = share
        doc = {
            "schema": "arrival_trace/v1",
            "tenants": tenants,
            "arrivals": [{"t": t, "tenant": tenant, "topology": topo}
                         for t, tenant, topo in self.trace_log],
        }
        if gate is not None:
            doc["schema"] = "arrival_trace/v2"
            doc["gateway"] = {"policy": gate.snapshot()["policy"],
                              "events": gate.trace_events()}
        if path is not None:
            import json
            with open(path, "w") as f:
                json.dump(doc, f, indent=2)
                f.write("\n")
        return doc

    # -- next-workflow trigger (completion routing) -------------------------
    def workflow_done(self, wf: Workflow):
        stream = self._by_ns.pop(wf.namespace(), None)
        if stream is None:
            self._check_drained()
            return
        stream.in_flight -= 1
        if stream.spec.arrival in ("serial", "concurrent"):
            self._send_one(stream)
        else:
            self._check_drained()

    # legacy alias so the gateway is a drop-in for WorkflowInjector
    request_next = workflow_done

    # -- drain bookkeeping ---------------------------------------------------
    def queued(self) -> int:
        return sum(len(s.queue) for s in self.streams)

    def pending(self) -> int:
        return self.queued() + sum(s.in_flight for s in self.streams)

    def _check_drained(self):
        if self.on_drained and all(s.drained() for s in self.streams):
            cb, self.on_drained = self.on_drained, None
            cb()
