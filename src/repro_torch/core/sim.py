"""Discrete-event simulation core.

One single-threaded event queue drives the whole control plane
(cluster, informers, engines, pollers). Payloads can be:

  * virtual  — a declared duration advances the clock (paper-scale
               numbers reproduce instantly; used by benchmarks),
  * real     — the callable executes NOW (e.g. a jitted JAX step) and
               its measured wall-time becomes the virtual duration
               (used by the ML workflow examples and tests).

This "virtual time, real work" design is what lets a 1-core container
model a 6-node cluster faithfully: concurrency exists in virtual time,
while real payloads still run and produce real arrays.

Scale notes: each scheduled event is a ``__slots__`` record, not a
closure-capturing tuple; hot callers pass ``args=`` instead of
allocating a lambda per event. ``events_processed`` counts executed
events so benchmarks can report events/sec, and the ``note`` string is
kept on the record — a ``max_events`` overflow names the next pending
notes so runaway polling loops identify their culprit.

Queue backends (ISSUE 3): the sim's event-time distribution is bimodal
— large same-instant batches stitched together by small constant
control-plane latencies (0.02–1.2 s), plus long pod durations (10 s+)
and far-future daemons.  A binary heap pays O(log n) tuple comparisons
per push/pop against the WHOLE outstanding set (tens of thousands of
pending finish events at the 10k-workflow tier).  The default backend
is therefore a two-level *calendar queue*: a ring of fixed-width
near-future buckets (each a tiny heap) plus one far-future overflow
heap that migrates into the ring as the window advances.  Pop order is
exactly ``(t, seq)`` — identical to the heap backend, FIFO tie-break
included — which ``tests/test_event_core.py`` pins with a property
test.  ``REPRO_SIM_QUEUE=heap`` (or ``Sim(queue="heap")``) restores
the single-heap backend for reproduction runs.

``run(until=...)`` leaves the clock at ``until`` even when the queue
drains early, so a horizon is a horizon regardless of load; the time
of the last *processed* event stays available as ``last_event_t``
(benchmarks report it as the makespan).
"""
from __future__ import annotations

import heapq
import itertools
import os
import time
from typing import Callable, List, Optional, Tuple


class Event:
    """One scheduled callback: ``fn(*args)`` at a point in virtual time."""

    __slots__ = ("fn", "args", "note", "daemon")

    def __init__(self, fn: Callable, args: Tuple, note: str, daemon: bool):
        self.fn = fn
        self.args = args
        self.note = note
        self.daemon = daemon


class HeapQueue:
    """The classic backend: one binary heap of ``(t, seq, Event)``."""

    name = "heap"
    __slots__ = ("_q",)

    def __init__(self):
        self._q: List[Tuple[float, int, Event]] = []

    def __len__(self) -> int:
        return len(self._q)

    def push(self, t: float, seq: int, ev: Event):
        heapq.heappush(self._q, (t, seq, ev))

    def pop_due(self, until: Optional[float]):
        """Remove and return the earliest ``(t, seq, Event)``, or None
        when the queue is empty or the head lies beyond ``until`` (the
        head is left in place so a later ``run`` can resume)."""
        q = self._q
        if not q:
            return None
        if until is not None and q[0][0] > until:
            return None
        return heapq.heappop(q)

    def head_notes(self, n: int) -> List[str]:
        return [e.note for _, _, e in heapq.nsmallest(n, self._q) if e.note]


class CalendarQueue:
    """Two-level calendar queue with exact ``(t, seq)`` pop order.

    Near future: a power-of-two ring of fixed-width buckets, each a
    small heap — pushes into the dense "now + control-plane latency"
    region cost O(log bucket) against a handful of events instead of
    O(log n) against the whole queue.  Far future (``t`` beyond the
    ring window): one overflow heap, migrated bucket-ward as the
    current-bucket cursor advances, so every event is re-heaped at
    most once.  Because buckets partition time and migration always
    runs before the cursor can pass an overflow event's bucket, the
    head of the cursor bucket is the global ``(t, seq)`` minimum.
    """

    name = "calendar"
    __slots__ = ("_width", "_inv", "_nb", "_mask", "_buckets", "_cur",
                 "_far", "_near_len")

    def __init__(self, width: float = 0.25, n_buckets: int = 256):
        assert n_buckets & (n_buckets - 1) == 0, "n_buckets must be 2**k"
        self._width = width
        self._inv = 1.0 / width
        self._nb = n_buckets
        self._mask = n_buckets - 1
        self._buckets: List[List[Tuple[float, int, Event]]] = \
            [[] for _ in range(n_buckets)]
        self._cur = 0                    # absolute index of cursor bucket
        self._far: List[Tuple[float, int, Event]] = []
        self._near_len = 0

    def __len__(self) -> int:
        return self._near_len + len(self._far)

    def push(self, t: float, seq: int, ev: Event):
        # int(t * inv) is monotone in t, so an event never lands in a
        # bucket the cursor has already passed (callers push t >= now,
        # and the cursor only advances through empty buckets)
        abi = int(t * self._inv)
        if abi >= self._cur + self._nb:
            heapq.heappush(self._far, (t, seq, ev))
        else:
            heapq.heappush(self._buckets[abi & self._mask], (t, seq, ev))
            self._near_len += 1

    def _advance(self):
        """Move the cursor to the bucket holding the global minimum and
        return that bucket (None when the queue is empty).  Overflow
        events whose bucket enters the window are migrated before the
        cursor can step past them."""
        far = self._far
        if not self._near_len:
            if not far:
                return None
            self._cur = int(far[0][0] * self._inv)   # rebase onto far-min
        buckets, mask, nb, width = self._buckets, self._mask, self._nb, self._width
        while True:
            if far:
                end_t = (self._cur + nb) * width
                if far[0][0] < end_t:
                    inv = self._inv
                    near_gain = 0
                    while far and far[0][0] < end_t:
                        item = heapq.heappop(far)
                        heapq.heappush(buckets[int(item[0] * inv) & mask], item)
                        near_gain += 1
                    self._near_len += near_gain
            b = buckets[self._cur & mask]
            if b:
                return b
            self._cur += 1

    def pop_due(self, until: Optional[float]):
        # locate the global minimum READ-ONLY first: cursor movement and
        # far->near migration are committed only when an event actually
        # pops.  A declined pop (horizon) must leave the queue untouched,
        # otherwise a later push below the peeked time would land behind
        # the cursor and come out late (and out of order).
        far = self._far
        if self._near_len:
            buckets, mask = self._buckets, self._mask
            cur = self._cur
            while True:
                b = buckets[cur & mask]
                if b:
                    break
                cur += 1
            item = b[0]
            if far and far[0] < item:
                item, b = far[0], None     # true min still in the far heap
        elif far:
            item, b = far[0], None
        else:
            return None
        if until is not None and item[0] > until:
            return None
        if b is None:
            # rebase/migrate; _advance lands on the far item's bucket
            # (every bucket before it is empty by construction)
            b = self._advance()
        else:
            # committing is safe deferred-migration-wise: every far event
            # has t >= the popped min, hence bucket index >= cur
            self._cur = cur
        self._near_len -= 1
        return heapq.heappop(b)

    def head_notes(self, n: int) -> List[str]:
        items = [it for b in self._buckets for it in b]
        items.extend(self._far)
        return [e.note for _, _, e in heapq.nsmallest(n, items) if e.note]


QUEUE_BACKENDS = {"heap": HeapQueue, "calendar": CalendarQueue}


class Sim:
    def __init__(self, queue: Optional[str] = None):
        self.t = 0.0
        self.last_event_t = 0.0          # time of last processed event
        self.run_wall_s = 0.0            # real seconds inside run() loops
        self.run_cpu_s = 0.0             # process CPU seconds inside run()
        if queue is None:
            queue = os.environ.get("REPRO_SIM_QUEUE", "calendar")
        if queue not in QUEUE_BACKENDS:
            raise ValueError(f"unknown sim queue {queue!r}; "
                             f"expected one of {sorted(QUEUE_BACKENDS)}")
        self.queue_name = queue
        self._q = QUEUE_BACKENDS[queue]()
        self._seq = itertools.count()
        self._live = 0      # non-daemon events outstanding
        self.events_processed = 0

    def at(self, t: float, fn: Callable, note: str = "",
           daemon: bool = False, args: Tuple = ()):
        if not daemon:
            self._live += 1
        # record layout unchanged: (time, tie-break seq, record)
        self._q.push(t if t > self.t else self.t,
                     next(self._seq),
                     Event(fn, args, note, daemon))

    def after(self, dt: float, fn: Callable, note: str = "",
              daemon: bool = False, args: Tuple = ()):
        self.at(self.t + (dt if dt > 0.0 else 0.0), fn, note,
                daemon=daemon, args=args)

    def now(self) -> float:
        return self.t

    def run(self, until: Optional[float] = None, max_events: int = 10_000_000):
        """Process events until only daemon events remain (informer
        resyncs, metric samplers) or the horizon is reached.  On exit
        the clock stands at ``until`` (when given) even if the queue
        drained first; ``last_event_t`` keeps the drain time."""
        n = 0
        wall0 = time.perf_counter()
        cpu0 = time.process_time()
        pop = self._q.pop_due
        while self._live > 0:
            item = pop(until)
            if item is None:
                break
            t, _, ev = item
            self.t = self.last_event_t = t
            if not ev.daemon:
                self._live -= 1
            ev.fn(*ev.args)
            n += 1
            if n >= max_events:
                self.events_processed += n
                notes = self._q.head_notes(8)
                raise RuntimeError(
                    f"sim exceeded {max_events} events — likely a polling "
                    f"loop never terminated; next pending notes: "
                    f"{notes if notes else '(unnamed events)'}")
        self.events_processed += n
        # wall time of event processing only — ends with the last
        # processed event (the clock's last_event_t), so throughput
        # figures exclude setup before the loop and any epilogue after
        # it (benchmarks divide events by this, see bench_scale)
        self.run_wall_s += time.perf_counter() - wall0
        self.run_cpu_s += time.process_time() - cpu0
        if until is not None and until > self.t:
            self.t = until

    def idle(self) -> bool:
        return self._live == 0


def measure_wall(fn: Callable[[], None]) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
