"""Event-trigger mechanism (§4.6): registry + callbacks.

The registry ties KubeAdaptor's modules together: informer handlers
emit events ('pod-succeeded', 'pod-deleted', ...), registered callbacks
respond in the same virtual instant — the quick create/destroy switch
the paper credits for its resource-usage advantage.

Dispatch passes positional args through the sim's event record (no
per-callback lambda allocation on the hot pod-lifecycle path).

Scale fast path (ISSUE 3): same-instant dispatches coalesce.  The old
path scheduled one zero-delay sim event per callback per emit — two
per pod (pod-succeeded, pod-removed) on the lifecycle hot path.  Now
the first emit of an instant opens a dispatch buffer and schedules one
flush; subsequent emits at that instant append.  The flush fires the
callbacks in exact emit order at the same virtual instant and with the
same position in the instant's event sequence the first per-callback
event would have had (callbacks scheduled between two emits of one
instant can only target *later* times, so nothing can interleave —
the same argument that makes the cluster's lifecycle batches exact).
Emits issued *during* a flush open a fresh buffer, matching the old
behaviour of a nested emit queuing behind the current event.
``EventRegistry(sim, batched=False)`` restores the per-callback path
(the ControlPlane ties it to its ``lifecycle="chained"`` mode).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.sim import Sim


class EventRegistry:
    def __init__(self, sim: Sim, batched: bool = True):
        self.sim = sim
        self.batched = batched
        self._subs: Dict[str, List[Callable]] = defaultdict(list)
        self.emitted: Dict[str, int] = defaultdict(int)
        # open same-instant dispatch batch: (instant, [(cb, args), ...])
        self._buf: Optional[Tuple[float, List[Tuple[Callable, tuple]]]] = None

    def register(self, name: str, cb: Callable):
        self._subs[name].append(cb)

    def emit(self, name: str, *args, **kw):
        self.emitted[name] += 1
        if kw or not self.batched:
            for cb in list(self._subs[name]):
                # event dispatch is in-process: effectively immediate
                if kw:
                    self.sim.after(0.0, (lambda c=cb: c(*args, **kw)), note=name)
                else:
                    self.sim.after(0.0, cb, note=name, args=args)
            return
        subs = self._subs[name]
        if not subs:
            return
        now = self.sim.t
        buf = self._buf
        if buf is not None and buf[0] == now:
            pending = buf[1]
        else:
            pending = []
            self._buf = (now, pending)
            self.sim.after(0.0, self._flush, note="event-dispatch",
                           args=(now, pending))
        for cb in subs:
            pending.append((cb, args))

    def _flush(self, due: float, pending: List[Tuple[Callable, tuple]]):
        buf = self._buf
        if buf is not None and buf[0] == due and buf[1] is pending:
            self._buf = None        # emits during the flush re-arm
        for cb, args in pending:
            cb(*args)
