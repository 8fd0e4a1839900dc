"""The traced run: ``torch.profiler`` over a short window, and what the
per-layer readers read from it.

The window (``WINDOW``) runs the cell's steps bare: the device's busy and
idle time, the model FLOPs, the kernels and the autograd nodes are read
there, where only the profiler adds its cost. Around the program's
functions that a reader names (its ``RANGES``: label -> (module,
attribute)) a second run of as many steps (``RANGED``) puts a
``record_function`` range, with a ``torch.cuda.synchronize()`` on either
side, so that every kernel the call launches (the autograd engine's
backward thread included) runs inside the range's host interval; those
synchronisations idle the card, so nothing else is read there.

The arithmetic is copied from ``scripts/profile_serve.py`` (``busy_us``:
the union of kernel intervals; ``_descendants``: the operators under a
CPU event) and ``scripts/profile_train.py`` (device time under an
autograd node's ``evaluate_function`` event). A kernel is attributed to
a backward node through the runtime call, made inside the node's host
interval, that launched it (the two share CUPTI's correlation id), not
through the CPU events' ``kernels`` lists: on torch 2.11 those name some
kernels under more than one event (K1's 28 launches of one qwen2-1.5b
prefill: 213.1 device ms, 297.0 in the lists).
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
from collections import defaultdict

WINDOW = "podbench.window"
RANGED = "podbench.ranged"


def union_us(spans) -> float:
    """The length of the union of [start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _descendants(evt):
    for child in evt.cpu_children:
        yield child
        yield from _descendants(child)


@contextlib.contextmanager
def ranges(patches: dict, sync):
    """Wrap each ``(module, attribute)`` of ``patches`` (label -> target)
    in a profiler range named by its label, synchronised on both sides."""
    import torch
    saved = []

    def labelled(fn, label):
        def call(*args, **kw):
            sync()
            with torch.profiler.record_function(label):
                out = fn(*args, **kw)
                sync()
            return out
        return call
    try:
        for label, (mod_name, attr) in patches.items():
            mod = importlib.import_module(mod_name)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, labelled(getattr(mod, attr), label))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


class View:
    """What a per-layer reader reads: the traced window's device kernels,
    its CPU events, the ranged run's ranges and kernels, the number of
    steps (or request batches) each holds, and the cell."""

    def __init__(self, prof, steps: int, cell):
        from torch.autograd import DeviceType
        self.cell, self.steps = cell, steps
        events = prof.events()
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        self.window = _span(cpu, WINDOW)
        ranged = _span(cpu, RANGED) if any(e.name == RANGED for e in cpu) else (0, 0)
        self.cpu = [e for e in cpu if _inside(e, self.window)]
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        self.kernels = [(e.name, e.time_range.start, e.time_range.end) for e in device
                        if _inside(e, self.window)]
        self.ranged_kernels = [(e.name, e.time_range.start, e.time_range.end) for e in device
                               if _inside(e, ranged)]
        # a kernel's event and the runtime call that launched it (a leaf CPU
        # event under the launching operator) carry one CUPTI correlation id
        self.device_us = {e.id: e.time_range.elapsed_us() for e in device
                          if _inside(e, self.window)}
        self.launches = sorted((e.time_range.start, e.id) for e in self.cpu
                               if not e.cpu_children and e.name.startswith("cu"))
        self.ranges = defaultdict(list)
        for e in cpu:
            if e.name.startswith("podbench.") and e.name not in (WINDOW, RANGED):
                self.ranges[e.name].append((e.time_range.start, e.time_range.end))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us((s, e) for _, s, e in self.kernels) / 1e6

    def busy_in(self, label: str) -> float:
        """Device seconds (the union of kernel intervals) inside the host
        intervals of the range ``label``, in the ranged run."""
        spans = sorted(self.ranges.get(label, []))
        starts = [s for s, _ in spans]
        inside = []
        for _, ks, ke in self.ranged_kernels:
            i = bisect.bisect_right(starts, ks) - 1
            if i >= 0 and ke <= spans[i][1]:
                inside.append((ks, ke))
        return union_us(inside) / 1e6

    def kernel_s_under(self, events) -> float:
        """Device seconds of the kernels (and copies) launched during
        ``events``: the device events whose correlation id is that of a
        runtime call (``cudaLaunchKernel`` and the like) made inside one of
        the events' host intervals, on any thread (a backward node's
        launches are its own: the main thread waits meanwhile), each
        counted once."""
        spans = sorted((e.time_range.start, e.time_range.end) for e in events)
        starts = [s for s, _ in spans]
        total = 0.0
        for t, i in self.launches:
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and t <= spans[j][1]:
                total += self.device_us.get(i, 0.0)
        return total / 1e6

    def node_events(self, fragment: str) -> list:
        """The autograd engine's ``evaluate_function`` events of nodes whose
        name contains ``fragment`` (a kernel's backward)."""
        return [e for e in self.cpu if e.name.startswith("autograd::engine::evaluate_function")
                and fragment in e.name]

    def op_events(self, name: str) -> list:
        """The CPU events of operator ``name`` (e.g. ``repro_torch::k1_fwd``)
        inside the window."""
        return [e for e in self.cpu if e.name == name]

    def kernels_named(self, *fragments: str) -> list:
        """The window's kernels ((name, start, end)) whose names contain
        one of ``fragments``."""
        return [k for k in self.kernels if any(f in k[0] for f in fragments)]

    def top_ops(self, n: int = 10) -> list:
        by_name = defaultdict(float)
        for name, s, e in self.kernels:
            by_name[name[:200]] += (e - s) / 1e6
        return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle gaps inside the window, summed by what the host
        was doing at each gap's start: of the innermost CPU events covering
        it on each thread (the main thread, the autograd engine's), the one
        that started last."""
        spans = sorted((s, e) for _, s, e in self.kernels)
        gaps = []
        cur = self.window[0]
        for s, e in spans:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.window[1] > cur:
            gaps.append((cur, self.window[1]))
        by_thread = defaultdict(list)
        for e in self.cpu:
            by_thread[e.thread].append((e.time_range.start, -e.time_range.end, e.name))
        inner = [_innermost(sorted(evts), [g0 for g0, _ in gaps]) for evts in by_thread.values()]
        by_label = defaultdict(float)
        for j, (g0, g1) in enumerate(gaps):
            found = [t[j] for t in inner if t[j] is not None]
            label = max(found)[1] if found else "host (no event)"
            by_label[label[:200]] += (g1 - g0) / 1e6
        return sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])[:n]


def _span(cpu, name: str) -> tuple:
    found = [e for e in cpu if e.name == name]
    if len(found) != 1:
        raise RuntimeError(f"the trace holds {len(found)} ranges {name}, not 1")
    return found[0].time_range.start, found[0].time_range.end


def _inside(e, span) -> bool:
    return span[0] <= e.time_range.start and e.time_range.end <= span[1]


def _innermost(events, times) -> list:
    """For each of ``times`` (ascending), (start, name) of the innermost of
    one thread's nested ``events`` ((start, -end, name), sorted) covering
    it, or None."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            s, neg_e, name = events[i]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((-neg_e, s, name))
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out.append((stack[-1][1], stack[-1][2]) if stack else None)
    return out
