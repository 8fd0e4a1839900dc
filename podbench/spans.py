"""What the readers of the program's own spans share.

The program marks its layers with ``record_function`` ranges named
``repro_torch.<name>`` while a profiler records (``repro_torch/trace.py``).
These readers take them from the bare traced window (``tracing.WINDOW``:
no synchronised range, so the card runs as it does untraced but for the
profiler's own cost) and give each reading a step. A program without the
spans (an older commit) gives no reading, and raises nothing.

Device time under a span is that of the kernels (and copies) whose launch
record, the runtime call that launched them (on any thread: the autograd
engine's backward thread too), starts inside the span's host interval: a
kernel and its runtime call share CUPTI's correlation id. Every runtime
call counts, also one with events under it: a launch that waits for a
full command buffer holds a ``Command Buffer Full`` event, and
``View.launches`` keeps only calls with none. Where the kernels with no
launch record still hold more than ``MISSING`` of the window's kernel
time, a reader gives no reading rather than a low one.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

PREFIX = "repro_torch."
MISSING = 0.01


def launch_times(view) -> dict:
    """{correlation id: host start} of the runtime calls (``cu*`` events)
    that launched the window's kernels and copies."""
    out = {}
    for e in view.cpu:
        if e.name.startswith("cu") and e.id in view.device_us:
            out.setdefault(e.id, e.time_range.start)
    return out


class _Spans:
    """The host intervals of the window's spans ``names`` (disjoint)."""

    def __init__(self, view, *names: str):
        self.spans = sorted((e.time_range.start, e.time_range.end) for n in names
                            for e in view.op_events(PREFIX + n))
        self.starts = [s for s, _ in self.spans]

    def __contains__(self, t: float) -> bool:
        j = bisect.bisect_right(self.starts, t) - 1
        return j >= 0 and t <= self.spans[j][1]


def device_ms(view, *names: str):
    """Device ms a step of the kernels launched inside the window's spans
    ``names`` (disjoint), or None: no such span, or too many kernels with
    no launch record."""
    spans = _Spans(view, *names)
    launched = launch_times(view)
    total = sum(view.device_us.values())
    missing = sum(us for i, us in view.device_us.items() if i not in launched)
    if not spans.spans or total <= 0 or missing > MISSING * total:
        return None
    us = sum(view.device_us[i] for i, t in launched.items() if t in spans)
    return us / 1e3 / view.steps


def _operators(view) -> list:
    """The window's operators that the host dispatched itself: each
    ``aten::`` event that no other ``aten::`` event of its thread contains.
    Read from the times, not from ``cpu_parent``: the profiler's own events
    (a ``Buffer Flush``) can straddle an operator and take its children."""
    by_thread = defaultdict(list)
    for e in view.cpu:
        if e.name.startswith("aten::"):
            by_thread[e.thread].append(e)
    out = []
    for evs in by_thread.values():
        end = float("-inf")
        for e in sorted(evs, key=lambda e: (e.time_range.start, -e.time_range.end)):
            if e.time_range.start >= end:
                out.append(e)
                end = e.time_range.end
    return out


def host_ops(view, name: str):
    """The operators (``_operators``) dispatched inside the window's spans
    ``name``, on any thread, a step; None where there are none."""
    spans = _Spans(view, name)
    if not spans.spans:
        return None
    n = sum(1 for e in _operators(view)
            if e.time_range.start in spans and e.time_range.end in spans)
    return n / view.steps
