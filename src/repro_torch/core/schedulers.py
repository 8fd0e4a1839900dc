"""Level-1 workflow scheduling algorithms.

The paper's algorithm is top-down topological order; KubeAdaptor's job
is to make the level-2 (cluster) execution follow whatever order the
level-1 algorithm emits. We ship the paper's algorithm plus a
longest-path-first variant to demonstrate the docking framework is
algorithm-agnostic (the engine consumes any ``order_ready``).

``SCHEDULERS`` is the registry the ControlPlane builder resolves its
``scheduler=`` knob against (core/runner.py); register new level-1
algorithms here to make them selectable by name in experiments and
benchmarks.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.core.dag import Workflow


class TopologicalScheduler:
    """Paper §5.2: schedule tasks topologically, top-down."""

    name = "topological"

    def __init__(self, wf: Workflow):
        self.rank = {tid: i for i, tid in enumerate(wf.topo_order())}

    def order_ready(self, ready: Sequence[str]) -> List[str]:
        return sorted(ready, key=lambda t: self.rank[t])


class LongestPathScheduler:
    """HEFT-flavoured: higher upward-rank (height to exit) first."""

    name = "longest-path"

    def __init__(self, wf: Workflow):
        height: Dict[str, int] = {}
        for tid in reversed(wf.topo_order()):
            t = wf.tasks[tid]
            height[tid] = 1 + max((height[o] for o in t.outputs), default=-1)
        self.height = height
        self.rank = {tid: i for i, tid in enumerate(wf.topo_order())}

    def order_ready(self, ready: Sequence[str]) -> List[str]:
        return sorted(ready, key=lambda t: (-self.height[t], self.rank[t]))


SCHEDULERS = {
    "topological": TopologicalScheduler,
    "longest-path": LongestPathScheduler,
}
