"""Workflow DAG model + ConfigMap-JSON parser (paper Listing 1 format).

A workflow is a DAG of tasks; every task carries the six attributes of
the paper's task node (input, output, image, cpuNum, memNum, args) plus
an optional real payload callable. Data dependencies are realized
through the namespace's shared volume (core/volumes.py) exactly like
the paper's PVC/NFS mechanism.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core import calibration as cal


@dataclass
class Task:
    id: str
    inputs: List[str] = field(default_factory=list)     # upstream task ids
    outputs: List[str] = field(default_factory=list)    # downstream task ids
    image: str = "shanchenggang/task-emulator:latest"
    cpu_m: int = cal.TASK_CPU_M
    mem_mi: int = cal.TASK_MEM_MI
    args: List[str] = field(default_factory=list)
    duration_s: float = cal.TASK_DURATION_S              # virtual payload
    payload: Optional[Callable[..., Any]] = None         # real payload
    virtual: bool = False                                # entry/exit marker

    def resource_request(self):
        if self.virtual:
            return 50, 50      # negligible pause-container request
        return self.cpu_m, self.mem_mi

    def run_time(self) -> float:
        return 0.0 if self.virtual else self.duration_s


@dataclass
class Workflow:
    name: str
    tasks: Dict[str, Task]
    instance: int = 0          # repeat index (namespace uniquifier)
    tenant: str = "default"    # owning tenant (multi-tenant control plane)

    def __post_init__(self):
        self.validate()

    # -- structure ------------------------------------------------------
    def validate(self):
        ids = set(self.tasks)
        for t in self.tasks.values():
            for dep in t.inputs:
                if dep not in ids:
                    raise ValueError(f"{self.name}: {t.id} depends on unknown {dep}")
            for out in t.outputs:
                if out not in ids:
                    raise ValueError(f"{self.name}: {t.id} outputs to unknown {out}")
        # consistency of edges + acyclicity via topo sort
        self.topo_order()

    def edges(self):
        for t in self.tasks.values():
            for dep in t.inputs:
                yield dep, t.id

    def topo_order(self) -> List[str]:
        """Kahn topological order — ready tasks in insertion order (the
        level-1 scheduling algorithm of the paper: top-down topological)."""
        indeg = {tid: len(t.inputs) for tid, t in self.tasks.items()}
        ready = [tid for tid, d in indeg.items() if d == 0]
        out: List[str] = []
        while ready:
            tid = ready.pop(0)
            out.append(tid)
            for nxt in self.tasks[tid].outputs:
                indeg[nxt] -= 1
                if indeg[nxt] == 0:
                    ready.append(nxt)
        if len(out) != len(self.tasks):
            raise ValueError(f"{self.name}: cycle detected")
        return out

    def levels(self) -> List[List[str]]:
        """Level-synchronous partition (what the Batch Job baseline runs)."""
        depth: Dict[str, int] = {}
        for tid in self.topo_order():
            t = self.tasks[tid]
            depth[tid] = 1 + max((depth[d] for d in t.inputs), default=-1)
        n = max(depth.values()) + 1
        lv: List[List[str]] = [[] for _ in range(n)]
        for tid, d in depth.items():
            lv[d].append(tid)
        return lv

    def critical_path_len(self) -> int:
        return len(self.levels())

    def namespace(self) -> str:
        ns = self.__dict__.get("_ns")
        if ns is None:           # cached: called once per pod event at scale
            if self.tenant != "default":
                ns = f"wf-{self.tenant}-{self.name}-{self.instance}"
            else:
                ns = f"wf-{self.name}-{self.instance}"
            self._ns = ns
        return ns

    def _derive(self, instance: int, tenant: str) -> "Workflow":
        # instances share the validated task dict — re-running
        # validate() (a topo sort) per instance made building a
        # 100k-workflow stream O(instances x tasks) for nothing
        new = object.__new__(Workflow)
        new.name = self.name
        new.tasks = self.tasks
        new.instance = instance
        new.tenant = tenant
        return new

    def with_instance(self, i: int) -> "Workflow":
        return self._derive(i, self.tenant)

    def with_tenant(self, tenant: str) -> "Workflow":
        return self._derive(self.instance, tenant)

    def total_requests(self):
        cpu = sum(t.resource_request()[0] for t in self.tasks.values())
        mem = sum(t.resource_request()[1] for t in self.tasks.values())
        return cpu, mem


# ---------------------------------------------------------------------------
# ConfigMap (Listing 1) parsing: {"0": {"input": [], "output": ["1"], ...}}
# ---------------------------------------------------------------------------
def parse_configmap(data: str | Dict) -> Dict[str, Task]:
    obj = json.loads(data) if isinstance(data, str) else data
    tasks: Dict[str, Task] = {}
    for tid, spec in obj.items():
        args = list(spec.get("args", []))
        dur = cal.TASK_DURATION_S
        if "-t" in args:  # stress -t seconds (+ equal mem phase, see §5.2)
            dur = 2.0 * float(args[args.index("-t") + 1])
        tasks[tid] = Task(
            id=tid,
            inputs=list(spec.get("input", [])),
            outputs=list(spec.get("output", [])),
            image=(spec.get("image") or [Task.image])[0],
            cpu_m=int((spec.get("cpuNum") or [cal.TASK_CPU_M])[0]),
            mem_mi=int((spec.get("memNum") or [cal.TASK_MEM_MI])[0]),
            args=args,
            duration_s=dur,
        )
    return tasks


def make_workflow(name: str, data: str | Dict) -> Workflow:
    return Workflow(name, parse_configmap(data))


def add_virtual_entry_exit(tasks: Dict[str, Task]) -> Dict[str, Task]:
    """Add the paper's virtual entry/exit nodes around a task dict."""
    roots = [tid for tid, t in tasks.items() if not t.inputs]
    leaves = [tid for tid, t in tasks.items() if not t.outputs]
    entry = Task(id="entry", outputs=list(roots), virtual=True, duration_s=0.0)
    exit_ = Task(id="exit", inputs=list(leaves), virtual=True, duration_s=0.0)
    out = {"entry": entry}
    for tid, t in tasks.items():
        t2 = replace(t, inputs=list(t.inputs), outputs=list(t.outputs))
        if tid in roots:
            t2.inputs = ["entry"] + t2.inputs
        if tid in leaves:
            t2.outputs = t2.outputs + ["exit"]
        out[tid] = t2
    out["exit"] = exit_
    return out
