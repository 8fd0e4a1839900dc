"""Twins of the JAX package's ML workflow examples, run by the port's own
KubeAdaptor engine (``repro_torch.core``) with torch payloads.

  python -m repro_torch.examples.serve_batch      # prefill pod -> decode pod
  python -m repro_torch.examples.workflow_train   # data_prep -> phases -> eval

Each module's ``run(...)`` returns its tokens or losses and the
workflow's record; the tests and ``chip_smoke.py`` call it.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.payloads import fn_payload
from repro_torch.kernels import ops


def sync(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PodRuns:
    """Every run of a workflow's pod thunks: task, wall seconds, K1 launches.

    ``payload(task_id, thunk)`` wraps ``thunk`` as a task payload whose
    run ends in a synchronise of ``device``, so the wall time that
    ``payload_mode="real"`` takes for the pod is finished work; the
    launches are those ``ops.attention`` counts during the run (only a
    CUDA tensor counts).
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.runs: List[Dict] = []

    def payload(self, task_id: str, thunk: Callable[[], Optional[dict]]) -> Callable:
        def body():
            before = ops.attention.launches
            t0 = time.perf_counter()
            out = thunk()
            sync(self.device)
            self.runs.append({"task": task_id, "seconds": time.perf_counter() - t0,
                              "k1_launches": ops.attention.launches - before})
            return out
        return fn_payload(body)

    def by_task(self, key: str) -> Dict[str, List]:
        """{task: [value of each run, in run order]} for ``key``."""
        out: Dict[str, List] = {}
        for r in self.runs:
            out.setdefault(r["task"], []).append(r[key])
        return out
