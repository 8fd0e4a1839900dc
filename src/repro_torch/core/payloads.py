"""Task payloads: the paper's stress emulator + real ML payloads.

A payload is ``fn(volume, task) -> None``; it reads upstream outputs
from the namespace SharedVolume and writes its own (the PV-mediated
data dependency of §3.2). Virtual-clock benchmarks use stress_payload
(markers only); the ML workflow examples run real torch work on the
card. A real payload returns only once its device work has finished,
since ``payload_mode="real"`` takes a pod's run time from the wall
clock around the payload.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def stress_payload(volume, task):
    """task-emulator analogue: consume inputs, emit a completion marker."""
    if volume is None:
        return
    for dep in task.inputs:
        _ = volume.get(f"{dep}/out")        # data dependency read
    volume.put(f"{task.id}/out", {"task": task.id, "ok": True})


def matmul_payload(n: int = 256, iters: int = 4, device: str = "cuda") -> Callable:
    """A real torch payload on ``device`` (used in payload_mode='real').

    ``iters`` steps of ``tanh(h @ h) * 0.5 + h * 0.5`` in f32 from the
    same ``default_rng(0)`` draw as every run, drawn once here on the
    host and copied to ``device`` by each run. A run on a CUDA device
    synchronises before it returns, so the pod's wall time is finished
    work.
    """
    import torch

    x_host = torch.from_numpy(
        np.random.default_rng(0).standard_normal((n, n)).astype(np.float32))

    def run(volume, task):
        h = x_host.to(device)
        for _ in range(iters):
            h = torch.tanh(h @ h) * 0.5 + h * 0.5
        if h.device.type == "cuda":
            torch.cuda.synchronize(h.device)
        if volume is not None:
            for dep in task.inputs:
                _ = volume.get(f"{dep}/out")
            volume.put(f"{task.id}/out", h[0, :4].cpu().numpy())

    return run


def fn_payload(fn: Callable[[], Optional[dict]]) -> Callable:
    """Wrap an arbitrary thunk (e.g. a jitted train step) as a payload."""

    def run(volume, task):
        result = fn()
        if volume is not None:
            for dep in task.inputs:
                _ = volume.get(f"{dep}/out")
            volume.put(f"{task.id}/out", result if result is not None else True)

    return run
