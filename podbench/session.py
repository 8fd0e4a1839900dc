"""What the drivers share: the program's RunConfig from the configuration
file, device synchronisation and peak memory, the marks of set-up's
phases, and the traced window."""
from __future__ import annotations

import gc
import time

from podbench import harness, tracing

MARKS = []          # (phase, time.perf_counter() at its end), in order


def mark(phase: str) -> None:
    """Set-up's phase ``phase`` ends now (``run.py`` prints the phases)."""
    MARKS.append((phase, time.perf_counter()))


def phases(t0: float) -> str:
    """The seconds of each marked phase, the first counted from ``t0``."""
    ends = [t for _, t in MARKS]
    return ", ".join(f"{p} {t - s:.3f} s" for (p, t), s in zip(MARKS, [t0] + ends))


def run_config(section: dict, device: str):
    """The program's ``RunConfig`` from a configuration's ``train`` or
    ``serve`` section: every field the section names (a dtype by its
    name in ``torch``), the others at their defaults. A key that is no
    field, or a field no JSON value can give (the device, the sharding
    hooks), raises."""
    import dataclasses

    import torch
    from repro_torch.models import RunConfig
    fields = {f.name for f in dataclasses.fields(RunConfig)} - {"device", "constrain",
                                                                 "fsdp_gather"}
    unknown = set(section) - fields
    if unknown:
        raise KeyError(f"no RunConfig field for {sorted(unknown)}; the fields are "
                       f"{sorted(fields)}")
    kw = {k: getattr(torch, v) if k.endswith("_dtype") else v for k, v in section.items()}
    return RunConfig(device=device, **kw)


def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device: str) -> int:
    import torch
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def release(device: str) -> None:
    """Let the program's freed memory go before the reference runs."""
    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def traced(cell, device: str, work) -> tracing.View:
    """``work(n)`` runs ``n`` steps (or request batches); ``n`` is the
    cell's ``trace_steps``. Under ``torch.profiler`` it runs them twice:
    bare, as the traced window that the device's busy and idle time, the
    model FLOPs and the kernels are read from; then, where the cell's
    readers name ranges around program functions, once more inside those
    ranges (``tracing.RANGED``), which synchronise and so idle the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    n = cell.workload["trace_steps"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    patches = harness.range_patches(cell)
    shapes = any(getattr(r, "SHAPES", False) for r in cell.readers.values())
    with profile(activities=acts, record_shapes=shapes) as prof:
        sync(device)
        with torch.profiler.record_function(tracing.WINDOW):
            work(n)
            sync(device)
        if patches:
            with tracing.ranges(patches, lambda: sync(device)):
                with torch.profiler.record_function(tracing.RANGED):
                    work(n)
                    sync(device)
    return tracing.View(prof, n, cell)
