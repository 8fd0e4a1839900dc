"""Cells cut to a tiny size for the benchmark's CPU tests: run on the CPU
with the kernels' plain versions, the harness's look for a card skipped.

Each configuration's file gives its own cut under ``tiny``: ``arch`` (the
widths and depth, every kind of layer kept), ``reference`` (the
reference's blocking at that size), and optionally ``train`` / ``serve``
(run settings such as the SSD chunk)."""
from __future__ import annotations

import copy
import sys
import time

from podbench import harness

if str(harness.SRC) not in sys.path:
    sys.path.insert(0, str(harness.SRC))


def tiny_cell(name: str) -> harness.Cell:
    """Cell ``name`` of BENCHMARK.json at its configuration's tiny size, in
    float32: its limits, driver, optimizer and readers as committed; 2 x 32
    tokens."""
    cell = harness.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cut = cell.config["tiny"]
    cell.config["arch"].update(cut["arch"])
    for section in ("train", "serve"):
        cell.config[section].update(cut.get(section, {}))
        cell.config[section]["compute_dtype"] = "float32"
    cell.config["reference"] = dict(cut["reference"])
    cell.mix = dict(cell.mix, batch=2, seq_len=32)
    return cell


def run_tiny(cell, seed: int = 2**31 + 7, trace: bool = False, controls=()) -> dict:
    return harness.driver(cell).run(cell, seed, 0.2, trace, "cpu", time.perf_counter(),
                                    controls=controls)
