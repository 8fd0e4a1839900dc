"""Cells cut to a tiny size for the benchmark's CPU tests: run on the CPU
with the kernels' plain versions, the harness's look for a card skipped."""
from __future__ import annotations

import copy
import sys
import time

from podbench import harness

if str(harness.SRC) not in sys.path:
    sys.path.insert(0, str(harness.SRC))

# every width cut, every kind of layer kept: GQA, QKV bias
TINY = {
    "qwen2-1.5b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                       d_ff=128, vocab_size=500),
}


def tiny_cell(name: str) -> harness.Cell:
    """Cell ``name`` of BENCHMARK.json at a tiny size, in float32: its
    limits, driver, optimizer and readers as committed; 2 x 32 tokens."""
    cell = harness.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["arch"].update(TINY[cell.config["name"]])
    for section in ("train", "serve"):
        cell.config[section]["compute_dtype"] = "float32"
    cell.config["reference"] = {"q_block": 16}
    cell.mix = dict(cell.mix, batch=2, seq_len=32)
    return cell


def run_tiny(cell, seed: int = 2**31 + 7, trace: bool = False, controls=()) -> dict:
    return harness.driver(cell).run(cell, seed, 0.2, trace, "cpu", time.perf_counter(),
                                    controls=controls)

