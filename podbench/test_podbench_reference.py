"""The reference against the port on the CPU at a tiny size, in float32,
and the yardstick's FLOP formulas against FlopCounterMode over the
reference."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from podbench import weights, yardstick
from podbench.drivers import prefill
from podbench.reference import common
from podbench.reference import model as ref_model
from podbench.tiny import run_tiny, tiny_cell

# float32 on both sides: what is left is the order of the sums
AGREE = 1e-4


@pytest.mark.parametrize("cell", ["qwen2-1.5b-train", "qwen2-1.5b-prefill"])
def test_reference_agrees_with_the_port(cell):
    out = run_tiny(tiny_cell(cell))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    for name, check in out["checks"].items():
        assert check["value"] <= AGREE, (name, check)


def test_forward_flops_match_the_counter():
    cell = tiny_cell("qwen2-1.5b-prefill")
    arch, S = cell.arch, cell.mix["seq_len"]
    _, meta = prefill.build(cell, "cpu")
    params = weights.make(meta, cell.config, 5, "cpu")
    tokens = torch.randint(0, arch["vocab_size"], (2, S))
    run = {"q_block": S}                           # one query block: every key scored
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            h = ref_model.hidden(params, arch, tokens, common.exact, run)
            common.logits(params, h, arch, common.exact)
    expect = yardstick.forward_flops(arch, 2, S, head_positions=S, causal=False)
    assert counter.get_total_flops() == expect


def test_causal_counts_are_the_kernels():
    """The model FLOPs count the pairs the causal mask keeps, as K1 does."""
    assert yardstick.attention_flops(1, 4, 4, 1, 2, causal=True) == 4 * 2 * 10
    assert yardstick.attention_flops(1, 2, 4, 1, 2, causal=True, q_offset=2) == 4 * 2 * 7


def test_a_traced_run_reads_ranges_apart_from_its_window():
    """The traced train run profiles its steps bare, then once more inside
    the readers' synchronised ranges: each range lies in the ranged run,
    outside the window that the busy time and the idle share are read from."""
    from podbench import tracing
    out = run_tiny(tiny_cell("qwen2-1.5b-train"), trace=True)
    view = out["view"]
    assert out["correct"] and out["attempted"] == 2 * view.steps
    lo, hi = view.window
    for label in ("podbench.value_and_grad", "podbench.apply_updates"):
        assert len(view.ranges[label]) == view.steps
        assert all(s >= hi for s, _ in view.ranges[label])
    assert all(e.name != tracing.RANGED for e in view.cpu)
