"""The readers of the program's own spans (``podbench/spans.py``), on the
CPU at a tiny size: the traced train window holds the spans, each step's
count of them; ``host_ops.train`` reads one count on two seeds; the four
device-ms readers give no reading where there are no kernels; and every
new metric meets the benchmark's contract. On made-up events, as the card
gives them: a launch that waited on a full command buffer still counts,
too many kernels without a launch give no reading, and an operator that a
profiler event straddles is still counted once."""
from __future__ import annotations

import collections
from types import SimpleNamespace

import pytest

from podbench import session, spans, test_podbench_contract as contract, traffic, weights
from podbench.drivers import train
from podbench.tiny import run_tiny, tiny_cell

TRAIN = "qwen2-1.5b-train"
DEVICE_MS = ("fwd_bwd_span_ms.train", "adamw_span_ms.train", "head_ce_ms.train",
             "recompute_ms.train")
NEW = DEVICE_MS + ("host_ops.train",)


@pytest.fixture(scope="module")
def traced():
    """A tiny train cell's traced run: (cell, the traced window's view)."""
    cell = tiny_cell(TRAIN)
    return cell, run_tiny(cell, trace=True)["view"]


def test_the_traced_window_holds_the_spans(traced):
    cell, view = traced
    n, L = view.steps, cell.arch["n_layers"]
    found = collections.Counter(e.name[len(spans.PREFIX):] for e in view.cpu
                                if e.name.startswith(spans.PREFIX))
    assert found == {"train_step": n, "loss_and_grad": n, "adamw": n, "head": n, "ce": n,
                     "head.bwd": n, "block": n * L, "block.recompute": n * L}


def _host_ops(seed: int) -> float:
    """``host_ops.train`` of one traced step from the seed's weights and batch
    (the window alone: no ranged run, no check)."""
    cell = tiny_cell(TRAIN)
    cell.readers = {"host_ops.train": cell.readers["host_ops.train"]}
    cell.workload = dict(cell.workload, trace_steps=1)
    step, meta = train.build(cell, "cpu")
    from repro_torch.optim.adamw import init_state
    state = [init_state(weights.make(meta.params, cell.config, seed, "cpu"))]
    feed = traffic.Feed(cell.mix, cell.arch["vocab_size"], seed, "cpu")

    def work(n):
        for i in range(n):
            state[0], _ = step(state[0], feed.batch(i))
    return cell.readers["host_ops.train"].read(session.traced(cell, "cpu", work))


def test_host_ops_reads_one_count_on_two_seeds(traced):
    cell, view = traced
    first = cell.readers["host_ops.train"].read(view)
    assert first > 0 and first == int(first)
    assert _host_ops(12345) == first


@pytest.mark.parametrize("name", DEVICE_MS)
def test_a_device_ms_reader_gives_no_reading_without_kernels(traced, name):
    cell, view = traced
    assert not view.kernels and cell.readers[name].read(view) is None


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_meets_the_contract(name):
    entry = next(m for m in contract.BENCH["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [TRAIN] and entry["moves"] == "train_tokens_per_s"
    assert entry["source"] == "program_span"
    contract.test_keys_names_and_units()


def _event(name, start, end, id=0, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           id=id, thread=thread, cpu_children=[], cpu_parent=None)


def _view(cpu, device_us):
    return SimpleNamespace(cpu=cpu, device_us=device_us, steps=1,
                           op_events=lambda name: [e for e in cpu if e.name == name])


def test_a_launch_that_waited_on_a_full_command_buffer_counts():
    waited = _event("cudaLaunchKernel", 1, 4, id=7)
    waited.cpu_children = [_event("Command Buffer Full", 2, 3)]
    cpu = [_event("repro_torch.head", 0, 5), waited, _event("cudaLaunchKernel", 6, 7, id=8)]
    assert spans.device_ms(_view(cpu, {7: 300.0, 8: 2.0}), "head") == 0.3
    # a kernel with no launch record at all, over 1% of the window's time: no reading
    assert spans.device_ms(_view(cpu, {7: 300.0, 8: 2.0, 9: 4.0}), "head") is None


def test_an_operator_a_profiler_event_straddles_counts_once():
    cpu = [_event("repro_torch.train_step", 0, 100), _event("aten::slice", 10, 20),
           _event("Buffer Flush", 15, 30), _event("aten::as_strided", 16, 18),
           _event("aten::mm", 40, 50), _event("aten::add", 41, 45, thread=2)]
    assert spans.host_ops(_view(cpu, {}), "train_step") == 3
