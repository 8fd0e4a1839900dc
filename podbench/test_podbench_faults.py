"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a one-chip cell can have, also where the fault comes
only after the steps that set-up runs, and for the controls in the
program's place: the reference in fp8, and half the batch. The runs skip the harness's look
for a card and go through the rest of a run on the CPU at a tiny size, in
float32, where the sound run reads within 1e-4 of the reference
(``test_podbench_reference.py``); every number is held to the cell's own
limits."""
from __future__ import annotations

import pytest
import torch

from podbench import compare, harness
from podbench.drivers import train
from podbench.tiny import run_tiny, tiny_cell

TRAIN, PREFILL = "qwen2-1.5b-train", "qwen2-1.5b-prefill"


def _broken_train(monkeypatch, fault: str):
    from repro_torch.runtime import train as rt
    build = rt.build_train_step

    def broken(*args, **kw):
        step, *rest = build(*args, **kw)
        calls = []

        def bad(state, batch):
            calls.append(1)
            kind = fault
            if fault.startswith("late_"):                # sound through set-up's steps
                if len(calls) <= train.CHECK_STEPS:
                    return step(state, batch)
                kind = fault[len("late_"):]
            if kind == "half":
                half = batch["tokens"].shape[0] // 2
                return step(state, {k: v[:half] for k, v in batch.items()})
            new, met = step(state, batch)
            if kind == "unchanged":
                return state, met
            moved = dict(new.params)                               # "answer": moved double
            moved["embed"] = 2 * new.params["embed"] - state.params["embed"]
            return new._replace(params=moved), met
        return (bad, *rest)
    monkeypatch.setattr(rt, "build_train_step", broken)


def _broken_prefill(monkeypatch, fault: str):
    from repro_torch.runtime import serve as rs
    build = rs.build_prefill_step

    def broken(*args, **kw):
        step, *rest = build(*args, **kw)

        def bad(params, batch):
            if fault == "half":
                half = batch["tokens"].shape[0] // 2
                logits, cache = step(params, {"tokens": batch["tokens"][:half]})
                twice = lambda t: torch.cat([t, t], dim=1)        # noqa: E731
                out = {k: twice(v) if torch.is_tensor(v) else v for k, v in cache.items()}
                if "ssm" in cache:
                    out["ssm"] = type(cache["ssm"])(*(twice(t) for t in cache["ssm"]))
                return torch.cat([logits, logits]), out
            logits, cache = step(params, batch)
            if fault == "unchanged":                               # the cache never written
                zero = lambda t: torch.zeros_like(t)              # noqa: E731
                out = {k: zero(v) if torch.is_tensor(v) else v for k, v in cache.items()}
                if "ssm" in cache:
                    out["ssm"] = type(cache["ssm"])(*(zero(t) for t in cache["ssm"]))
                return logits, out
            logits = logits.clone()                                # "token"
            logits[..., 7] += 100.0
            return logits, cache
        return (bad, *rest)
    monkeypatch.setattr(rs, "build_prefill_step", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "double", "late_unchanged",
                                   "late_half"])
def test_train_fault_fails(monkeypatch, fault):
    _broken_train(monkeypatch, fault)
    out = run_tiny(tiny_cell(TRAIN))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "token"])
def test_prefill_fault_fails(monkeypatch, fault):
    _broken_prefill(monkeypatch, fault)
    out = run_tiny(tiny_cell(PREFILL))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", [TRAIN, PREFILL])
def test_controls_fail(cell):
    """Each control of the cell's driver, read by the run itself as
    ``calibrate`` reads it, fails the cell's limits."""
    c = tiny_cell(cell)
    controls = harness.driver(c).CONTROLS
    out = run_tiny(c, controls=controls)
    assert out["correct"] and set(out["controls"]) == set(controls)
    for name, numbers in out["controls"].items():
        ok, checks = compare.judge(numbers, c.workload["limits"])
        assert not ok, (name, checks)
