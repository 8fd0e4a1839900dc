"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files; a cell added as files alone is found."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from podbench import harness, run, traffic

BENCH = json.loads(harness.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["podbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[part]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in E2E and m["workloads"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or "roofline." in m["name"]:
            assert m["unit"] == "%"


def test_a_metric_with_no_reading_is_named(capsys):
    """A per-layer metric whose reader finds nothing is left out of the
    line and named on standard error, not dropped unseen."""
    cell = harness.load_cell("qwen2-1.5b-prefill")
    cell.readers = {m["name"]: type("R", (), {"read": staticmethod(
        lambda view, n=m["name"]: None if n == "k1_roofline.prefill" else 1.0)})
        for m in cell.per_layer}
    view = type("V", (), {"busy_s": 1.0, "window_s": 1.0, "top_ops": lambda s: [],
                          "idle_gaps": lambda s: []})()
    line = harness.result_line(cell, {"view": view, "correct": True, "attempted": 1,
                                      "failed": 0, "checks": {}}, True, {})
    assert "k1_roofline.prefill" not in line["metrics"] and "mfu.prefill" in line["metrics"]
    assert "no reading of k1_roofline.prefill" in capsys.readouterr().err


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1 and NAME.match(entry["traffic"])
    assert c.mix["loop"] in traffic.LOOPS
    assert callable(harness.driver(c).run)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves a metric {cell} does not report"
        assert callable(c.readers[m["name"]].read)
    assert set(c.workload["limits"]) and all(v > 0 for v in c.workload["limits"].values())


def test_configs_name_their_files_and_cuts():
    for conf in BENCH["configs"]:
        data = json.loads((harness.ROOT / conf["file"]).read_text())
        assert conf["file"].startswith("podbench/configs/")
        assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"]
        assert conf["source"].startswith("https://")


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new cell, mix and configuration as new files and entries, no edit."""
    shutil.copytree(harness.PKG, tmp_path / "podbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "extra-cell", "config": "qwen2-1.5b",
                               "traffic": "docs-1x512", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "qwen2-1.5b-prefill" in m.get("workloads", []):
            m["workloads"].append("extra-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "podbench/traffic/docs-1x512.json").write_text(
        json.dumps({"loop": "closed", "batch": 1, "seq_len": 512, "tokens": "uniform"}))
    shutil.copy(harness.PKG / "workloads/qwen2-1.5b-prefill.json",
                tmp_path / "podbench/workloads/extra-cell.json")
    code = ("from podbench import harness; c = harness.load_cell('extra-cell'); "
            "print(c.mix['seq_len'], c.workload['driver'], sorted(c.readers))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.startswith("512 prefill ") and "'mfu.prefill'" in out


def test_run_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "qwen2-1.5b-train", "--seed", "3", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
