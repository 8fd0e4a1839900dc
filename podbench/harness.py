"""Finds a cell's files by the names in ``BENCHMARK.json``, runs its driver
and assembles the result line.

- ``podbench/workloads/<cell>.json``: the driver kind, the optimizer, the
  sample the check takes, the limits of ``correct``, the traced window;
- ``podbench/configs/<file>``: the configuration as run (``arch``: the
  program's ``ArchConfig`` fields; ``train`` / ``serve``: dtypes, remat,
  chunk; ``reference``: the reference's blocking);
- ``podbench/traffic/<traffic>.json``: the mix (``traffic.py``);
- ``podbench/drivers/<kind>.py``: ``run(cell, seed, seconds, trace, device)``;
- ``podbench/layer_metrics/<metric>.py``: ``read(view)`` of one per-layer
  metric, with the ``RANGES`` it needs around the program's functions.

A later cell, configuration, mix, driver or metric is a new file and a
new entry in ``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

from podbench import traffic

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
SRC = ROOT / "src"
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict              # the configuration file
    workload: dict            # the cell's file
    mix: dict                 # the traffic file
    end_to_end: list          # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list           # and its per-layer metrics
    readers: dict = field(default_factory=dict)

    @property
    def arch(self) -> dict:
        return self.config["arch"]


def load_reader(name: str):
    """``podbench/layer_metrics/<name>.py`` as a module (names hold dots)."""
    path = PKG / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"podbench.layer_metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str) -> Cell:
    bench = json.loads(BENCHMARK.read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    workload = json.loads((PKG / "workloads" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    cell = Cell(name, entry["chips"], config, workload, traffic.load(entry["traffic"]),
                e2e, per_layer)
    cell.readers = {m["name"]: load_reader(m["name"]) for m in per_layer}
    return cell


def range_patches(cell: Cell) -> dict:
    """The ranges the cell's readers need: label -> (module, attribute)."""
    out = {}
    for mod in cell.readers.values():
        out.update(getattr(mod, "RANGES", {}))
    return out


def driver(cell: Cell):
    return importlib.import_module(f"podbench.drivers.{cell.workload['driver']}")


def result_line(cell: Cell, outcome: dict, trace: bool, device_info: dict) -> dict:
    """The result's JSON object: ``checks`` (each number compared beside its
    limit) comes last. A per-layer metric whose reader finds nothing is
    left out of it and named on standard error."""
    if trace:
        view = outcome["view"]
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(view)
            if value is None:
                print(f"podbench: no reading of {m['name']} in cell {cell.name}: its reader "
                      "found nothing to read in the trace", file=sys.stderr)
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = {**device_info, "busy_s": view.busy_s, "window_s": view.window_s}
        extra = {"breakdown": {"device_ops": view.top_ops(), "idle_gaps": view.idle_gaps()}}
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in outcome["e2e"]:
                raise KeyError(f"driver {cell.workload['driver']!r} gives no {m['name']}")
            metrics[m["name"]] = {"value": outcome["e2e"][m["name"]], "unit": m["unit"]}
        device = device_info
        extra = {}
    return {"correct": outcome["correct"], "attempted": outcome["attempted"],
            "failed": outcome["failed"], "metrics": metrics, "device": device,
            **extra, "checks": outcome["checks"]}
