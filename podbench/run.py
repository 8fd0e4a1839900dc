"""Run one cell of the benchmark once, on the CUDA cards of this machine.

    python3 -m podbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One process a run: it loads, warms up,
measures for ``--seconds`` (``--trace 1``: profiles a short window
instead), checks what the window produced against the reference, prints
each number compared beside its limit as its last lines on standard
error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last.

It exits non-zero and prints no result when there is no CUDA card (or
fewer than the cell asks for), when the program cannot be imported, and
when ``jax``, ``jaxlib``, ``flax``, the JAX package (``repro``) or its
control-plane benchmark (``benchmarks``) is loaded once the window has
closed (top-level module names compared whole).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()   # set-up is counted from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(torch, chips: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak}


def main(argv=None) -> int:
    args = parse(argv)
    # the allocator maps memory in expandable segments, so a full card's
    # free memory is not left in pieces too small for a large leaf
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    from podbench import harness, session
    sys.path.insert(0, str(harness.SRC))
    import torch
    session.mark("imports")
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"podbench: cell {cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {n}", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    session.mark("cuda")
    outcome = harness.driver(cell).run(cell, args.seed, args.seconds, bool(args.trace),
                                       "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"podbench: the run loaded {found}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    line = harness.result_line(cell, outcome, bool(args.trace),
                               device_info(torch, cell.chips, outcome["memory_peak_bytes"]))
    print(f"podbench: set-up phases {session.phases(T0)}", file=sys.stderr)
    for name, c in outcome["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
