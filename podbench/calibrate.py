"""The readings that a cell's limits of ``correct`` are set from, at the
cell's own size, several seeds in one process (the benchmark's runs do not
run this).

    python3 -m podbench.calibrate --workload <cell> --seconds <s> --seeds 11 12 13 ... \\
        [--control-seeds 11 12 13] [--out chiprun_out/<file>.jsonl]

Each seed is one run of the cell's driver, as ``podbench.run`` makes it
(set-up, a window of ``--seconds``, the check on the window's sample),
and gives one JSON line: ``numbers``, every number of ``compare`` for the
program against the reference, and on the control seeds ``controls``, the
same numbers with each of the driver's ``CONTROLS`` in the program's
place: the reference with fp8 products (``reference.common.fp8``, one
precision step below the configuration's bf16), and in training the
reference on the first half of each batch's rows (the fault of half the
batch left out, the mean taken over the rest).

A step that returns its state unchanged reads 1 on ``grad_gap`` and
``update_gap`` by their definition and needs no run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings for the limits of a cell's check.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from podbench import harness, session
    sys.path.insert(0, str(harness.SRC))
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    driver = harness.driver(cell)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t = time.perf_counter()
            controls = driver.CONTROLS if seed in args.control_seeds else ()
            got = driver.run(cell, seed, args.seconds, False, "cuda", t, controls=controls)
            line = json.dumps({"cell": cell.name, "seed": seed, "correct": got["correct"],
                               "numbers": got["numbers"], "controls": got["controls"],
                               "s": time.perf_counter() - t})
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
            session.release("cuda")
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
