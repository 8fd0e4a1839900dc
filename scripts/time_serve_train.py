#!/usr/bin/env python3
"""Time the serving and training windows of ``chip_smoke.py`` for one tree.

    python3 scripts/time_serve_train.py LABEL

Runs, on one CUDA card, ``chip_smoke.serve`` three times on qwen2-0.5b
(phase 3's request: 8 x 512 tokens, 64 greedy decode steps), then
``chip_smoke.train`` for 8 steps without a mesh (phase 5's run) and for 4
steps at grad_accum 2 on the (1, 1) mesh of one NCCL rank (phase 10
(h)'s), and prints one ``PAIR {...}`` JSON line: the prefill ms and decode
ms a step of each request, each run's median step ms and losses. To set
two commits side by side, unpack each (``git archive``) into a directory
that ``.gitignore`` lists, copy this script into each, and run them in
one call in the order parent, change, change, parent: the windows are
host-bound, and a card machine's host varies from call to call.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
for p in (ROOT, ROOT.parent):               # the script in scripts/ or at a tree's root
    if (p / "chip_smoke.py").exists():
        sys.path[:0] = [str(p / "src"), str(p)]
        break

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402


def main() -> None:
    import torch.distributed as dist
    cs.use_expandable_segments()
    cfg = get_config("qwen2-0.5b")
    sv = [cs.serve(cfg, device="cuda", batch=cs.SERVE_BATCH, prompt_len=cs.PROMPT_LEN,
                   decode_steps=cs.DECODE_STEPS) for _ in range(3)]
    tr = cs.train(cfg, device="cuda", batch=8, seq_len=512, steps=8)
    mesh = cs.init_world_of_one()
    mtr = cs.train(cfg, device="cuda", batch=8, seq_len=512, steps=4, mesh=mesh, grad_accum=2)
    print("PAIR " + json.dumps({
        "tree": sys.argv[1] if len(sys.argv) > 1 else str(ROOT),
        "prefill_ms": [round(s["prefill_ms"], 3) for s in sv],
        "decode_ms": [round(s["decode_ms_per_step"], 3) for s in sv],
        "train_median_ms": round(tr["median_step_ms"], 3),
        "train_losses": [m["loss"] for m in tr["metrics"]],
        "mesh_accum2_median_ms": round(mtr["median_step_ms"], 3),
        "mesh_losses": [m["loss"] for m in mtr["metrics"]]}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
