#!/usr/bin/env python3
"""Loss trajectories of a few train steps at several peak learning rates,
with the kernels and with their plain versions, on one CUDA card.

    python3 scripts/probe_train_lr.py --arch mamba2-2.7b --layers 16 --steps 4 \\
        --lr 3e-4 1e-4 [--plain]

Each run is ``chip_smoke.train`` (f32 params, bf16 compute,
``RunConfig(remat=True, remat_policy="full", ssd_chunk=32)``, the seeded
state of ``chip_smoke.init_train_state`` and ``chip_smoke.synthetic_data``
batches of 8 x 512 positions with the arch's frontend inputs, 2 warmup
steps then the cosine) from the same seed; with ``--plain`` each learning rate is
run a second time under ``chip_smoke.plain_kernels()``, so a loss that
jumps in both runs is the optimizer's doing at that learning rate, not a
kernel's. Prints one JSON line a run: the losses, grad norms, median
step ms and peak memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke as cs
    cs.use_expandable_segments()
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="mamba2-2.7b",
                        help="one of repro_torch.configs.list_configs()")
    parser.add_argument("--layers", type=int, default=0, help="depth cut (0: full depth)")
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--lr", type=float, nargs="+", default=[3e-4, 1e-4])
    parser.add_argument("--plain", action="store_true",
                        help="also run each learning rate with the plain versions")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_train_lr: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    rc = cs.train_rc("cuda", remat=True, remat_policy="full", ssd_chunk=cs.SSD_TRAIN_CHUNK)
    print(f"device: {torch.cuda.get_device_name(0)}; {cfg.name} layers={cfg.n_layers}")
    for lr in args.lr:
        for plain in (False, True) if args.plain else (False,):
            with cs.plain_kernels() if plain else cs.contextlib.nullcontext():
                res = cs.train(cfg, device="cuda", batch=cs.TRAIN_BATCH, seq_len=cs.TRAIN_LEN,
                               steps=args.steps, rc=rc, lr=lr)
            print(json.dumps({"lr": lr, "plain": plain,
                              "losses": [m["loss"] for m in res["metrics"]],
                              "grad_norms": [m["grad_norm"] for m in res["metrics"]],
                              "median_step_ms": res["median_step_ms"],
                              "max_memory_allocated": res["max_memory_allocated"],
                              "launches_per_step": res["launches_per_step"][0]}), flush=True)
            del res
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
