#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one CUDA card.

    python3 scripts/profile_train.py

Builds full-width, full-depth qwen2-0.5b (f32 params, bf16 compute)
with the seeded state and the ``SyntheticLM`` batches of
``chip_smoke.py`` phase 5 (8 x 512 tokens), warms up with two steps,
then traces three windows with ``torch.profiler``: the forward and
backward (``runtime.train.value_and_grad``), the AdamW update
(``optim.adamw.apply_updates``) and a whole step. For each window it
prints the host time, the device busy time (the union of kernel
intervals), the idle share, the kernel count and the kernels with the
most device time; for the forward and backward also the operators with
the most device time (the stacked blocks' per-layer index backward
shows there as bf16 fills and adds of full-size stacked gradients).
Then three unprofiled steps.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))


def top_ops(prof, n: int = 15) -> None:
    """The operators with the most device time (self), from key_averages."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us:
            rows.append((us, e.count, e.key))
    for us, count, key in sorted(rows, reverse=True)[:n]:
        print(f"    op {us / 1e3:9.3f} ms  {count:5d}x  {key[:100]}")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import ARCH, SEED, TRAIN_BATCH, TRAIN_LEN
    from profile_serve import report
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.models import RunConfig
    from repro_torch.optim.adamw import OptConfig, apply_updates
    from repro_torch.runtime.train import (TrainRunConfig, build_train_step,
                                           init_sharded_state, value_and_grad)

    cfg = get_config(ARCH)
    rc = RunConfig(param_dtype=torch.float32, compute_dtype=torch.bfloat16, device="cuda")
    trc = TrainRunConfig(opt=OptConfig(lr=3e-4, warmup_steps=2, total_steps=8))
    step, *_, model = build_train_step(cfg, None, B=TRAIN_BATCH, S=TRAIN_LEN, rc=rc, trc=trc)
    state = init_sharded_state(model, None, None, SEED)
    data = SyntheticLM(DataConfig(TRAIN_BATCH, TRAIN_LEN, cfg.vocab_size, seed=SEED))
    batches = [to_device(next(data), "cuda") for _ in range(6)]
    for b in batches[:2]:                     # warm-up at the measured shapes
        state, _ = step(state, b)
    torch.cuda.synchronize()

    print(f"device: {torch.cuda.get_device_name(0)}; {cfg.name} layers={cfg.n_layers} "
          f"B={TRAIN_BATCH} S={TRAIN_LEN}")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def window(name, fn):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        report(name, prof, host_ms)
        return prof, out

    prof, (_, grads) = window("forward_backward",
                              lambda: value_and_grad(model.loss, state.params, batches[2]))
    top_ops(prof)
    with torch.no_grad():
        window("adamw", lambda: apply_updates(state, grads, trc.opt))
    del grads
    window("step", lambda: step(state, batches[3]))

    for b in batches[4:] + batches[:1]:       # unprofiled, for the profiler's overhead
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize()
        print(json.dumps({"unprofiled_step_ms": (time.perf_counter() - t0) * 1e3,
                          "loss": float(met["loss"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
