#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one CUDA card.

    python3 scripts/profile_train.py [--arch ARCH] [--layers N] [--remat off|full] [--mesh]

Builds the full-width model (qwen2-0.5b unless ``--arch`` names another
of the port's configs; full depth unless ``--layers`` cuts it) with f32
params and bf16 compute, ``RunConfig(remat=..., ssd_chunk=32)`` (remat
off by default; chip_smoke.py phases 7 and 8 train under "full"), with
the seeded state of ``chip_smoke.init_train_state`` (a vlm's gates at
``CROSS_GATE``) and the batches of ``chip_smoke.synthetic_data`` (8 x
512 positions; frame embeddings for audio, tokens and image embeddings
for vision), warms up with two steps,
then traces three windows with ``torch.profiler``: the forward and
backward (``runtime.train.value_and_grad``), the AdamW update
(``optim.adamw.apply_updates``) and a whole step. For each window it
prints the host time, the device busy time (the union of kernel
intervals), the idle share, the kernel count and the kernels with the
most device time; for the forward and backward also the operators with
the most device time (the stacked blocks' per-layer index backward
shows there as bf16 fills and adds of full-size stacked gradients),
and the device time inside each kernel's backward
(``SSDScanFnBackward``: ``ssd_chunked`` recomputed and its autograd;
``FlashAttentionFnBackward``: K1's backward kernel, or
``ref.attention_bwd`` for f32 and hd 256), a layer and its
share of the window. Every window runs with ``profile_serve.moe_ranges``,
so a MoE's forward and backward window also splits out, under the
gradient, its routing (``moe.route``) and its dispatch + combine products
(the first and last einsum of each ``moe.apply_moe``): the device ms of
the ranges' own kernels (the forward, and under remat its recompute) and
of the backward nodes those ops recorded (matched by sequence number).
Then three unprofiled steps. ``--mesh`` runs the mesh path instead: a
world of one NCCL rank (``chip_smoke.init_world_of_one``), the step of
``build_train_step(cfg, mesh)`` on the (data=1, model=1) mesh, the state
distributed into its shardings and the batches placed with
``shard_batch``, so the windows show what DTensor's dispatch costs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
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


def kernel_backwards(prof, busy_ms: float) -> None:
    """Device time inside each kernel's backward node (inclusive of every
    kernel its tensor ops launch), per call and as a share of ``busy_ms``."""
    for e in prof.key_averages():
        if not any(f"{fn}Backward" in e.key for fn in ("SSDScanFn", "FlashAttentionFn")):
            continue
        if not e.key.startswith("autograd::engine::evaluate_function"):
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        print(json.dumps({"backward": e.key.split(": ")[-1], "calls": e.count,
                          "device_ms": us / 1e3, "device_ms_per_call": us / 1e3 / e.count,
                          "share_of_busy": us / 1e3 / busy_ms}))


def moe_under_grad(prof) -> dict:
    """Device ms of the MoE's routing and of its dispatch + combine products,
    forward (the ranges' kernels, the remat recompute included) and
    backward (the kernels of the autograd nodes recorded by the ops inside
    those ranges, matched by forward thread and sequence number)."""
    from torch.autograd import DeviceType
    from profile_serve import _descendants, _kernel_ms
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    parts = {"route": [], "dispatch_combine": []}
    for e in events:
        if e.name == "moe.route":
            parts["route"].append(e)
        elif e.name == "moe.apply_moe":
            einsums = sorted((c for c in _descendants(e) if c.name == "aten::einsum"),
                             key=lambda c: c.time_range.start)
            parts["dispatch_combine"] += einsums[:1] + einsums[-1:]
    backward = [e for e in events
                if e.name.startswith("autograd::engine::evaluate_function")]
    out = {}
    for name, roots in parts.items():
        seqs = {(d.thread, d.sequence_nr) for r in roots for d in (r, *_descendants(r))
                if d.sequence_nr >= 0}
        out[f"moe_{name}_fwd_ms"] = sum(_kernel_ms(r) for r in roots)
        out[f"moe_{name}_bwd_ms"] = sum(_kernel_ms(e) for e in backward
                                        if (e.fwd_thread, e.sequence_nr) in seqs)
    return out


def main() -> int:
    import chip_smoke
    chip_smoke.use_expandable_segments()
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="qwen2-0.5b",
                        help="one of repro_torch.configs.list_configs()")
    parser.add_argument("--layers", type=int, default=0, help="depth cut (0: full depth)")
    parser.add_argument("--remat", choices=("off", "full"), default="off")
    parser.add_argument("--mesh", action="store_true",
                        help="the mesh path on a (1, 1) mesh over a world of one rank")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (SSD_TRAIN_CHUNK, TRAIN_BATCH, TRAIN_LEN, init_train_state,
                            init_world_of_one, synthetic_data, train_rc)
    from profile_serve import busy_us, moe_ranges, report
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import shard_batch, to_device
    from repro_torch.optim.adamw import OptConfig, apply_updates
    from repro_torch.parallel.sharding import specs_of
    from repro_torch.runtime.train import (TrainRunConfig, build_train_step, distribute,
                                           value_and_grad)

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    remat = {} if args.remat == "off" else dict(remat=True, remat_policy=args.remat)
    rc = train_rc("cuda", ssd_chunk=SSD_TRAIN_CHUNK, **remat)
    trc = TrainRunConfig(opt=OptConfig(lr=3e-4, warmup_steps=2, total_steps=8))
    mesh = init_world_of_one() if args.mesh else None
    step, _, _, st_sh, b_sh, model = build_train_step(cfg, mesh, B=TRAIN_BATCH, S=TRAIN_LEN,
                                                      rc=rc, trc=trc)
    state = init_train_state(model)
    data = synthetic_data(cfg, TRAIN_BATCH, TRAIN_LEN)
    if mesh is None:
        batches = [to_device(next(data), "cuda") for _ in range(6)]
    else:
        state = distribute(state, st_sh)
        batches = [shard_batch(next(data), mesh, specs_of(b_sh)) for _ in range(6)]
    for b in batches[:2]:                     # warm-up at the measured shapes
        state, _ = step(state, b)
    torch.cuda.synchronize()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({smi}); {cfg.name} layers={cfg.n_layers} "
          f"B={TRAIN_BATCH} S={TRAIN_LEN} remat={args.remat} ssd_chunk={SSD_TRAIN_CHUNK} "
          f"mesh={None if mesh is None else tuple(mesh.shape)}")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def window(name, fn):
        with moe_ranges(), profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        report(name, prof, host_ms)
        return prof, out

    prof, (_, grads) = window("forward_backward",
                              lambda: value_and_grad(model.loss, state.params, batches[2]))
    top_ops(prof)
    if cfg.n_experts:
        print(json.dumps(moe_under_grad(prof)))
    from torch.autograd import DeviceType
    kernel_backwards(prof, busy_us([e for e in prof.events()
                                    if e.device_type == DeviceType.CUDA]) / 1e3)
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
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
