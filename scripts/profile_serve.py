#!/usr/bin/env python3
"""Where the time of the port's serving path goes, on one CUDA card.

    python3 scripts/profile_serve.py [--arch qwen2-0.5b|mamba2-2.7b|zamba2-1.2b|gemma-7b]

Builds the full-width model (qwen2-0.5b unless ``--arch`` names another
of the port's configs) at full depth in bf16 with seeded random weights
and the prompts of ``chip_smoke.py`` phase 3 (8 x 512 tokens), warms up
at the measured shapes, then traces one prefill and 8 greedy decode
steps with ``torch.profiler``. For each window it prints the host time, the device
busy time (the union of kernel intervals), the idle share, the kernel
count, and the kernels with the most device time. The Chrome traces go
to ``chiprun_out/profile_serve_<arch>_{prefill,decode}.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def busy_us(events) -> float:
    """Union of the device kernels' [start, end) intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def report(name, prof, host_ms, out_path=None):
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = busy_us(kernels) / 1e3
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({"window": name, "host_ms": host_ms, "device_busy_ms": busy_ms,
                      "idle_share": 1.0 - busy_ms / host_ms, "kernels": len(kernels)}))
    for kname, (us, n) in top:
        print(f"    {us / 1e3:9.3f} ms  {n:5d}x  {kname[:110]}")
    if out_path is not None:
        prof.export_chrome_trace(str(out_path))


DECODE_STEPS = 8


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="qwen2-0.5b",
                        help="one of repro_torch.configs.list_configs()")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import PROMPT_LEN, SEED, SERVE_BATCH, make_prompts
    from repro_torch.configs import get_config
    from repro_torch.models import RunConfig, build
    from repro_torch.runtime.serve import grow_cache

    cfg = get_config(args.arch)
    rc = RunConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device="cuda")
    model = build(cfg, rc)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    B, P, G = SERVE_BATCH, PROMPT_LEN, DECODE_STEPS
    prompts = make_prompts(cfg, B, P, "cuda")

    def run_prefill():
        return model.prefill(params, {"tokens": prompts})

    def run_decode(logits, cache):
        tok = logits[:, -1:].argmax(dim=-1)
        for _ in range(G):
            logits, cache = model.decode(params, cache, {"tokens": tok})
            tok = logits.argmax(dim=-1)
        return tok

    for _ in range(2):                       # warm-up at the measured shapes
        logits, cache = run_prefill()
        run_decode(logits, grow_cache(cache, G))
    torch.cuda.synchronize()

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    print(f"device: {torch.cuda.get_device_name(0)}; {args.arch} B={B} prompt={P} "
          f"decode steps={G}")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = run_prefill()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    report("prefill", prof, host_ms, out_dir / f"profile_serve_{args.arch}_prefill.json")
    cache = grow_cache(cache, G)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_decode(logits, cache)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    report("decode", prof, host_ms, out_dir / f"profile_serve_{args.arch}_decode.json")

    # the same windows without the profiler, for its overhead
    for _ in range(3):
        t0 = time.perf_counter()
        logits, cache = run_prefill()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run_decode(logits, grow_cache(cache, G))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(json.dumps({"unprofiled_prefill_ms": (t1 - t0) * 1e3,
                          "unprofiled_decode_ms_per_step": (t2 - t1) * 1e3 / G}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
