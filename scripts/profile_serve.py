#!/usr/bin/env python3
"""Where the time of the port's serving path goes, on one CUDA card.

    python3 scripts/profile_serve.py [--arch ARCH]

ARCH is one of the served configs of ``chip_smoke.py`` phase 3
(qwen2-0.5b unless given): qwen2-0.5b, qwen2-1.5b, mamba2-2.7b,
zamba2-1.2b, gemma-7b, qwen2-moe-a2.7b, musicgen-medium,
llama-3.2-vision-11b, deepseek-67b or llama4-scout-17b-a16e. Builds the
full-width model at phase 3's depth (full depth, but the last two at
``chip_smoke.SERVE_LAYERS``) in bf16
with seeded random weights (a vlm's cross-block gates set to
``chip_smoke.CROSS_GATE``) and the requests of phase 3 (8 x 512
positions: ``chip_smoke.make_request``, so tokens, frame embeddings for
audio, tokens and image embeddings for vision), warms up at the measured
shapes, then traces one prefill and 8 greedy decode steps with
``torch.profiler``. For each window it prints the host time, the device
busy time (the union of kernel intervals), the idle share, the kernel
count, the kernels with the most device time, and the device ms by
class: K1, K2, cuBLAS GEMMs, the MoE's routing (``moe.route``) and its
dispatch and combine products (the first and last einsum of each
``moe.apply_moe`` call), and the rest (elementwise and copies). The Chrome traces go
to ``chiprun_out/profile_serve_<arch>_{prefill,decode}.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

GEMM_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")
MOE_LABELS = ("moe.apply_moe", "moe.route")    # profiler ranges of ``moe_ranges``


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


def _descendants(evt):
    for child in evt.cpu_children:
        yield child
        yield from _descendants(child)


def _is_kernel(e) -> bool:
    """A kernel on the device, not the GPU span that a profiler range
    (``record_function``) also leaves there."""
    return not getattr(e, "is_user_annotation", False) and e.name not in MOE_LABELS


def _kernel_ms(evt) -> float:
    """Device ms of the kernels launched inside a CPU event and its
    descendants (without the ranges' own GPU spans)."""
    return sum(k.duration for e in (evt, *_descendants(evt)) for k in e.kernels
               if k.name not in MOE_LABELS) / 1e3


def split_ms(prof, kernels) -> dict:
    """Device ms by class. K1, K2 and the GEMMs by kernel name; the MoE's
    routing and its dispatch + combine products by the CPU ranges that
    launched them (the device time of their kernels); the rest is
    everything else. Dispatch and combine are GEMMs too, so they are
    taken out of the GEMMs' sum."""
    def total(pred):
        return sum(e.time_range.elapsed_us() for e in kernels if pred(e.name)) / 1e3
    out = {
        "k1": total(lambda n: "flash_" in n),
        "k2": total(lambda n: "ssd_" in n or "cb_kernel" in n),
        "gemm": total(lambda n: any(g in n.lower() for g in GEMM_NAMES)),
    }
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    route_ms = sum(_kernel_ms(e) for e in events if e.name == "moe.route")
    dispatch_combine_ms = 0.0
    for e in events:
        if e.name != "moe.apply_moe":
            continue
        einsums = sorted((c for c in _descendants(e) if c.name == "aten::einsum"),
                         key=lambda c: c.time_range.start)
        if einsums:
            dispatch_combine_ms += _kernel_ms(einsums[0]) + _kernel_ms(einsums[-1])
    out["moe_route"] = route_ms
    out["moe_dispatch_combine"] = dispatch_combine_ms
    out["gemm"] -= dispatch_combine_ms
    out["rest"] = total(lambda n: True) - sum(out.values())
    return out


def report(name, prof, host_ms, out_path=None):
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and _is_kernel(e)]
    busy_ms = busy_us(kernels) / 1e3
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({"window": name, "host_ms": host_ms, "device_busy_ms": busy_ms,
                      "idle_share": 1.0 - busy_ms / host_ms, "kernels": len(kernels),
                      "device_ms_by_class": split_ms(prof, kernels)}))
    for kname, (us, n) in top:
        print(f"    {us / 1e3:9.3f} ms  {n:5d}x  {kname[:110]}")
    if out_path is not None:
        prof.export_chrome_trace(str(out_path))


@contextlib.contextmanager
def moe_ranges():
    """Label each ``moe.apply_moe`` and ``moe.route`` call with a profiler range."""
    import torch
    from repro_torch.models import moe
    apply_moe, route = moe.apply_moe, moe.route

    def labelled(fn, label):
        def call(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return call
    moe.apply_moe, moe.route = labelled(apply_moe, "moe.apply_moe"), labelled(route, "moe.route")
    try:
        yield
    finally:
        moe.apply_moe, moe.route = apply_moe, route


DECODE_STEPS = 8


def main() -> int:
    import chip_smoke
    chip_smoke.use_expandable_segments()
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="qwen2-0.5b",
                        help="one of chip_smoke.SERVE_ARCHS")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (PROMPT_LEN, SERVE_BATCH, SERVE_LAYERS, cut_depth, init_params,
                            make_request)
    from repro_torch.models import RunConfig, build
    from repro_torch.runtime.serve import grow_cache

    cfg, _ = cut_depth(args.arch, SERVE_LAYERS.get(args.arch))
    rc = RunConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device="cuda")
    model = build(cfg, rc)
    params = init_params(model)
    B, P, G = SERVE_BATCH, PROMPT_LEN, DECODE_STEPS
    request, frames = make_request(cfg, B, P, "cuda", steps=G)

    def run_prefill():
        return model.prefill(params, request)

    def run_decode(logits, cache):
        tok = logits[:, -1:].argmax(dim=-1)
        for t in range(G):
            step = {"tokens": tok} if frames is None else {"embeds": frames[:, t:t + 1]}
            logits, cache = model.decode(params, cache, step)
            tok = logits.argmax(dim=-1)
        return tok

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with moe_ranges():
        for _ in range(2):                       # warm-up at the measured shapes
            logits, cache = run_prefill()
            run_decode(logits, grow_cache(cache, G))
        torch.cuda.synchronize()
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

    # the same windows without the profiler or its ranges, for their overhead
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
