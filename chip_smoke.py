#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases; any failure exits non-zero and prints no result line:

1. Device: name, count, and ``nvidia-smi`` name and power limit. Build
   every kernel in ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each,
   all started together) and print the build seconds and ptxas report.
2. Kernels: K1 (flash attention) against its plain version at the
   serving shape of qwen2-0.5b (B=8, S=512, H=14, hd=64; causal and not,
   bf16 and f32), at a ragged S and at head_dim 32 and 128. Timed with
   CUDA events beside the plain version, PyTorch's
   ``scaled_dot_product_attention`` (a yardstick only; the port never
   calls it) and the bound.
3. Serve: full-width qwen2-0.5b in bf16 with seeded random weights,
   built through ``runtime.serve``, answers 8 requests of 512-token
   prompts: one prefill, then 64 greedy decode steps. K1 must launch
   once per layer in the prefill.
4. Consistency at full width in f32 with TF32 off: prefill logits with
   K1 against the same prefill with the plain attention, and
   prefill(tokens[:k]) + decode(tokens[k:]) against forward(tokens).
5. A ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, "device": ...}`` line.

It needs CUDA: without a card it exits with code 2 before doing anything.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
ARCH = "qwen2-0.5b"
SERVE_BATCH, PROMPT_LEN, DECODE_STEPS = 8, 512, 64
K1_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PREFILL_PLAIN_TOL = 1e-3          # f32 prefill logits, K1 vs plain attention
DECODE_TOL = 2e-3                 # f32 prefill + decode vs forward

# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by operand type
# (bf16 on the tensor cores; f32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# K1 bound and timing
# ---------------------------------------------------------------------------
def attention_bound(B, S, T, H, hd, dtype, causal):
    """(bound_ms, bound_by): the least time for this work on an H100.

    Bytes: q, k, v read once and o written once. Operations: 2 FLOPs per
    multiply-add of q.k and of p.v over the (query, key) pairs the mask
    keeps (this run's pairs, not S*T when causal).
    """
    import torch
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * B * S * H * hd + 2 * B * T * H * hd) * itemsize
    pairs = sum(min(i + 1, T) for i in range(S)) if causal else S * T
    flops = 4 * B * H * hd * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOP_PER_S[_dtype_name(dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_k1(gen) -> dict:
    """Hold K1 against its plain version on the card; time the serving shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    cases = [
        # (B, S, T, H, hd, dtype, causal)
        (8, 512, 512, 14, 64, torch.bfloat16, True),   # the serving prefill
        (8, 512, 512, 14, 64, torch.bfloat16, False),
        (8, 512, 512, 14, 64, torch.float32, True),
        (8, 512, 512, 14, 64, torch.float32, False),
        (2, 200, 200, 4, 64, torch.bfloat16, True),    # ragged S
        (2, 200, 200, 4, 64, torch.float32, True),
        (2, 200, 333, 4, 64, torch.float32, False),    # ragged T != S
        (2, 256, 256, 8, 32, torch.bfloat16, True),
        (2, 256, 256, 8, 32, torch.float32, True),
        (2, 256, 256, 8, 128, torch.bfloat16, True),
        (2, 256, 256, 8, 128, torch.float32, False),
    ]
    main = None
    for B, S, T, H, hd, dtype, causal in cases:
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, T, H, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, T, H, hd), generator=gen, device="cuda").to(dtype)
        out = ops.attention(q, k, v, causal=causal)
        expect = ref.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _check(out.shape == expect.shape and out.dtype == expect.dtype,
               f"K1 output {tuple(out.shape)} {out.dtype} differs in shape or type")
        diff = (out.float() - expect.float()).abs()
        err = float(diff.max())
        tol = K1_TOL[_dtype_name(dtype)]
        ok = bool((diff <= tol + tol * expect.float().abs()).all())
        print(f"  K1 B={B} S={S} T={T} H={H} hd={hd} {_dtype_name(dtype)} "
              f"causal={causal}: max_abs_err={err:.3e} (tol {tol:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        _check(ok, f"K1 disagrees with its plain version: max_abs_err={err}")
        if main is None:
            main = (q, k, v, causal, err, (B, S, T, H, hd, dtype, causal))

    q, k, v, causal, err, shape = main
    ms = time_ms(lambda: ops.attention(q, k, v, causal=causal))
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=causal), iters=20)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
    bound_ms, bound_by = attention_bound(*shape)
    print(f"  K1 at the serving shape: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / ms:.1%} of the bound", flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:31",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def grow_cache(cache, extra: int):
    """Room for ``extra`` more tokens along the cache's T axis."""
    import torch.nn.functional as F
    pad = (0, 0, 0, 0, 0, extra)            # (L, B, T, K, hd): pad T at its end
    return {**cache, "k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad)}


def greedy_decode(decode, params, logits, cache, steps: int):
    """Greedy tokens after a prefill: the prefill's own, then one per step.

    Returns (tokens (B, 1 + steps), last logits, cache).
    """
    import torch
    cache = grow_cache(cache, steps)
    tok = logits[:, -1:].argmax(dim=-1)
    out = [tok]
    for _ in range(steps):
        logits, cache = decode(params, cache, {"tokens": tok})
        tok = logits.argmax(dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1), logits, cache


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_prompts(cfg, batch, length, device):
    import torch
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, length))).to(device)


def serve(cfg, *, device: str, batch: int, prompt_len: int, decode_steps: int) -> dict:
    """Answer ``batch`` requests: one prefill, then greedy decode steps.

    Returns the timings, the attention launches made by the timed run,
    and the generated tokens (B, 1 + decode_steps).
    """
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import RunConfig
    from repro_torch.runtime.serve import build_decode_step, build_prefill_step

    rc = RunConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device=device)
    prefill, *_, model = build_prefill_step(cfg, None, B=batch, S=prompt_len, rc=rc)
    decode, *_ = build_decode_step(
        cfg, ShapeConfig("serve", "decode", prompt_len + decode_steps, batch), None, rc=rc)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    prompts = make_prompts(cfg, batch, prompt_len, device)

    # warm-up at the timed shapes (GEMM plans, allocator pools), not timed
    warm_logits, warm_cache = prefill(params, {"tokens": prompts})
    greedy_decode(decode, params, warm_logits, warm_cache, 2)
    del warm_logits, warm_cache
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.attention.launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    _sync(device)
    t1 = time.perf_counter()
    prefill_launches = ops.attention.launches
    gen, logits, cache = greedy_decode(decode, params, logits, cache, decode_steps)
    _sync(device)
    t2 = time.perf_counter()
    launches = ops.attention.launches
    _check(tuple(gen.shape) == (batch, 1 + decode_steps), f"tokens {tuple(gen.shape)}")
    _check(bool(((gen >= 0) & (gen < cfg.vocab_padded)).all()), "token out of range")
    _check(bool(torch.isfinite(logits.float()).all()), "non-finite decode logits")
    _check(cache["pos"] == prompt_len + decode_steps, f"cache pos {cache['pos']}")
    n_tokens = batch * (1 + decode_steps)
    return {
        "prefill_ms": (t1 - t0) * 1e3,
        "decode_ms_per_step": (t2 - t1) * 1e3 / decode_steps,
        "request_ms": (t2 - t0) * 1e3,
        "tokens_per_s": n_tokens / (t2 - t0),
        "prefill_launches": prefill_launches,
        "request_launches": launches,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if torch.device(device).type == "cuda" else None),
        "tokens": gen,
    }


@contextlib.contextmanager
def plain_attention():
    """Route the model's full-H attention to the plain version for a comparison."""
    from repro_torch.kernels import ops, ref
    kernel = ops.attention
    ops.attention = lambda q, k, v, *, causal=True: ref.attention_ref(q, k, v, causal=causal)
    try:
        yield
    finally:
        ops.attention = kernel


def consistency(cfg, *, device: str, prefill_batch: int, prefill_len: int,
                batch: int, seq_len: int, split: int) -> dict:
    """f32 errors: K1 vs plain prefill logits; prefill + decode vs forward."""
    import torch
    from repro_torch.models import RunConfig, build

    rc = RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32, device=device)
    model = build(cfg, rc)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))

    tokens = make_prompts(cfg, prefill_batch, prefill_len, device)
    logits, _ = model.prefill(params, {"tokens": tokens})
    with plain_attention():
        logits_plain, _ = model.prefill(params, {"tokens": tokens})
    err_plain = float((logits - logits_plain).abs().max())

    tokens = make_prompts(cfg, batch, seq_len, device)
    full, _, _ = model.apply(params, {"tokens": tokens})
    _, cache = model.prefill(params, {"tokens": tokens[:, :split]})
    cache = grow_cache(cache, seq_len - split)
    outs = []
    for t in range(split, seq_len):
        step_logits, cache = model.decode(params, cache, {"tokens": tokens[:, t:t + 1]})
        outs.append(step_logits)
    err_decode = float((torch.cat(outs, dim=1) - full[:, split:]).abs().max())
    _check(bool(torch.isfinite(full).all()), "non-finite forward logits")
    return {"prefill_k1_vs_plain": err_plain, "prefill_decode_vs_forward": err_decode}


# ---------------------------------------------------------------------------
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops

    # 1. device and build
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[1] device: {name} x{count}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    built = _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    for res in built.values():
        print(f"[1] built {res.name} in {res.seconds:.2f} s", flush=True)
        for line in res.ptxas.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"    {res.name}: {line.strip()}")

    # 2. K1 against its plain version, and its time
    print("[2] K1 against its plain version", flush=True)
    k1 = check_k1(torch.Generator(device="cuda").manual_seed(SEED))

    # 3. serve full-width qwen2-0.5b
    cfg = get_config(ARCH)
    res = serve(cfg, device="cuda", batch=SERVE_BATCH, prompt_len=PROMPT_LEN,
                decode_steps=DECODE_STEPS)
    print(f"[3] served {SERVE_BATCH} requests of {PROMPT_LEN} tokens + "
          f"{DECODE_STEPS} decode steps: prefill {res['prefill_ms']:.3f} ms, "
          f"decode {res['decode_ms_per_step']:.3f} ms/step, "
          f"{res['tokens_per_s']:.1f} generated tokens/s, "
          f"max_memory_allocated {res['max_memory_allocated']} B; K1 launches: "
          f"prefill {res['prefill_launches']}, request {res['request_launches']}",
          flush=True)
    _check(res["prefill_launches"] == cfg.n_layers,
           f"prefill launched K1 {res['prefill_launches']} times, not {cfg.n_layers}")
    _check(res["request_launches"] == cfg.n_layers,
           f"request launched K1 {res['request_launches']} times, not {cfg.n_layers}")

    # 4. f32 consistency at full width
    errs = consistency(cfg, device="cuda", prefill_batch=SERVE_BATCH,
                       prefill_len=PROMPT_LEN, batch=2, seq_len=96, split=32)
    print(f"[4] f32 consistency: {json.dumps(errs)}", flush=True)
    _check(errs["prefill_k1_vs_plain"] <= PREFILL_PLAIN_TOL,
           f"prefill K1 vs plain {errs['prefill_k1_vs_plain']} > {PREFILL_PLAIN_TOL}")
    _check(errs["prefill_decode_vs_forward"] <= DECODE_TOL,
           f"prefill+decode vs forward {errs['prefill_decode_vs_forward']} > {DECODE_TOL}")

    # 5. results; the ok line is last
    k1["launches"] = res["prefill_launches"]
    print(json.dumps({"kernels": [k1]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
