#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases; any failure exits non-zero and prints no result line:

1. Device: name, count, and ``nvidia-smi`` name and power limit. Build
   every kernel in ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each,
   all started together) and print the build seconds and ptxas report.
2. Kernels: K1 (flash attention) against its plain version at the
   prefill shape of each served model with attention (B=8, S=512):
   qwen2-0.5b (H=14 query heads over K=2 KV heads, hd=64; causal and
   not, bf16 and f32), zamba2-1.2b's shared block (H=K=32, hd=64) and
   gemma-7b (H=K=16, hd=256; causal and not, bf16 and f32); at K = H
   and K = 1, at a ragged S and T (also at hd 256 with GQA) and at
   head_dim 32 and 128. Each of the three prefill shapes is timed with
   CUDA events beside the plain version, PyTorch's
   ``scaled_dot_product_attention`` on the full-H (``repeat_kv``) k/v
   (a yardstick only; the port never calls it) and the bound. K2 (the
   SSD scan) against ``ref.ssd_ref`` (f32 2e-3, bf16 5e-2) and, in f32,
   ``models.ssm.ssd_chunked`` (2e-4), y and final state, at the prefill
   shapes of mamba2-2.7b (B=8, S=512, H=80, P=64, N=128, chunk 128) and
   zamba2-1.2b (H=64, P=64, N=64), at chunks 96, 48, 12 and 1, at
   (P, N) = (16, 16) and the JAX kernel tests' shapes, with bf16 x and
   f32 B/C, and with an initial state; each case prints the kernel its
   dtypes chose (``mma``: tensor cores, bf16 x and B/C; ``scalar``: any
   f32 operand). Both prefill shapes are timed beside ``ssd_chunked``
   and the bound (and mamba2's beside ``ssd_ref``; no single PyTorch
   call computes it).
3. Serve: full-width qwen2-0.5b, mamba2-2.7b, zamba2-1.2b (hybrid: 38
   Mamba2 layers and one shared attention block applied after every
   6th) and gemma-7b (head_dim 256), each at full depth, in bf16 with
   seeded random weights, built through ``runtime.serve``, each
   answering 8 requests of 512-token prompts: one prefill, then greedy
   decode steps (64 each). The counts are set to 0 before each model's
   timed request; its prefill and its whole request must launch K1 and
   K2 exactly ``expected_launches(cfg)`` times: K1 once per attention
   layer or shared-block application, K2 once per Mamba2 layer, and
   neither in decode.
4. Consistency in f32 with TF32 off, for each model at full width (and
   full depth, but gemma-7b cut to 4 layers: its f32 params alone are
   34 GB): prefill logits with the kernels against the same prefill
   with their plain versions, and prefill(tokens[:k]) +
   decode(tokens[k:]) against forward(tokens).
5. Train: K1 under a gradient (``FlashAttentionFn``: K1 forward,
   tensor-op backward) at the training shape (B=8, S=512, H=14 over K=2
   and K=H, hd=64; causal and not; f32 and bf16), dq, dk and dv against
   ``torch.autograd.grad`` through the plain version (f32 1e-4, bf16
   5e-2), with the backward's ms beside PyTorch's
   ``scaled_dot_product_attention`` forward + backward (a yardstick
   only). Then 8 AdamW steps of full-width qwen2-0.5b (f32 params, bf16
   compute) on ``SyntheticLM`` batches of 8 x 512 tokens, built through
   ``runtime.train``: the loss must fall, every loss and grad norm be
   finite, K1 launch 24 times a step and K2 never. A checkpoint saved
   after step 4 (async, then waited for) is restored into a fresh state
   and step 5 taken again from it: loss and params equal the
   uninterrupted step 5 within 1e-6. Last, an f32 step of the model cut
   to 4 layers (full widths) with K1 against the same step with the
   plain version: loss and grad norm within 1e-4 relative, updated
   params within 1e-4, and every gradient leaf within 1e-4 of its
   plain counterpart's largest value (the q/k/v projections' non-zero).
6. Workflows under the port's KubeAdaptor engine (``repro_torch.core``)
   with ``payload_mode="real"``, each with the counts set to 0 just
   before it: the serve twin (``repro_torch.examples.serve_batch``) on
   full-width qwen2-0.5b in bf16, 8 prompts of 512 tokens and G = 65
   (the cache grown by 65 slots, 64 decode steps): a plain loop, then a
   prefill pod and a decode pod, whose tokens must be bit-equal to the
   loop's, K1 launching 24 times in the prefill pod and never in the
   decode pod. The cache-length check: greedy decode with the cache
   grown by 64 and by 65 slots, in f32 at full width cut to 4 layers
   (logits within 1e-5, tokens equal), and the count of differing
   tokens in bf16 at full depth (a measured fact, not a check); in
   both, filling the never-written 65th slot with noise must leave the
   logits and tokens bit-equal (the mask leaks nothing). The
   train twin (``repro_torch.examples.workflow_train``): 8 x 512-token
   batches, data_prep, 3 phases of 2 steps with a pod failure on
   phase_2 and a retry that resumes from the checkpoint, then eval
   (one retry, a falling loss, a finite eval loss, 24 K1 launches a
   step and in the eval forward, the order consistent). Last, a diamond
   of four ``matmul_payload(n=8192, iters=4)`` pods, their seconds
   beside the f32-peak bound.
7. A ``{"kernels": [...]}`` line (each kernel's ``launches`` is the sum
   over the four served models' prefills, ``launches_by_arch`` per model,
   ``at`` its numbers at each model's prefill shape; K1's also per
   workflow pod), the ``nvidia-smi`` line, and last the
   ``{"ok": true, "device": ...}`` line.

It needs CUDA: without a card it exits with code 2 before doing anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
ARCH = "qwen2-0.5b"               # the trained model, and K1's first timed shape
SSM_ARCH = "mamba2-2.7b"          # K2's first timed shape
SERVE_ARCHS = ("qwen2-0.5b", "mamba2-2.7b", "zamba2-1.2b", "gemma-7b")
CONSISTENCY_LAYERS = {"gemma-7b": 4}   # depth cut of phase 4 (full widths)
# the bf16 causal prefill shape each model hands a kernel: K1 (B, S, T, H, K, hd),
# K2 (b, s, h, p, n, chunk)
K1_SHAPES = {"qwen2-0.5b": (8, 512, 512, 14, 2, 64),
             "zamba2-1.2b": (8, 512, 512, 32, 32, 64),
             "gemma-7b": (8, 512, 512, 16, 16, 256)}
K2_SHAPES = {"mamba2-2.7b": (8, 512, 80, 64, 128, 128),
             "zamba2-1.2b": (8, 512, 64, 64, 64, 128)}
SERVE_BATCH, PROMPT_LEN, DECODE_STEPS = 8, 512, 64
K1_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
K2_REF_TOL = {"float32": 2e-3, "bfloat16": 5e-2}   # K2 vs ssd_ref (the JAX kernel test's)
K2_CHUNKED_TOL = 2e-4             # f32 K2 vs ssd_chunked (the JAX production-path test's)
PREFILL_PLAIN_TOL = 1e-3          # f32 prefill logits, kernels vs their plain versions
DECODE_TOL = 2e-3                 # f32 prefill + decode vs forward
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, RESUME_AFTER = 8, 512, 8, 4
K1_GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}   # FlashAttentionFn vs plain autograd
TRAIN_PLAIN_TOL = 1e-4            # f32 step, kernels vs plain: loss, grad norm, grads (rel), params
RESUME_TOL = 1e-6                 # step 5 from the checkpoint vs the uninterrupted step 5
TRAIN_PLAIN_LAYERS = 4            # depth of the f32 kernels-vs-plain step (full widths)
WF_GEN = 65                       # the serve workflow grows the cache by G, takes G - 1 steps
CACHE_LEN_LAYERS = 4              # depth of the f32 cache-length check (full widths)
CACHE_LEN_TOL = 1e-5              # f32 logits, cache grown by 64 vs by 65 slots
WF_TRAIN_STEPS, WF_TRAIN_PHASES = 6, 3
MATMUL_N, MATMUL_ITERS = 8192, 4  # the diamond's matmul_payload pods

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
def attention_bound(B, S, T, H, K, hd, dtype, causal):
    """(bound_ms, bound_by): the least time for this work on an H100.

    Bytes: q (H heads), k and v (K heads) read once and o written once.
    Operations: 2 FLOPs per multiply-add of q.k and of p.v over the
    (query, key) pairs the mask keeps (this run's pairs, not S*T when
    causal), for every query head.
    """
    import torch
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * B * S * H * hd + 2 * B * T * K * hd) * itemsize
    pairs = sum(min(i + 1, T) for i in range(S)) if causal else S * T
    flops = 4 * B * H * hd * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOP_PER_S[_dtype_name(dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int = 100, warmup: int = 10, queued: bool = True) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls (CUDA events).

    ``queued``: the stream first spins for about 50 ms (``torch.cuda._sleep``)
    while the host queues the calls, so that a call whose host side takes
    longer than its kernels is still timed by its kernels, not by its
    Python. Without it the time is paced by whichever side is slower.
    """
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _sdpa_ms(q, k, v, causal) -> float:
    """PyTorch's ``scaled_dot_product_attention`` on full-H (``repeat_kv``)
    k/v, the yardstick of the runs before the GQA-folded K1."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    H = q.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, ref.repeat_kv(k, H), ref.repeat_kv(v, H)))
    return time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))


def check_k1(gen) -> dict:
    """Hold K1 against its plain version on the card; time each model's
    prefill shape (``K1_SHAPES``)."""
    import torch
    from repro_torch.kernels import ops, ref

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # (B, S, T, H, K, hd, dtype, causal): K KV heads, H % K == 0
        (8, 512, 512, 14, 2, 64, bf16, True),      # qwen2-0.5b's prefill
        (8, 512, 512, 14, 2, 64, bf16, False),
        (8, 512, 512, 14, 2, 64, f32, True),
        (8, 512, 512, 14, 2, 64, f32, False),
        (8, 512, 512, 14, 14, 64, bf16, True),     # full-H k/v (K == H)
        (8, 512, 512, 32, 32, 64, bf16, True),     # zamba2-1.2b's shared block
        (8, 512, 512, 16, 16, 256, bf16, True),    # gemma-7b's prefill, hd 256
        (8, 512, 512, 16, 16, 256, bf16, False),
        (8, 512, 512, 16, 16, 256, f32, True),
        (8, 512, 512, 16, 16, 256, f32, False),
        (2, 200, 333, 8, 2, 256, bf16, True),      # hd 256, ragged S != T, GQA
        (2, 200, 333, 8, 2, 256, bf16, False),
        (2, 200, 333, 8, 2, 256, f32, False),
        (2, 200, 200, 4, 2, 64, bf16, True),       # ragged S
        (2, 200, 200, 4, 2, 64, f32, True),
        (2, 200, 333, 4, 4, 64, f32, False),       # ragged T != S
        (2, 200, 333, 4, 1, 64, bf16, False),
        (2, 256, 256, 8, 1, 32, bf16, True),
        (2, 256, 256, 8, 2, 32, f32, True),
        (2, 256, 256, 8, 2, 128, bf16, True),
        (2, 256, 256, 8, 1, 128, f32, False),
    ]
    timed = {}
    for B, S, T, H, K, hd, dtype, causal in cases:
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, T, K, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, T, K, hd), generator=gen, device="cuda").to(dtype)
        out = ops.attention(q, k, v, causal=causal)
        expect = ref.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _check(out.shape == expect.shape and out.dtype == expect.dtype,
               f"K1 output {tuple(out.shape)} {out.dtype} differs in shape or type")
        diff = (out.float() - expect.float()).abs()
        err = float(diff.max())
        tol = K1_TOL[_dtype_name(dtype)]
        ok = bool((diff <= tol + tol * expect.float().abs()).all())
        print(f"  K1 B={B} S={S} T={T} H={H} K={K} hd={hd} {_dtype_name(dtype)} "
              f"causal={causal}: max_abs_err={err:.3e} (tol {tol:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        _check(ok, f"K1 disagrees with its plain version: max_abs_err={err}")
        for arch, shape in K1_SHAPES.items():
            if (B, S, T, H, K, hd) == shape and dtype == bf16 and causal and arch not in timed:
                timed[arch] = (q, k, v, err)
    _check(sorted(timed) == sorted(K1_SHAPES), f"K1 timed shapes {sorted(timed)}")

    at = {}
    for arch, (q, k, v, err) in timed.items():
        ms = time_ms(lambda: ops.attention(q, k, v, causal=True))
        plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=True), iters=20)
        library_ms = _sdpa_ms(q, k, v, True)
        bound_ms, bound_by = attention_bound(*K1_SHAPES[arch], torch.bfloat16, True)
        at[arch] = {"shape": "B,S,T,H,K,hd=" + ",".join(map(str, K1_SHAPES[arch])),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        print(f"  K1 at {arch}'s prefill shape ({at[arch]['shape']}, bf16, causal): "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms "
              f"({ms / library_ms:.2f}x), bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of the bound", flush=True)
    q, k, v, _ = timed[ARCH]
    paced_ms = time_ms(lambda: ops.attention(q, k, v, causal=True), queued=False)
    print(f"  K1 at {ARCH}'s prefill shape, paced by the host (back-to-back calls "
          f"without a queued start): {paced_ms:.4f} ms a call", flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:31",
            "design": "mma.sync bf16 + cp.async ring, GQA-folded k/v (hd 256: 32-key "
                      "tiles, q fragments from shared memory); f32 scalar",
            **{key: at[ARCH][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
            "at": at}


# ---------------------------------------------------------------------------
# K2 bound and check
# ---------------------------------------------------------------------------
def ssd_bound(b, s, h, p, n, chunk, x_dtype, bc_dtype, init_state=False):
    """(bound_ms, bound_by): the least time for one K2 call on an H100.

    Bytes: x, dt, A, B, C (and the initial state) read once, y and the
    final state written once. Operations: 2 FLOPs per multiply-add of
    C.B^T over each chunk's causal (i, j) pairs (once per batch row and
    chunk: B and C have no head axis), and per batch row, head and chunk
    of the intra-chunk term over the same pairs and P, and of the
    carried-state output term and the state update (c * N * P each). The
    peak is bf16's when x, B and C are all bf16, else f32's.
    """
    import torch
    isz = {torch.float32: 4, torch.bfloat16: 2}
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    nbytes = (2 * b * s * h * p * isz[x_dtype] + b * s * h * 4 + h * 4
              + 2 * b * s * n * isz[bc_dtype] + (2 if init_state else 1) * b * h * p * n * 4)
    flops = 2 * b * nc * (pairs * n + h * (pairs * p + 2 * chunk * n * p))
    peak_type = "bfloat16" if x_dtype == bc_dtype == torch.bfloat16 else "float32"
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOP_PER_S[peak_type]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ssd_inputs(gen, b, s, h, p, n, x_dtype, bc_dtype, init_state=False):
    """The JAX kernel tests' distributions: x ~ N(0, 1), dt = softplus(N(0, 1)),
    A = -exp(0.3 N(0, 1)), B, C ~ 0.5 N(0, 1); state ~ 0.5 N(0, 1)."""
    import torch
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(b, s, h, p).to(x_dtype)
    dt = F.softplus(randn(b, s, h))
    A = -torch.exp(randn(h) * 0.3)
    B = (randn(b, s, n) * 0.5).to(bc_dtype)
    C = (randn(b, s, n) * 0.5).to(bc_dtype)
    st = randn(b, h, p, n) * 0.5 if init_state else None
    return x, dt, A, B, C, st


def _k2_err(name, got, expect, tol) -> float:
    diff = (got.float() - expect.float()).abs()
    ok = bool((diff <= tol + tol * expect.float().abs()).all())
    err = float(diff.max())
    print(f"    {name}: max_abs_err={err:.3e} (tol {tol:g}, max |plain| "
          f"{float(expect.float().abs().max()):.3g}) {'ok' if ok else 'FAIL'}", flush=True)
    _check(ok, f"K2 disagrees with its plain version ({name}): max_abs_err={err}")
    return err


def check_k2(gen) -> dict:
    """Hold K2 against both plain versions on the card; time each model's
    prefill shape (``K2_SHAPES``)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models.ssm import ssd_chunked

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # (b, s, h, p, n, chunk, x dtype, B/C dtype, init_state)
        (8, 512, 80, 64, 128, 128, bf16, bf16, False),   # mamba2-2.7b's prefill
        (8, 512, 80, 64, 128, 128, f32, f32, False),
        (8, 512, 64, 64, 64, 128, bf16, bf16, False),    # zamba2-1.2b's prefill
        (8, 512, 64, 64, 64, 128, f32, f32, False),
        (2, 96, 8, 64, 128, 96, bf16, bf16, False),      # S=96 -> chunk 96
        (2, 96, 8, 64, 128, 96, f32, f32, False),
        (2, 24, 4, 16, 16, 12, f32, f32, False),         # S=24, reduced chunk 16 -> 12
        (2, 24, 4, 16, 16, 12, bf16, bf16, False),
        (1, 13, 2, 8, 16, 1, f32, f32, False),           # a prime S -> chunk 1
        (2, 256, 16, 64, 64, 128, bf16, bf16, False),    # zamba2-1.2b's (P, N)
        (2, 256, 16, 64, 64, 128, f32, f32, False),
        (2, 64, 16, 16, 16, 16, f32, f32, False),        # the reduced configs
        (1, 64, 2, 8, 16, 16, f32, f32, False),          # the JAX kernel tests' shapes
        (2, 128, 4, 16, 32, 32, bf16, bf16, False),
        (1, 128, 8, 32, 64, 64, f32, f32, False),
        (2, 96, 2, 16, 16, 48, bf16, f32, False),        # bf16 x with f32 B/C
        (2, 256, 8, 64, 128, 128, f32, f32, True),       # with an initial state
        (2, 256, 8, 64, 128, 128, bf16, bf16, True),
        # the tensor-core path's padding: chunk and N not multiples of 16
        (2, 96, 4, 64, 64, 48, bf16, bf16, True),
        (2, 24, 4, 64, 128, 12, bf16, bf16, True),
        (2, 24, 4, 16, 16, 12, bf16, bf16, True),
        (1, 7, 2, 64, 64, 1, bf16, bf16, True),
        (2, 64, 4, 32, 20, 32, bf16, bf16, True),
        (1, 32, 2, 8, 12, 16, bf16, bf16, False),
    ]
    timed = {}
    for case in cases:
        b, s, h, p, n, chunk, xdt, bcdt, with_init = case
        x, dt, A, B, C, st = ssd_inputs(gen, b, s, h, p, n, xdt, bcdt, with_init)
        before = ops.ssd.launches
        y, fin = ops.ssd(x, dt, A, B, C, chunk=chunk, init_state=st)
        _check(ops.ssd.launches == before + 1, "ops.ssd did not count its launch")
        y_ref, fin_ref = ref.ssd_ref(x, dt, A, B, C, init_state=st)
        torch.cuda.synchronize()
        _check(y.shape == x.shape and y.dtype == x.dtype and fin.dtype == f32
               and tuple(fin.shape) == (b, h, p, n),
               f"K2 outputs {tuple(y.shape)} {y.dtype}, {tuple(fin.shape)} {fin.dtype}")
        print(f"  K2 b={b} s={s} h={h} p={p} n={n} chunk={chunk} x {_dtype_name(xdt)} "
              f"B/C {_dtype_name(bcdt)} init_state={with_init} "
              f"kernel={ssd_mod.kernel_path(xdt, bcdt)}:", flush=True)
        tol = K2_REF_TOL[_dtype_name(xdt)]
        err = max(_k2_err("y vs ssd_ref", y, y_ref, tol),
                  _k2_err("state vs ssd_ref", fin, fin_ref, tol))
        if xdt == bcdt == f32:
            y_c, fin_c = ssd_chunked(x, dt, A, B, C, chunk, init_state=st)
            _k2_err("y vs ssd_chunked", y, y_c, K2_CHUNKED_TOL)
            _k2_err("state vs ssd_chunked", fin, fin_c, K2_CHUNKED_TOL)
        for arch, shape in K2_SHAPES.items():
            if (case[:6] == shape and xdt == bcdt == bf16 and not with_init
                    and arch not in timed):
                timed[arch] = (x, dt, A, B, C, err)
    _check(sorted(timed) == sorted(K2_SHAPES), f"K2 timed shapes {sorted(timed)}")

    at = {}
    for arch, (x, dt, A, B, C, err) in timed.items():
        b, s, h, p, n, chunk = K2_SHAPES[arch]
        ms = time_ms(lambda: ops.ssd(x, dt, A, B, C, chunk=chunk))
        plain_ms = time_ms(lambda: ssd_chunked(x, dt, A, B, C, chunk), iters=10, warmup=2)
        bound_ms, bound_by = ssd_bound(b, s, h, p, n, chunk, bf16, bf16)
        at[arch] = {"shape": "b,s,h,p,n,chunk=" + ",".join(map(str, K2_SHAPES[arch])),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        print(f"  K2 at {arch}'s prefill shape ({at[arch]['shape']}, bf16): {ms:.4f} ms, "
              f"plain ssd_chunked {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), {bound_ms / ms:.1%} of the bound", flush=True)
    x, dt, A, B, C, _ = timed[SSM_ARCH]
    chunk = K2_SHAPES[SSM_ARCH][-1]
    paced_ms = time_ms(lambda: ops.ssd(x, dt, A, B, C, chunk=chunk), queued=False)
    ref_ms = time_ms(lambda: ref.ssd_ref(x, dt, A, B, C), iters=3, warmup=1)
    print(f"  K2 at {SSM_ARCH}'s prefill shape: paced by the host {paced_ms:.4f} ms a "
          f"call; ssd_ref {ref_ms:.4f} ms", flush=True)
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:35",
            "design": "mma.sync bf16 (f32 operands split hi + lo) + cp.async, "
                      "(batch, head, P/2) CTAs; f32 scalar",
            **{key: at[SSM_ARCH][key] for key in ("max_abs_err", "ms", "plain_ms",
                                                  "bound_ms", "bound_by", "library_ms")},
            "plain_ref_ms": ref_ms, "at": at}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def greedy_decode(decode, params, logits, cache, steps: int):
    """Greedy tokens after a prefill: the prefill's own, then one per step.

    Returns (tokens (B, 1 + steps), last logits, cache).
    """
    import torch
    from repro_torch.runtime.serve import grow_cache
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


def _launches() -> dict:
    from repro_torch.kernels import ops
    return {"attention": ops.attention.launches, "ssd": ops.ssd.launches}


def expected_launches(cfg) -> dict:
    """K1 and K2 launches of one prefill of ``cfg`` (and of a whole request:
    decode runs neither kernel). K1 runs once per attention layer (dense)
    or per application of the hybrid's shared block, one after every full
    segment of ``attn_every`` Mamba2 layers (zamba2-1.2b: 38 // 6 = 6);
    K2 once per Mamba2 layer."""
    if cfg.family == "dense":
        return {"attention": cfg.n_layers, "ssd": 0}
    if cfg.family == "ssm":
        return {"attention": 0, "ssd": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"attention": cfg.n_layers // cfg.attn_every, "ssd": cfg.n_layers}
    raise ValueError(f"no served path for family {cfg.family!r}")


def serve(cfg, *, device: str, batch: int, prompt_len: int, decode_steps: int) -> dict:
    """Answer ``batch`` requests: one prefill, then greedy decode steps.

    Returns the timings, the launches of each kernel ({"attention": n,
    "ssd": m}) made by the timed prefill and by the whole timed request,
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
    ops.attention.launches = ops.ssd.launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    _sync(device)
    t1 = time.perf_counter()
    prefill_launches = _launches()
    gen, logits, cache = greedy_decode(decode, params, logits, cache, decode_steps)
    _sync(device)
    t2 = time.perf_counter()
    launches = _launches()
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
def plain_kernels():
    """Route both ``ops`` entries (attention, SSD scan) to their plain
    versions, for a comparison only."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.ssm import ssd_chunked
    kernels = ops.attention, ops.ssd
    ops.attention = lambda q, k, v, *, causal=True: ref.attention_ref(q, k, v, causal=causal)
    ops.ssd = lambda x, dt, A, B, C, *, chunk, init_state=None: ssd_chunked(
        x, dt, A, B, C, chunk, init_state=init_state)
    try:
        yield
    finally:
        ops.attention, ops.ssd = kernels


def consistency(cfg, *, device: str, prefill_batch: int, prefill_len: int,
                batch: int, seq_len: int, split: int) -> dict:
    """f32 errors: prefill logits with the kernels vs their plain versions;
    prefill + decode vs forward."""
    import torch
    from repro_torch.models import RunConfig, build
    from repro_torch.runtime.serve import grow_cache

    rc = RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32, device=device)
    model = build(cfg, rc)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))

    tokens = make_prompts(cfg, prefill_batch, prefill_len, device)
    logits, _ = model.prefill(params, {"tokens": tokens})
    with plain_kernels():
        logits_plain, _ = model.prefill(params, {"tokens": tokens})
    err_plain = float((logits - logits_plain).abs().max())
    del logits, logits_plain

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
    return {"prefill_kernels_vs_plain": err_plain, "prefill_decode_vs_forward": err_decode}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
def _grads_err(got, expect, tol):
    """(max abs error, within tol abs + tol rel) over matching gradient tensors."""
    err, ok = 0.0, True
    for g, e in zip(got, expect):
        diff = (g.float() - e.float()).abs()
        err = max(err, float(diff.max()))
        ok = ok and bool((diff <= tol + tol * e.float().abs()).all())
    return err, ok


def check_k1_grad(gen) -> dict:
    """K1 under a gradient against autograd through its plain version, and the
    backward's time beside SDPA forward + backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    B, S, H, hd = TRAIN_BATCH, TRAIN_LEN, 14, 64
    main = None
    for K in (2, H):
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
                k, v = (torch.randn((B, S, K, hd), generator=gen, device="cuda").to(dtype)
                        for _ in range(2))
                dout = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
                inputs = [t.requires_grad_(True) for t in (q, k, v)]
                before = ops.attention.launches
                out = ops.attention(*inputs, causal=causal)
                _check(ops.attention.launches == before + 1 and out.grad_fn is not None,
                       "ops.attention under grad did not go through FlashAttentionFn")
                got = torch.autograd.grad(out, inputs, dout)
                expect = torch.autograd.grad(ref.attention_ref(*inputs, causal=causal),
                                             inputs, dout)
                torch.cuda.synchronize()
                tol = K1_GRAD_TOL[_dtype_name(dtype)]
                err, ok = _grads_err(got, expect, tol)
                print(f"  K1 grad B={B} S={S} H={H} K={K} hd={hd} {_dtype_name(dtype)} "
                      f"causal={causal}: dq/dk/dv max_abs_err={err:.3e} (tol {tol:g}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                _check(ok, f"K1's gradient disagrees with its plain version's: {err}")
                if main is None:
                    main = (q.detach(), k.detach(), v.detach(), out.detach(), dout, causal)

    q, k, v, out, dout, causal = main          # bf16, causal, K = 2: the train step's
    bwd_ms = time_ms(lambda: ref.attention_bwd(q, k, v, out, dout, causal=causal),
                     iters=20, warmup=3)
    fwd_ms = time_ms(lambda: ops.attention(q, k, v, causal=causal))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, ref.repeat_kv(k, H), ref.repeat_kv(v, H)))
    dot = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        torch.autograd.grad(o, (qt, kt, vt), dot)
    sdpa_ms = time_ms(sdpa_fwd_bwd, iters=20, warmup=3)
    print(f"  K1 at the training shape (bf16, causal, K=2): forward {fwd_ms:.4f} ms, "
          f"backward (tensor ops) {bwd_ms:.4f} ms; SDPA forward + backward on "
          f"full-H k/v {sdpa_ms:.4f} ms (yardstick; the port never calls it)", flush=True)
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "sdpa_fwd_bwd_ms": sdpa_ms}


def _max_abs_diff(a, b) -> float:
    from repro_torch.tree import tree_leaves
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def train(cfg, *, device: str, batch: int, seq_len: int, steps: int, resume_after: int,
          ckpt_dir) -> dict:
    """``steps`` AdamW steps on ``SyntheticLM`` batches through ``runtime.train``.

    A checkpoint saved after step ``resume_after`` is restored into a
    fresh (meta) state and step ``resume_after + 1`` is taken again from
    it. Returns the per-step metrics and times, the launches of each
    kernel per step, the peak memory and the resume errors.
    """
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import ops
    from repro_torch.models import RunConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.train import (TrainRunConfig, build_train_step,
                                           init_sharded_state)
    from repro_torch.tree import tree_map

    rc = RunConfig(param_dtype=torch.float32, compute_dtype=torch.bfloat16, device=device)
    trc = TrainRunConfig(opt=OptConfig(lr=3e-4, warmup_steps=2, total_steps=steps))
    step, state_meta, _, _, _, model = build_train_step(cfg, None, B=batch, S=seq_len,
                                                        rc=rc, trc=trc)
    state = init_sharded_state(model, None, None, SEED)
    data = SyntheticLM(DataConfig(batch, seq_len, cfg.vocab_size, seed=SEED))
    ckpt = Checkpointer(ckpt_dir, keep=1)

    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    metrics, step_ms, launches = [], [], []
    ops.attention.launches = ops.ssd.launches = 0
    for i in range(1, steps + 1):
        b = to_device(next(data), device)
        before = _launches()
        _sync(device)
        t0 = time.perf_counter()
        state, met = step(state, b)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: n - before[k] for k, n in _launches().items()})
        metrics.append({k: float(v) for k, v in met.items()})
        if i == resume_after:
            t0 = time.perf_counter()
            ckpt.save(state, i)
            ckpt.wait()
            save_s = time.perf_counter() - t0
        if i == resume_after + 1:
            # held on the host, so that it takes no room in the card's peak memory
            after_resume = tree_map(lambda t: t.to("cpu", copy=True), state.params)
            batch_resume = b
    total_launches = _launches()
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else None)
    del state

    t0 = time.perf_counter()
    restored = ckpt.restore(state_meta, device=device)
    restore_s = time.perf_counter() - t0
    _check(int(restored.step) == resume_after, f"restored step {int(restored.step)}")
    resumed, met = step(restored, batch_resume)
    del restored
    loss_err = abs(float(met["loss"]) - metrics[resume_after]["loss"])
    params_err = _max_abs_diff(tree_map(lambda t: t.to("cpu"), resumed.params),
                               after_resume)
    timed = step_ms[1:] or step_ms
    return {
        "metrics": metrics, "step_ms": step_ms,
        "median_step_ms": statistics.median(timed),
        "tokens_per_s": batch * seq_len / (statistics.median(timed) / 1e3),
        "launches_per_step": launches, "launches": total_launches,
        "max_memory_allocated": peak, "save_s": save_s, "restore_s": restore_s,
        "resume_loss_err": loss_err, "resume_params_err": params_err,
    }


def train_consistency(cfg, *, device: str, batch: int, seq_len: int) -> dict:
    """f32 errors of one train step with the kernels against the same step with
    their plain versions, from one state and one batch, and of its gradients
    leaf by leaf (max abs error over the plain leaf's max abs value).

    The gradients carry the check of K1's backward: at step 1 the learning
    rate is 3e-6 and Adam's first step is sign-normalised, so the updated
    params can differ by at most about 6e-6 whatever the gradients are.
    """
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.models import RunConfig
    from repro_torch.runtime.train import build_train_step, init_sharded_state, value_and_grad
    from repro_torch.tree import tree_flatten_with_path

    rc = RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32, device=device)
    step, *_, model = build_train_step(cfg, None, B=batch, S=seq_len, rc=rc)
    state = init_sharded_state(model, None, None, SEED)
    b = to_device(next(SyntheticLM(DataConfig(batch, seq_len, cfg.vocab_size,
                                              seed=SEED))), device)
    new, met = step(state, b)
    grads = tree_flatten_with_path(value_and_grad(model.loss, state.params, b)[1])
    with plain_kernels():
        new_plain, met_plain = step(state, b)
        grads_plain = tree_flatten_with_path(
            value_and_grad(model.loss, state.params, b)[1])

    def rel(key):
        return abs(float(met[key]) - float(met_plain[key])) / abs(float(met_plain[key]))
    grads_rel, grads_scale = {}, {}
    for key, e in grads_plain.items():
        grads_scale[key] = float(e.abs().max())
        err = float((grads[key] - e).abs().max())
        grads_rel[key] = err / grads_scale[key] if grads_scale[key] else err
    return {"loss_rel": rel("loss"), "grad_norm_rel": rel("grad_norm"),
            "params_abs": _max_abs_diff(new.params, new_plain.params),
            "grads_rel": grads_rel, "grads_scale": grads_scale,
            "loss": float(met["loss"])}


# ---------------------------------------------------------------------------
# Workflows: the port's KubeAdaptor engine running the pods
# ---------------------------------------------------------------------------
def serve_workflow(cfg, *, device: str, batch: int, prompt_len: int, gen: int) -> dict:
    """The serve twin in bf16 (plain loop, then prefill pod -> decode pod),
    with the counts set to 0 just before it and read just after."""
    import torch
    from repro_torch.examples import serve_batch
    from repro_torch.kernels import ops
    from repro_torch.models import RunConfig, build

    rc = RunConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device=device)
    params = build(cfg, rc).init(torch.Generator(device=device).manual_seed(SEED))
    prompts = make_prompts(cfg, batch, prompt_len, device)
    ops.attention.launches = ops.ssd.launches = 0
    out = serve_batch.run(cfg, params, prompts, gen=gen, rc=rc)
    out["launches"] = _launches()
    return out


def cache_length(cfg, *, device: str, dtype, batch: int, prompt_len: int,
                 steps: int) -> dict:
    """Greedy decode of ``steps`` tokens after one prefill, with the KV cache
    grown by ``steps`` slots, by ``steps + 1`` (the serve workflow's
    geometry: the last slot is never written and stays masked), and by
    ``steps + 1`` with that last slot's k and v filled with noise.

    Returns the largest difference of the first two runs' decode logits,
    the largest |logit|, how many of their tokens differ, and whether the
    third run's logits and tokens are bit-equal to the second's: a masked
    slot that leaked into the output would break that equality, while a
    rounding that depends on the cache length cannot, since the second
    and third runs have the same length.
    """
    import torch
    from repro_torch.examples.serve_batch import first_token
    from repro_torch.models import RunConfig, build
    from repro_torch.runtime.serve import grow_cache

    rc = RunConfig(param_dtype=dtype, compute_dtype=dtype, device=device)
    model = build(cfg, rc)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    logits, cache0 = model.prefill(params, {"tokens": make_prompts(cfg, batch, prompt_len,
                                                                   device)})
    noise = torch.Generator(device=device).manual_seed(SEED + 1)
    runs = []
    for extra, fill in ((steps, False), (steps + 1, False), (steps + 1, True)):
        cache = grow_cache(cache0, extra)
        if fill:                        # the slot that no step writes
            for name in ("k", "v"):
                last = cache[name][:, :, -1]
                last.copy_(10 * torch.randn(last.shape, generator=noise, device=device))
        toks, lgs = [first_token(logits)], []
        for _ in range(steps):
            lg, cache = model.decode(params, cache, {"tokens": toks[-1]})
            toks.append(lg.argmax(dim=-1))
            lgs.append(lg.float())
        runs.append((torch.cat(toks, dim=1), torch.cat(lgs, dim=1)))
    (tok_a, lg_a), (tok_b, lg_b), (tok_c, lg_c) = runs
    _check(bool(torch.isfinite(lg_a).all() and torch.isfinite(lg_b).all()),
           "non-finite decode logits")
    return {"logits_max_abs_diff": float((lg_a - lg_b).abs().max()),
            "max_abs_logit": float(lg_a.abs().max()),
            "tokens_differ": int((tok_a != tok_b).sum()), "tokens": tok_a.numel(),
            "masked_slot_inert": torch.equal(tok_b, tok_c) and torch.equal(lg_b, lg_c)}


def train_workflow(cfg, *, device: str, batch: int, seq_len: int, steps: int,
                   phases: int, ckpt_dir) -> dict:
    """The train twin (f32 params, bf16 compute), with the counts set to 0
    just before it and read just after."""
    import torch
    from repro_torch.examples import workflow_train
    from repro_torch.kernels import ops
    from repro_torch.models import RunConfig

    rc = RunConfig(param_dtype=torch.float32, compute_dtype=torch.bfloat16, device=device)
    ops.attention.launches = ops.ssd.launches = 0
    out = workflow_train.run(cfg, steps=steps, phases=phases, batch=batch, seq=seq_len,
                             rc=rc, ckpt_dir=ckpt_dir)
    out["launches"] = _launches()
    return out


def matmul_bound_s(n: int, iters: int) -> float:
    """The least time of ``matmul_payload(n, iters)``'s products on an H100:
    2 n^3 FLOPs a step at the f32 peak outside the tensor cores (the
    elementwise work and the host-to-device copy of x are left out)."""
    return iters * 2 * n ** 3 / PEAK_FLOP_PER_S["float32"]


def matmul_diamond(*, device: str, n: int, iters: int) -> dict:
    """A diamond DAG (0 -> 1, 2 -> 3) of ``matmul_payload`` pods under the
    engine with ``payload_mode="real"``: each pod's seconds (its virtual
    run time is its wall time) and output."""
    from repro_torch.core.dag import Task, Workflow
    from repro_torch.core.payloads import matmul_payload
    from repro_torch.core.runner import ControlPlane

    mm = matmul_payload(n=n, iters=iters, device=device)
    outs = {}

    def pod(volume, task):
        mm(volume, task)
        outs[task.id] = volume.get(f"{task.id}/out")
    edges = {"0": ([], ["1", "2"]), "1": (["0"], ["3"]), "2": (["0"], ["3"]),
             "3": (["1", "2"], [])}
    wf = Workflow("diamond", {tid: Task(id=tid, inputs=i, outputs=o, payload=pod)
                              for tid, (i, o) in edges.items()})
    plane = ControlPlane("kubeadaptor", payload_mode="real", seed=SEED)
    plane.gateway.load([wf.with_instance(0)])
    res = plane.run()
    seconds = {p.task_id: p.finished - p.started for p in res.cluster.pod_log
               if p.task_id in edges}
    return {"pod_seconds": seconds, "outputs": outs,
            "order_consistent": res.metrics.order_consistent(wf.with_instance(0))}


# ---------------------------------------------------------------------------
def _phase_done(n: int, t0: float, what: str = "") -> float:
    """Print phase ``n``'s seconds since ``t0``; return the time now."""
    now = time.perf_counter()
    print(f"[{n}] {what + ' ' if what else ''}phase took {now - t0:.1f} s", flush=True)
    return now


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    # 1. device and build
    t_phase = time.perf_counter()
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
    t_phase = _phase_done(1, t_phase)

    # 2. K1 and K2 against their plain versions, and their times
    print("[2] K1 against its plain version", flush=True)
    k1 = check_k1(torch.Generator(device="cuda").manual_seed(SEED))
    print("[2] K2 against its plain versions", flush=True)
    k2 = check_k2(torch.Generator(device="cuda").manual_seed(SEED))
    t_phase = _phase_done(2, t_phase)

    # 3 and 4, for each model: serve at full width and depth in bf16, then f32
    # consistency
    served, serve_ms = {}, {}
    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        res = serve(cfg, device="cuda", batch=SERVE_BATCH, prompt_len=PROMPT_LEN,
                    decode_steps=DECODE_STEPS)
        print(f"[3] {arch} ({cfg.n_layers} layers): served {SERVE_BATCH} requests of "
              f"{PROMPT_LEN} tokens + {DECODE_STEPS} decode steps: prefill "
              f"{res['prefill_ms']:.3f} ms, decode {res['decode_ms_per_step']:.3f} ms/step, "
              f"{res['tokens_per_s']:.1f} generated tokens/s, "
              f"max_memory_allocated {res['max_memory_allocated']} B; launches: "
              f"prefill {res['prefill_launches']}, request {res['request_launches']}",
              flush=True)
        expect = expected_launches(cfg)
        _check(res["prefill_launches"] == expect,
               f"{arch} prefill launched {res['prefill_launches']}, not {expect}")
        _check(res["request_launches"] == expect,
               f"{arch} request launched {res['request_launches']}, not {expect}")
        served[arch] = res["prefill_launches"]
        serve_ms[arch] = (res["prefill_ms"], res["decode_ms_per_step"])
        del res
        torch.cuda.empty_cache()             # the bf16 model is gone before [4]
        t_phase = _phase_done(3, t_phase, arch)

        layers = CONSISTENCY_LAYERS.get(arch, cfg.n_layers)
        cut = (f" cut to {layers} layers (full widths; its f32 params at full depth "
               f"alone are {cfg.param_count() * 4 / 1e9:.1f} GB)"
               if layers != cfg.n_layers else "")
        errs = consistency(dataclasses.replace(cfg, n_layers=layers), device="cuda",
                           prefill_batch=SERVE_BATCH, prefill_len=PROMPT_LEN, batch=2,
                           seq_len=96, split=32)
        print(f"[4] {arch}{cut}: f32 consistency: {json.dumps(errs)}", flush=True)
        _check(errs["prefill_kernels_vs_plain"] <= PREFILL_PLAIN_TOL,
               f"{arch} prefill kernels vs plain {errs['prefill_kernels_vs_plain']} "
               f"> {PREFILL_PLAIN_TOL}")
        _check(errs["prefill_decode_vs_forward"] <= DECODE_TOL,
               f"{arch} prefill+decode vs forward {errs['prefill_decode_vs_forward']} "
               f"> {DECODE_TOL}")
        torch.cuda.empty_cache()
        t_phase = _phase_done(4, t_phase, arch)

    # 5. training: K1 under a gradient, full-width steps, resume, f32 kernels vs plain
    print("[5] K1 under a gradient against its plain version's autograd", flush=True)
    k1_grad = check_k1_grad(torch.Generator(device="cuda").manual_seed(SEED))
    cfg = get_config(ARCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        res = train(cfg, device="cuda", batch=TRAIN_BATCH, seq_len=TRAIN_LEN,
                    steps=TRAIN_STEPS, resume_after=RESUME_AFTER, ckpt_dir=ckpt_dir)
    for i, (met, ms, la) in enumerate(zip(res["metrics"], res["step_ms"],
                                          res["launches_per_step"]), 1):
        print(f"[5] {ARCH} train step {i}: loss {met['loss']:.6f} grad_norm "
              f"{met['grad_norm']:.6f} lr {met['lr']:.6e}, {ms:.3f} ms, launches {la}",
              flush=True)
    print(f"[5] {ARCH}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_LEN} tokens: "
          f"median step (2-{TRAIN_STEPS}) {res['median_step_ms']:.3f} ms, "
          f"{res['tokens_per_s']:.1f} trained tokens/s, max_memory_allocated "
          f"{res['max_memory_allocated']} B; checkpoint save {res['save_s']:.2f} s, "
          f"restore {res['restore_s']:.2f} s; resume errors: loss "
          f"{res['resume_loss_err']:.3e}, params {res['resume_params_err']:.3e}", flush=True)
    losses = [m["loss"] for m in res["metrics"]]
    _check(all(np.isfinite([m["loss"] for m in res["metrics"]]))
           and all(np.isfinite([m["grad_norm"] for m in res["metrics"]])),
           "non-finite loss or grad norm")
    _check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    per_step = {"attention": cfg.n_layers, "ssd": 0}
    _check(all(la == per_step for la in res["launches_per_step"]),
           f"train steps launched {res['launches_per_step']}, not {per_step} each")
    _check(res["launches"] == {k: n * TRAIN_STEPS for k, n in per_step.items()},
           f"the train run launched {res['launches']}")
    _check(res["resume_loss_err"] <= RESUME_TOL and res["resume_params_err"] <= RESUME_TOL,
           f"step {RESUME_AFTER + 1} from the checkpoint differs: loss "
           f"{res['resume_loss_err']}, params {res['resume_params_err']} > {RESUME_TOL}")
    torch.cuda.empty_cache()
    errs = train_consistency(dataclasses.replace(cfg, n_layers=TRAIN_PLAIN_LAYERS),
                             device="cuda", batch=TRAIN_BATCH, seq_len=TRAIN_LEN)
    print(f"[5] {ARCH} cut to {TRAIN_PLAIN_LAYERS} layers: f32 train step, kernels vs "
          f"plain: {json.dumps(errs)}", flush=True)
    _check(errs["loss_rel"] <= TRAIN_PLAIN_TOL and errs["grad_norm_rel"] <= TRAIN_PLAIN_TOL
           and errs["params_abs"] <= TRAIN_PLAIN_TOL
           and max(errs["grads_rel"].values()) <= TRAIN_PLAIN_TOL,
           f"f32 train step, kernels vs plain, exceeds {TRAIN_PLAIN_TOL}: {errs}")
    _check(all(errs["grads_scale"][f"blocks/attn/{w}"] > 0 for w in ("wq", "wk", "wv")),
           f"zero q/k/v projection gradient: {errs['grads_scale']}")
    torch.cuda.empty_cache()
    t_phase = _phase_done(5, t_phase)

    # 6. the workflows: the port's KubeAdaptor engine running the pods
    wf = serve_workflow(cfg, device="cuda", batch=SERVE_BATCH, prompt_len=PROMPT_LEN,
                        gen=WF_GEN)
    print(f"[6] {ARCH} serve workflow (plain loop, then prefill pod -> decode pod; "
          f"{SERVE_BATCH} x {PROMPT_LEN} tokens, cache grown by {WF_GEN}, {WF_GEN - 1} "
          f"decode steps, bf16): tokens bit-equal to the plain loop's "
          f"({wf['tokens'].numel()} tokens); plain loop {wf['plain_seconds']:.3f} s; "
          f"pod seconds {json.dumps(wf['pod_seconds'])} ([3]: prefill "
          f"{serve_ms[ARCH][0]:.3f} ms, decode {serve_ms[ARCH][1]:.3f} ms/step); K1 "
          f"launches by pod {wf['k1_launches']}, whole run {wf['launches']}; virtual "
          f"lifecycle {wf['lifecycle']:.3f} s; order_consistent={wf['order_consistent']}",
          flush=True)
    _check(torch.equal(wf["tokens"], wf["plain_tokens"]), "workflow tokens differ")
    _check(wf["order_consistent"], "the serve workflow ran out of order")
    _check(wf["k1_launches"] == {"prefill": cfg.n_layers, "decode": 0},
           f"serve workflow K1 launches by pod {wf['k1_launches']}")
    _check(wf["launches"] == {"attention": 2 * cfg.n_layers, "ssd": 0},
           f"serve workflow launched {wf['launches']}")
    serve_pod_launches = wf.pop("k1_launches")
    del wf
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, n_layers=CACHE_LEN_LAYERS)
    cl32 = cache_length(cut, device="cuda", dtype=torch.float32, batch=SERVE_BATCH,
                        prompt_len=PROMPT_LEN, steps=WF_GEN - 1)
    cl16 = cache_length(cfg, device="cuda", dtype=torch.bfloat16, batch=SERVE_BATCH,
                        prompt_len=PROMPT_LEN, steps=WF_GEN - 1)
    print(f"[6] cache grown by {WF_GEN - 1} vs {WF_GEN} slots, {WF_GEN - 1} greedy steps: "
          f"f32 ({CACHE_LEN_LAYERS} layers, full widths): logits max abs diff "
          f"{cl32['logits_max_abs_diff']:.3e} (tol {CACHE_LEN_TOL:g}, max |logit| "
          f"{cl32['max_abs_logit']:.3g}), {cl32['tokens_differ']} of {cl32['tokens']} "
          f"tokens differ; bf16 ({cfg.n_layers} layers, measured, not a check): "
          f"{cl16['tokens_differ']} of {cl16['tokens']} tokens differ, logits max abs "
          f"diff {cl16['logits_max_abs_diff']:.3e}; the never-written slot filled with "
          f"noise: logits and tokens bit-equal in f32 {cl32['masked_slot_inert']}, in bf16 "
          f"{cl16['masked_slot_inert']}", flush=True)
    _check(cl32["logits_max_abs_diff"] <= CACHE_LEN_TOL and cl32["tokens_differ"] == 0,
           f"f32 decode depends on the cache length: {cl32}")
    _check(cl32["masked_slot_inert"] and cl16["masked_slot_inert"],
           "a masked cache slot changes the decode")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wf_") as ckpt_dir:
        tw = train_workflow(cfg, device="cuda", batch=TRAIN_BATCH, seq_len=TRAIN_LEN,
                            steps=WF_TRAIN_STEPS, phases=WF_TRAIN_PHASES, ckpt_dir=ckpt_dir)
    print(f"[6] {ARCH} train workflow (data_prep -> {WF_TRAIN_PHASES} phases of "
          f"{WF_TRAIN_STEPS // WF_TRAIN_PHASES} steps, {TRAIN_BATCH} x {TRAIN_LEN} tokens, "
          f"a failure on phase_2 at t={tw['failed_at'][0]:.3f} s -> eval): losses "
          f"{tw['losses']}, eval loss {tw['eval_loss']:.6f}, retries {tw['retries']}, "
          f"latest step {tw['latest_step']}, K1 launches per step {tw['step_k1_launches']}, "
          f"by pod run {json.dumps(tw['pod_k1_launches'])}, whole run {tw['launches']}; "
          f"pod seconds {json.dumps(tw['pod_seconds'])}; virtual lifecycle "
          f"{tw['lifecycle']:.3f} s; order_consistent={tw['order_consistent']}", flush=True)
    _check(tw["retries"] == 1 and tw["order_consistent"], f"train workflow: {tw['retries']} "
           f"retries, order_consistent={tw['order_consistent']}")
    _check(tw["losses"][-1] < tw["losses"][0] and all(np.isfinite(tw["losses"]))
           and np.isfinite(tw["eval_loss"]), f"train workflow losses {tw['losses']}")
    _check(tw["latest_step"] == WF_TRAIN_STEPS and len(tw["losses"]) == WF_TRAIN_STEPS,
           f"latest step {tw['latest_step']}, {len(tw['losses'])} losses")
    _check(tw["step_k1_launches"] == [cfg.n_layers] * WF_TRAIN_STEPS
           and tw["pod_k1_launches"]["eval"] == [cfg.n_layers],
           f"train workflow K1 launches {tw['step_k1_launches']}, {tw['pod_k1_launches']}")
    _check(tw["launches"] == {"attention": (WF_TRAIN_STEPS + 1) * cfg.n_layers, "ssd": 0},
           f"train workflow launched {tw['launches']}")
    torch.cuda.empty_cache()
    mm = matmul_diamond(device="cuda", n=MATMUL_N, iters=MATMUL_ITERS)
    bound_s = matmul_bound_s(MATMUL_N, MATMUL_ITERS)
    print(f"[6] diamond of matmul_payload(n={MATMUL_N}, iters={MATMUL_ITERS}) pods: pod "
          f"seconds {json.dumps(mm['pod_seconds'])}, f32-peak bound {bound_s:.6f} s a pod "
          f"(the products alone); y[0, :4] {mm['outputs']['0'].tolist()}; "
          f"order_consistent={mm['order_consistent']}", flush=True)
    _check(mm["order_consistent"] and sorted(mm["pod_seconds"]) == ["0", "1", "2", "3"],
           f"matmul diamond: {mm['pod_seconds']}")
    _check(all(np.isfinite(y).all() and np.array_equal(y, mm["outputs"]["0"])
               for y in mm["outputs"].values()), f"matmul pods' outputs {mm['outputs']}")
    _phase_done(6, t_phase)

    # 7. results; the ok line is last
    # launches: the sum over the served models' timed prefills (each counted
    # from 0), and per model
    for entry, kernel in ((k1, "attention"), (k2, "ssd")):
        entry["launches_by_arch"] = {arch: n[kernel] for arch, n in served.items()}
        entry["launches"] = sum(entry["launches_by_arch"].values())
    k1["train_launches_per_step"] = res["launches_per_step"][0]["attention"]
    k1.update({f"train_{key}": val for key, val in k1_grad.items()})
    k1["workflow_serve_launches_by_pod"] = serve_pod_launches
    k1["workflow_train_launches_per_step"] = tw["step_k1_launches"][0]
    k1["workflow_eval_launches"] = tw["pod_k1_launches"]["eval"][0]
    print(json.dumps({"kernels": [k1, k2]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
