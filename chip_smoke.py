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
   not, bf16 and f32), qwen2-1.5b (H=12 over K=2, hd=128),
   zamba2-1.2b's shared block (H=K=32, hd=64),
   gemma-7b (H=K=16, hd=256; causal and not, bf16 and f32),
   qwen2-moe-a2.7b (H=K=16, hd=128), musicgen-medium (H=K=24, hd=64),
   llama-3.2-vision-11b (H=32 over K=8, hd=128), deepseek-67b (H=64
   over K=8: GQA group 8) and llama4-scout-17b-a16e (H=40 over K=8:
   group 5, hd=128), and the vlm's
   cross-attention (not causal over T=1601 image keys, at S=512 in the
   prefill and S=1 in each decode step); at K = H
   and K = 1, at a ragged S and T (also at hd 256 with GQA) and at
   head_dim 32 and 128. Each of the nine prefill shapes and the two
   cross shapes is timed with
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
   call computes it). Each kernel launches through its operator
   (``repro_torch::k1_fwd`` / ``k2_fwd``, which ``ops`` reaches through
   the autograd Functions); at qwen2-0.5b's and mamba2-2.7b's prefill
   shapes the launcher alone is timed beside it, queued and host-paced.
3. Serve: full-width qwen2-0.5b, qwen2-1.5b, mamba2-2.7b, zamba2-1.2b (hybrid: 38
   Mamba2 layers and one shared attention block applied after every
   6th), gemma-7b (head_dim 256), qwen2-moe-a2.7b (60 routed experts
   top-4, padded to 64, and 4 shared), musicgen-medium (frame
   embeddings in place of tokens) and llama-3.2-vision-11b (a gated
   cross-attention block over 1601 image tokens after every 5th layer,
   its gates set to ``CROSS_GATE``), each at full depth, and
   deepseek-67b and llama4-scout-17b-a16e (16 routed experts top-1 and a
   shared one) cut to 40 of 95 and 12 of 48 layers (``SERVE_LAYERS``:
   58.7 and 57.0 GB of bf16 params), in bf16 with
   seeded random weights, built through ``runtime.serve``, each
   answering 8 requests of 512-token prompts (``make_request``: tokens;
   for audio seeded frames, one more per decode step; for vision tokens
   and seeded image embeddings): one prefill, then greedy
   decode steps (64 each). The counts are set to 0 before each model's
   timed request; its prefill must launch K1 and K2 exactly
   ``expected_launches(cfg)`` times (K1 once per attention layer, cross
   block or shared-block application, K2 once per Mamba2 layer) and
   each decode step ``expected_decode_launches(cfg)`` (K1 once per
   cross block, else neither).
4. Consistency in f32 with TF32 off, for each model at full width (and
   full depth, but gemma-7b, qwen2-moe-a2.7b and deepseek-67b cut to 4
   layers, llama4-scout-17b-a16e to 2 and llama-3.2-vision-11b to 10,
   two cross blocks: their f32 params at full depth are 34.2, 60.6,
   269.7, 431.1 and 40.4 GB): prefill logits with the kernels against
   the same prefill with their plain versions (for the MoE on the
   requests routed alike in both, the count of differing top-k choices
   printed), and prefill(inputs[:k]) + decode(inputs[k:]) against
   forward(inputs) (the MoE at capacity factor 16, drop-free).
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
   step and in the eval forward, the order consistent). Then a diamond
   of four ``matmul_payload(n=8192, iters=4)`` pods, their seconds
   beside the f32-peak bound. The host-only twins of
   ``examples/quickstart.py`` and ``examples/multi_workflow.py`` run in
   this process (their order-consistency lines and ``OK`` checked, no
   launch, no card memory). Last, a 2-shard ``ShardedControlPlane``
   (``core/shard.py``), one diamond of those pods per tenant
   (``SHARD_TENANTS``, one a shard): inline (``processes=False``) with
   ``payload_mode="real"`` every workflow completes in order, each
   shard's pods allocate their matrices on the card and write the
   unsharded diamond's output bit for bit; the plane with virtual
   payloads in forked workers (``processes=True``) merges to the inline
   run's tenant summary; and forked workers given the card's payloads
   fail as a ``ShardFailure`` naming CUDA within ``SHARD_TIMEOUT_S``: a
   child forked after the parent initialised CUDA cannot use it.
7. Train the ssm and hybrid families, and remat, each part with the
   counts set to 0 first. (a) K2 under a gradient (``SSDScanFn``: K2
   forward, the autograd of ``ssd_chunked`` as backward) at the train
   shapes of zamba2-1.2b and mamba2-2.7b (B=8, S=512, chunk 32), bf16
   and f32, with and without an initial state: every gradient against
   autograd through ``ssd_chunked`` on the same tensors (1e-6 of its
   largest value), and at b=2, s=64 against autograd through
   ``ref.ssd_ref`` (f32 2e-3, bf16 5e-2); one K2 launch a forward, none
   in the backward; the forward's ms at chunk 32 beside its bound and
   the backward's ms a layer. (b) 8 AdamW steps of full-width,
   full-depth zamba2-1.2b (f32 params, bf16 compute,
   ``RunConfig(remat=True, remat_policy="full", ssd_chunk=32)``) on
   8 x 512-token batches: a falling, finite loss and
   ``expected_train_launches`` a step (K1 6: the shared block is not
   rematted; K2 76: the forward and the backward's recompute); peak
   learning rate 1e-4 (at phase 5's 3e-4 the Mamba2 losses jump at step
   3 with the plain versions as with the kernels:
   ``scripts/probe_train_lr.py``). (c) 4
   steps of mamba2-2.7b at full width cut to 16 of its 64 layers (its
   f32 train state at full depth, 79 GB, does not fit beside the
   activations): K2 32 a step. (d) 4 steps of full-width, full-depth
   qwen2-1.5b under remat: K1 56 a step. Each prints its median step
   ms, trained tokens/s and peak memory. (e) An f32 step of zamba2-1.2b
   at full width cut to 6 layers (one full segment, so one shared-block
   application) with the kernels against the same step with their plain
   versions, at phase 5's bounds, the Mamba2 projections', A_log's and
   the shared block's q/k/v gradients non-zero. (f) On the same cut,
   remat off, "full" and "dots" agree: losses within 1e-6 relative,
   every gradient leaf within 1e-5 of its largest value (the
   embedding's scatter-add is not deterministic); each one's peak
   memory is printed.
8. Train the moe, audio and vlm families, each part with the counts set
   to 0 first. (a) K1 under a gradient at the vlm's cross-attention
   shape (B=8, S=512 queries over T=1601 image keys, H=32 over K=8, hd
   128, not causal; bf16 and f32) against autograd through the plain
   version (``K1_GRAD_TOL``), with the backward's ms (``ref.
   attention_bwd``) beside its bound and SDPA forward + backward. (b)-(d)
   4 AdamW steps each of full-width qwen2-moe-a2.7b cut to 2 of its 24
   layers, musicgen-medium at full depth and llama-3.2-vision-11b cut to
   one full segment (5 self-attention layers and 1 cross block), under
   phase 7's settings (remat "full"; peak lr ``TRAIN_8_LR``: 3e-5, 1e-4
   and 1e-5, the widest model the lowest), on
   ``SyntheticLM`` batches with their frontend's inputs (frame
   embeddings; image embeddings) and the vlm's gates at ``CROSS_GATE``:
   the f32 train state at 28 bytes a parameter sets the cuts (424 GB and
   283 GB at full depth). A falling, finite loss and
   ``expected_train_launches`` a step: K1 4, 96 and 11 (2 per rematted
   self-attention layer, 1 per cross block, which is not rematted).
   Each prints its median step ms, trained tokens/s and peak memory.
   (e)-(g) f32 forward + backward (``value_and_grad`` of ``Model.loss``,
   no step: about 12 bytes a parameter) with the kernels against the
   same with their plain versions, from one state and one batch, at
   qwen2-moe 2 layers, musicgen cut to 8 and the vlm at 5 + 1: loss
   within 1e-4 relative and every gradient leaf within 1e-4 of its plain
   leaf's largest value (``TRAIN_PLAIN_TOL``). The MoE's routing is
   recorded in both runs: routed alike, the bound holds on every leaf; a
   flipped choice whose two candidates' probabilities lie within
   ``NEAR_TIE`` of each other is a near-tie, counted, and the bound then
   holds on the leaves outside ``blocks/moe``; any other flip fails.
9. Train gemma-7b (GeGLU, scaled and tied embeddings, hd 256), each
   part with the counts set to 0 first. (a) K1 under a gradient at its
   shape (B=8, S=512, H=K=16, hd 256, causal; bf16 and f32) against
   autograd through the plain version (``K1_GRAD_TOL``), the backward's
   ms beside its bound and SDPA forward + backward. (b) 4 AdamW steps at
   full width cut to 4 of its 28 layers (53.0 GB of f32 train state at
   28 bytes a parameter; 5 layers would be 60.8 GB beside the tied
   256,000-row embedding's logits and gradient), under phase 7's
   settings at peak lr ``TRAIN_9_LR``: a falling, finite loss and 8 K1
   launches a step; its median step ms, trained tokens/s and peak
   memory. (c) f32 forward + backward at 2 layers, kernels vs plain:
   loss and every gradient leaf (the tied ``embed`` one leaf) within
   ``TRAIN_PLAIN_TOL``, the attention, GeGLU and embedding leaves
   non-zero.
10. The mesh paths on one card. (a) K1 at a query offset, at qwen2-0.5b's
   prefill shape in bf16 and f32: the queries cut into tp in
   ``OFFSET_TPS`` row blocks, each run at ``q_offset = r * S / tp``
   against the full k/v (what each rank of a "seq" mesh runs), held
   against the plain version at that offset (``K1_TOL``), the blocks
   together against the unsharded K1 (``OFFSET_WHOLE_TOL``, and whether
   bit-equal), and the ``OFFSET_TIMED`` block (128 rows at offset 384)
   under a gradient against autograd through the plain version
   (``K1_GRAD_TOL``) and timed beside its bound (this offset's live keys)
   and SDPA with an explicit boolean mask. Then a world of one NCCL rank
   and a (data=1, model=1) ``DeviceMesh`` over the card
   (``init_world_of_one``), made only here, after phase 6's forks, and
   destroyed at the phase's end. (b) 8 AdamW steps of qwen2-0.5b through
   ``build_train_step(cfg, mesh)`` on phase 5's seeded state (distributed
   into the shardings) and batches (``shard_batch``): losses within
   ``MESH_STEP_TOL`` of phase 5's (whether bit-equal is printed), 24 K1
   launches a step, the loss on the vocab-sharded CE once a step
   (``count_sharded_ce``: the logits are ``Shard`` on the model dim of
   size 1, so the CE's all-reduces run over NCCL groups of one), the
   median step ms beside phase 5's and the peak memory. (c) Phase 3's
   qwen2-0.5b request through the mesh's ``build_prefill_step`` /
   ``build_decode_step``: the same greedy tokens,
   24 K1 launches a prefill, none a decode step. (d) ``ElasticRunner`` at
   world size 1 (no mesh, as in the JAX package): 10 steps checkpointed
   every 5, then a new runner on the same directory restores step 10 and
   takes 2 more with finite losses; that checkpoint restored into the
   (1, 1) mesh's placements (``restore(shardings=)``) is bit-equal to a
   plain restore. (e) zamba2-1.2b (full width and depth) served on the
   mesh: {6 K1, 38 K2} a prefill, as without it, and [3]'s tokens. (f)
   qwen2-moe-a2.7b, musicgen-medium and llama-3.2-vision-11b served on the
   mesh at full width and depth, [3]'s request: ``expected_launches`` and
   [3]'s tokens. (g) zamba2-1.2b's 8 train
   steps on the mesh under [7]'s settings: losses within
   ``MESH_STEP_TOL`` of [7] (b)'s (bit-equal printed), {6, 76} launches a
   step, the vocab-sharded CE once a step; then K2 as each rank of a
   model=4 mesh runs it on its local heads (mamba2-2.7b 80 -> 20,
   zamba2-1.2b 64 -> 16), bit-equal to those
   heads of the whole call in bf16 and f32, timed beside its bound.
11. The dry run (``python -m repro_torch.launch.dryrun`` in a
   subprocess, ``fake`` backend, 256 ranks, meta tensors): qwen2-0.5b
   ``train_4k`` at full depth and ``prefill_32k`` of each other family
   at one segment; per device FLOPs, collective and argument bytes and
   the roofline terms (arithmetic on data-sheet peaks); an erring cell
   fails the run. The full-depth cell's temporaries a device are printed
   beside JAX's (``JAX_DRYRUN_FULL_TEMP_BYTES``, compiled on a CPU) with
   the storages that hold its peak, and its arguments + temp must fit
   ``DRYRUN_DEVICE_BYTES``. llama4-scout-17b-a16e ``train_4k`` cut to 2
   layers at the full model's grad_accum 16 on 2x16x16 (``DRYRUN_MULTI_POD``:
   FLOPs and temp a device at most JAX's of the same cut) and on 16x16
   (``DRYRUN_SCOUT_CUT``: FLOPs), and llama4-scout-17b-a16e ``train_4k``
   at full depth on both meshes (``DRYRUN_SCOUT_FULL``: temp a device at
   most JAX's, ``JAX_DRYRUN_SCOUT_FULL_TEMP_BYTES``); no train cell's
   gradient may leave ``autograd.grad`` larger than its param's shard (each
   cell's ``grad_shards``). The traces start in the background, niced and
   without the card, right after [1], and [11] waits for them.
12. A ``{"kernels": [...]}`` line (each kernel's ``launches`` is the sum
   over the served models' prefills, ``launches_by_arch`` per model,
   ``decode_launches_per_step_by_arch`` where a decode step launches it,
   ``at`` its numbers at each model's prefill shape (K1's also at the
   vlm's cross shapes, and under a gradient at the cross prefill shape
   and at gemma-7b's, and at the q offset of phase 10),
   and K2's at its train shapes; ``train_launches_per_step_by_arch`` per
   trained model; K1's also per workflow pod and on the mesh path, by
   arch; K2's on the mesh path and at a model=4 rank's local heads), the
   ``nvidia-smi`` line,
   and last the ``{"ok": true, "device": ...}`` line.

It needs CUDA: without a card it exits with code 2 before doing anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
ARCH = "qwen2-0.5b"               # the trained model, and K1's first timed shape
SSM_ARCH = "mamba2-2.7b"          # K2's first timed shape
SERVE_ARCHS = ("qwen2-0.5b", "qwen2-1.5b", "mamba2-2.7b", "zamba2-1.2b", "gemma-7b",
               "qwen2-moe-a2.7b", "musicgen-medium", "llama-3.2-vision-11b",
               "deepseek-67b", "llama4-scout-17b-a16e")
# depth cuts of phase 3 (full widths; the others serve at full depth): the
# bf16 params must fit the card's 80 GB beside the stacking of the largest
# leaf at init. deepseek-67b: 0.692 B a layer + 1.678 B of untied embedding
# and head, 58.7 GB at 40 of 95 layers (134.9 GB at full depth);
# llama4-scout-17b-a16e: 2.202 B a layer (16 experts) + 2.069 B, 57.0 GB at
# 12 of 48 layers (215.6 GB)
SERVE_LAYERS = {"deepseek-67b": 40, "llama4-scout-17b-a16e": 12}
# depth cuts of phase 4 (full widths): the f32 params at full depth are too
# large (gemma-7b 34 GB, qwen2-moe-a2.7b 60.6 GB); the vlm keeps two cross
# blocks; deepseek-67b at 4 layers 17.8 GB, llama4-scout-17b-a16e at 2 25.9 GB
CONSISTENCY_LAYERS = {"gemma-7b": 4, "qwen2-moe-a2.7b": 4, "llama-3.2-vision-11b": 10,
                      "deepseek-67b": 4, "llama4-scout-17b-a16e": 2}
# the bf16 causal prefill shape each model hands a kernel: K1 (B, S, T, H, K, hd),
# K2 (b, s, h, p, n, chunk)
K1_SHAPES = {"qwen2-0.5b": (8, 512, 512, 14, 2, 64),
             "qwen2-1.5b": (8, 512, 512, 12, 2, 128),
             "zamba2-1.2b": (8, 512, 512, 32, 32, 64),
             "gemma-7b": (8, 512, 512, 16, 16, 256),
             "qwen2-moe-a2.7b": (8, 512, 512, 16, 16, 128),
             "musicgen-medium": (8, 512, 512, 24, 24, 64),
             "llama-3.2-vision-11b": (8, 512, 512, 32, 8, 128),
             "deepseek-67b": (8, 512, 512, 64, 8, 128),              # GQA group 8
             "llama4-scout-17b-a16e": (8, 512, 512, 40, 8, 128)}     # GQA group 5
# the vlm's cross-attention, not causal over its n_img_tokens = 1601 image
# keys: in the prefill (S = 512) and in each decode step (S = 1)
K1_CROSS_SHAPES = {"llama-3.2-vision-11b cross, prefill": (8, 512, 1601, 32, 8, 128),
                   "llama-3.2-vision-11b cross, decode": (8, 1, 1601, 32, 8, 128)}
K2_SHAPES = {"mamba2-2.7b": (8, 512, 80, 64, 128, 128),
             "zamba2-1.2b": (8, 512, 64, 64, 64, 128)}
SERVE_BATCH, PROMPT_LEN, DECODE_STEPS = 8, 512, 64
K1_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
K2_REF_TOL = {"float32": 2e-3, "bfloat16": 5e-2}   # K2 vs ssd_ref (the JAX kernel test's)
K2_CHUNKED_TOL = 2e-4             # f32 K2 vs ssd_chunked (the JAX production-path test's)
PREFILL_PLAIN_TOL = 1e-3          # f32 prefill logits, kernels vs their plain versions
DECODE_TOL = 2e-3                 # f32 prefill + decode vs forward
# "decode equals forward" holds for a MoE only without capacity drops, which
# depend on the batch: the check runs at the reference test's capacity factor
# (tests/test_serving.py), where no expert of any group can overflow
DECODE_MOE_CAPACITY = 16.0
CROSS_GATE = 1.0                  # the vlm's cross-block gates: tanh(0) = 0 would hide them
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
SHARD_TENANTS = ("batch-a", "prod-a")   # shard_of: 0 and 1 of 2 (crc32)
SHARD_TIMEOUT_S = 120.0           # the sharded plane's join deadline
# phase 7: the ssm and hybrid families' training, and remat
SSD_TRAIN_CHUNK = 32              # the reference's train cells' chunk (launch/dryrun.py)
K2_TRAIN_SHAPES = {arch: shape[:5] + (SSD_TRAIN_CHUNK,) for arch, shape in K2_SHAPES.items()}
K2_GRAD_TOL = 1e-6                # SSDScanFn's gradients vs autograd through ssd_chunked
K2_GRAD_REF_TOL = {"float32": 2e-3, "bfloat16": 5e-2}   # vs autograd through ssd_ref
HYBRID_ARCH, SSM_TRAIN_LAYERS = "zamba2-1.2b", 16
DENSE_REMAT_ARCH = "qwen2-1.5b"
SSM_TRAIN_STEPS, DENSE_REMAT_STEPS = 4, 4
# phase 7's peak learning rate: at phase 5's 3e-4 the loss of mamba2-2.7b
# (16 layers) jumps at step 3 with the kernels and with their plain
# versions alike (scripts/probe_train_lr.py --plain): Adam's step, not a kernel
TRAIN_7_LR = 1e-4
HYBRID_PLAIN_LAYERS = 6           # one full segment of attn_every = 6: one K1 application
REMAT_LOSS_TOL, REMAT_GRAD_TOL = 1e-6, 1e-5
# phase 8: the moe, audio and vlm families' training. Depth cuts (full widths;
# None: full depth): the f32 train state at 28 bytes a parameter must fit the
# card's 80 GB, qwen2-moe-a2.7b at 2 layers ~51 GB (3: ~68), the vlm at one
# full segment of 5 self-attention layers + 1 cross block ~61 GB (10 + 2: ~93)
TRAIN_8_LAYERS = {"qwen2-moe-a2.7b": 2, "musicgen-medium": None, "llama-3.2-vision-11b": 5}
TRAIN_8_STEPS = 4
# phase 8's peak learning rates: Adam's first steps move every weight by about
# the learning rate, which widens with d_model; llama-3.2-vision-11b (d 4096)
# diverges at 1e-4 and 3e-5 and qwen2-moe-a2.7b (d 2048) jumps at 1e-4, with
# the plain versions as with the kernels (scripts/probe_train_lr.py --plain)
TRAIN_8_LR = {"qwen2-moe-a2.7b": 3e-5, "musicgen-medium": TRAIN_7_LR,
              "llama-3.2-vision-11b": 1e-5}
# depths of the f32 forward + backward, kernels vs plain (about 12 B a parameter)
TRAIN_8_PLAIN_LAYERS = {"qwen2-moe-a2.7b": 2, "musicgen-medium": 8, "llama-3.2-vision-11b": 5}
NEAR_TIE = 1e-5                   # a flipped top-k choice between probabilities this close
K1_CROSS_TRAIN = "llama-3.2-vision-11b cross, prefill"   # K1 under a gradient at this shape
# phase 9: gemma-7b's training (GeGLU, scaled and tied embeddings, hd 256).
# Depth cut (full widths): its f32 train state at 28 bytes a parameter is
# 239 GB at 28 layers; 4 layers hold 1.894 B parameters, 53.0 GB, and 5
# 2.171 B, 60.8 GB, the vlm cut's 61.1 GB, which peaked at 71.9 GB; gemma's
# 256,000-row tied embedding adds 8 x 512 x 256,000 logits (2.1 GB in bf16,
# 4.2 GB a pass in f32) and an embedding gradient from the input and the
# head, so 4 layers leave the room 5 would not
GEMMA_ARCH, TRAIN_9_LAYERS, TRAIN_9_STEPS = "gemma-7b", 4, 4
TRAIN_9_PLAIN_LAYERS = 2          # the f32 forward + backward, kernels vs plain
# phase 9's peak learning rate: at 1e-4, 3e-5 and 1e-5 the 4-layer cut's loss
# fell every step from 46.82, to 17.54, 28.11 and 37.93 in 4 steps, with the
# plain versions step for step alike (scripts/probe_train_lr.py --plain), so
# phase 7's rate, the fastest of the three, and no divergence to avoid
TRAIN_9_LR = TRAIN_7_LR
K1_GEMMA_TRAIN = K1_SHAPES[GEMMA_ARCH]                 # K1 under a gradient at hd 256

# phase 10: K1 at a query offset, the mesh paths at world size 1
OFFSET_TPS = (2, 4)               # row blocks of qwen2-0.5b's prefill, one per "seq" rank
OFFSET_TIMED = (4, 3)             # (tp, rank): the 128-row block at q_offset 384
OFFSET_WHOLE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # the blocks vs the unsharded K1
MESH_STEP_TOL = 1e-4              # mesh train losses vs [5]'s (tests/test_torch_train.py)
# (h): qwen2-0.5b's steps at grad_accum 2 on the (1, 1) mesh against the same
# steps without a mesh: the mesh step cuts its micro-batches as one process does
MESH_ACCUM, MESH_ACCUM_STEPS = 2, 2
# the other families served on the (1, 1) mesh, [3]'s request each (the same
# decode steps: a bf16 decode's rounding depends on the cache's length)
MESH_SERVE_ARCHS = ("zamba2-1.2b", "qwen2-moe-a2.7b", "musicgen-medium",
                    "llama-3.2-vision-11b")
K2_LOCAL_TP = 4                   # K2 on the local heads of a rank of a model=4 mesh
# phase 11: the dry run's cells, traced in a subprocess on the fake backend
DRYRUN_FULL = ("qwen2-0.5b", "train_4k")          # at full depth
DRYRUN_SEGMENT_SHAPE = "prefill_32k"               # each other family, one segment
DRYRUN_SEGMENT_ARCHS = ("gemma-7b", "qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-1.2b",
                        "musicgen-medium", "llama-3.2-vision-11b")
DRYRUN_TIMEOUT_S = 900            # from their start after [1] to the end of [11]
DRYRUN_DEVICE_BYTES = 79e9        # the card's usable memory: arguments + temp of DRYRUN_FULL
# JAX's temp_size_in_bytes of DRYRUN_FULL at full depth on the 16x16 mesh,
# compiled on a CPU by the JAX package's own dry run (PYTHONPATH=src python -m
# repro.launch.dryrun --arch qwen2-0.5b --shape train_4k); the card has no JAX.
# tests/test_torch_dryrun.py::test_train_4k_temporaries_within_twice_jax
# compiles its 2-layer cut (5.23 GB) and holds the port's trace to it
JAX_DRYRUN_FULL_TEMP_BYTES = 5.41e9
# the multi-pod cell: llama4-scout-17b-a16e train_4k on 2x16x16 cut to 2 of its
# 48 layers at the full model's grad_accum 16 (a rank holds 8 rows: each
# micro-batch's 16 rows sit on 16 of the 32 dp ranks); the cut alone would get
# grad_accum 4 from pick_grad_accum
DRYRUN_MULTI_POD = ("llama4-scout-17b-a16e", "train_4k", 2, 16)
# JAX's per-device FLOPs (hlo_analysis), temp_size_in_bytes and
# argument_size_in_bytes of that cut, compiled on a CPU by the JAX package's
# dry-run code (PYTHONPATH=src python tests/jax_dryrun_cell.py
# llama4-scout-17b-a16e train_4k --multi-pod --layers 2 --grad-accum 16)
JAX_DRYRUN_MULTI_POD_FLOPS = 4.635611889664e13
JAX_DRYRUN_MULTI_POD_TEMP_BYTES = 7148397120
JAX_DRYRUN_MULTI_POD_ARGUMENT_BYTES = 304205828
# the same cut on the 16x16 mesh: each layer's weights gathered and their
# gradients reduce-scattered where the layer runs, wo's kept on model, so the
# port's FLOPs a device come within DRYRUN_SCOUT_CUT_FLOPS_RATIO of JAX's
# (tests/jax_dryrun_cell.py llama4-scout-17b-a16e train_4k --layers 2
# --grad-accum 16, compiled on a CPU)
DRYRUN_SCOUT_CUT = ("llama4-scout-17b-a16e", "train_4k", 2, 16)
DRYRUN_SCOUT_CUT_FLOPS_RATIO = 1.02
JAX_DRYRUN_SCOUT_CUT_FLOPS = 5.148055175168e13
JAX_DRYRUN_SCOUT_CUT_TEMP_BYTES = 6608617752
# llama4-scout-17b-a16e train_4k at full depth on 16x16 and 2x16x16: the port's
# temp a device at most JAX's temp_size_in_bytes of the same cell, compiled on
# a CPU by the JAX package's dry run (PYTHONPATH=src python -m
# repro.launch.dryrun --arch llama4-scout-17b-a16e --shape train_4k --mesh
# both), in GB to the hundredth as its table gives them
DRYRUN_SCOUT_FULL = ("llama4-scout-17b-a16e", "train_4k")
JAX_DRYRUN_SCOUT_FULL_TEMP_BYTES = {"pod16x16": 10.81e9, "pod2x16x16": 11.23e9}
ELASTIC_STEPS, ELASTIC_CKPT_EVERY, ELASTIC_MORE = 10, 5, 2

# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by operand type
# (bf16 on the tensor cores; f32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def use_expandable_segments() -> None:
    """Have the CUDA caching allocator map its memory in expandable segments,
    unless the caller set ``PYTORCH_CUDA_ALLOC_CONF``; call before CUDA
    initialises. Without them, beside a full-width model of 53-59 GB the
    free memory lay in pieces too small for a 13.4 GiB stacked leaf at
    deepseek-67b's init or a 2.9 GiB AdamW temporary of gemma-7b's step:
    both ran out of memory with 14-15 GiB reserved but unallocated (NVIDIA
    H100 80GB HBM3)."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# K1 bound and timing
# ---------------------------------------------------------------------------
def attention_bound(B, S, T, H, K, hd, dtype, causal, q_offset=0):
    """(bound_ms, bound_by): the least time for this work on an H100.

    Bytes: q (H heads), k and v (K heads) read once and o written once.
    Operations: 2 FLOPs per multiply-add of q.k and of p.v over the
    (query, key) pairs the mask keeps (this run's pairs, not S*T when
    causal: row i, global row ``q_offset + i``, keeps its q_offset + i + 1
    live keys), for every query head.
    """
    import torch
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * B * S * H * hd + 2 * B * T * K * hd) * itemsize
    pairs = sum(min(q_offset + i + 1, T) for i in range(S)) if causal else S * T
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
    prefill shape (``K1_SHAPES``, causal) and the vlm's cross-attention
    shapes (``K1_CROSS_SHAPES``, not causal)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # (B, S, T, H, K, hd, dtype, causal): K KV heads, H % K == 0
        (8, 512, 512, 14, 2, 64, bf16, True),      # qwen2-0.5b's prefill
        (8, 512, 512, 14, 2, 64, bf16, False),
        (8, 512, 512, 14, 2, 64, f32, True),
        (8, 512, 512, 14, 2, 64, f32, False),
        (8, 512, 512, 14, 14, 64, bf16, True),     # full-H k/v (K == H)
        (8, 512, 512, 12, 2, 128, bf16, True),     # qwen2-1.5b's prefill, hd 128
        (8, 512, 512, 12, 2, 128, f32, True),
        (8, 512, 512, 32, 32, 64, bf16, True),     # zamba2-1.2b's shared block
        (8, 512, 512, 16, 16, 256, bf16, True),    # gemma-7b's prefill, hd 256
        (8, 512, 512, 16, 16, 256, bf16, False),
        (8, 512, 512, 16, 16, 256, f32, True),
        (8, 512, 512, 16, 16, 256, f32, False),
        (8, 512, 512, 16, 16, 128, bf16, True),    # qwen2-moe-a2.7b's prefill
        (8, 512, 512, 16, 16, 128, f32, True),
        (8, 512, 512, 24, 24, 64, bf16, True),     # musicgen-medium's prefill, H = 24
        (8, 512, 512, 24, 24, 64, f32, True),
        (8, 512, 512, 32, 8, 128, bf16, True),     # llama-3.2-vision-11b's self-attention
        (8, 512, 512, 32, 8, 128, f32, True),
        (8, 512, 512, 64, 8, 128, bf16, True),     # deepseek-67b's prefill, GQA group 8
        (8, 512, 512, 64, 8, 128, f32, True),
        (8, 512, 512, 40, 8, 128, bf16, True),     # llama4-scout-17b-a16e's, group 5
        (8, 512, 512, 40, 8, 128, f32, True),
        (8, 512, 1601, 32, 8, 128, bf16, False),   # its cross-attention: ragged T = 1601
        (8, 512, 1601, 32, 8, 128, f32, False),
        (8, 1, 1601, 32, 8, 128, bf16, False),     # ... and in each decode step, S = 1
        (8, 1, 1601, 32, 8, 128, f32, False),
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
    targets = {**{label: (shape, True) for label, shape in K1_SHAPES.items()},
               **{label: (shape, False) for label, shape in K1_CROSS_SHAPES.items()}}
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
        for label, (shape, want_causal) in targets.items():
            if ((B, S, T, H, K, hd) == shape and dtype == bf16 and causal == want_causal
                    and label not in timed):
                timed[label] = (q, k, v, err)
    _check(sorted(timed) == sorted(targets), f"K1 timed shapes {sorted(timed)}")

    at = {}
    for label, (q, k, v, err) in timed.items():
        shape, causal = targets[label]
        ms = time_ms(lambda: ops.attention(q, k, v, causal=causal))
        plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=causal), iters=20)
        library_ms = _sdpa_ms(q, k, v, causal)
        bound_ms, bound_by = attention_bound(*shape, torch.bfloat16, causal)
        at[label] = {"shape": "B,S,T,H,K,hd=" + ",".join(map(str, shape)), "causal": causal,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        where = (f"{label}'s prefill shape" if label in K1_SHAPES
                 else f"{label.replace(', ', ' (')}) shape")
        print(f"  K1 at {where} ({at[label]['shape']}, bf16, causal={causal}): "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms "
              f"({ms / library_ms:.2f}x), bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of the bound", flush=True)
    q, k, v, _ = timed[ARCH]
    paced_ms = time_ms(lambda: ops.attention(q, k, v, causal=True), queued=False)
    # the launcher alone, without the operator repro_torch::k1_fwd that
    # FlashAttentionFn calls: what the dispatcher's hop costs
    launcher_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    launcher_paced_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                                queued=False)
    print(f"  K1 at {ARCH}'s prefill shape, paced by the host (back-to-back calls "
          f"without a queued start): {paced_ms:.4f} ms a call; through the operator "
          f"repro_torch::k1_fwd (ops.attention) {at[ARCH]['ms']:.4f} ms queued, the "
          f"launcher alone {launcher_ms:.4f} ms queued, {launcher_paced_ms:.4f} ms paced",
          flush=True)
    at[ARCH].update(paced_ms=paced_ms, launcher_ms=launcher_ms,
                    launcher_paced_ms=launcher_paced_ms)
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
    # the launcher alone, without the operator repro_torch::k2_fwd
    launcher_ms = time_ms(lambda: ssd_mod.ssd_scan(x, dt, A, B, C, chunk=chunk))
    launcher_paced_ms = time_ms(lambda: ssd_mod.ssd_scan(x, dt, A, B, C, chunk=chunk),
                                queued=False)
    print(f"  K2 at {SSM_ARCH}'s prefill shape: paced by the host {paced_ms:.4f} ms a "
          f"call; ssd_ref {ref_ms:.4f} ms; through the operator repro_torch::k2_fwd "
          f"(ops.ssd) {at[SSM_ARCH]['ms']:.4f} ms queued, the launcher alone "
          f"{launcher_ms:.4f} ms queued, {launcher_paced_ms:.4f} ms paced", flush=True)
    at[SSM_ARCH].update(paced_ms=paced_ms, launcher_ms=launcher_ms,
                        launcher_paced_ms=launcher_paced_ms)
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
def greedy_decode(decode, params, logits, cache, steps: int, frames=None):
    """Greedy tokens after a prefill: the prefill's own, then one per step.

    Each step feeds the last greedy token, or for the audio family (whose
    frontend is a stub, so a generated token cannot be fed back) the
    step's frame embedding ``frames[:, t:t + 1]`` (B, 1, D).
    Returns (tokens (B, 1 + steps), last logits, cache).
    """
    import torch
    from repro_torch.runtime.serve import grow_cache
    cache = grow_cache(cache, steps)
    tok = logits[:, -1:].argmax(dim=-1)
    out = [tok]
    for t in range(steps):
        step = {"tokens": tok} if frames is None else {"embeds": frames[:, t:t + 1]}
        logits, cache = decode(params, cache, step)
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


def make_request(cfg, batch, length, device, steps: int = 0):
    """(the prefill batch, the decode steps' frames or None) of ``batch``
    requests of ``length`` positions, by frontend.

    Tokens are ``make_prompts``'. Audio: frame embeddings for the prompt
    and one frame for each of ``steps`` decode steps; vision: tokens and
    the image's patch embeddings (B, n_img_tokens, D). Embeddings are
    N(0, 1) in f32 (the model casts them to its compute dtype), from a
    generator on ``device`` seeded with SEED.
    """
    import torch
    gen = torch.Generator(device=device).manual_seed(SEED)
    if cfg.frontend == "audio":
        emb = torch.randn((batch, length + steps, cfg.d_model), generator=gen, device=device)
        return {"embeds": emb[:, :length].contiguous()}, emb[:, length:].contiguous()
    req = {"tokens": make_prompts(cfg, batch, length, device)}
    if cfg.frontend == "vision":
        req["img_embeds"] = torch.randn((batch, cfg.n_img_tokens, cfg.d_model),
                                        generator=gen, device=device)
    return req, None


def init_params(model):
    """Seeded random params of ``model``; a vlm's cross-block gates set to
    ``CROSS_GATE``. They are initialised to 0, and tanh(0) = 0 would
    multiply the cross-attention, K1 included, away: a wrong cross path
    would then pass every check."""
    import torch
    params = model.init(torch.Generator(device=model.rc.device).manual_seed(SEED))
    if "cross_blocks" in params:
        params["cross_blocks"]["gate"].fill_(CROSS_GATE)
    return params


def _launches() -> dict:
    from repro_torch.kernels import ops
    return {"attention": ops.attention.launches, "ssd": ops.ssd.launches}


def expected_launches(cfg) -> dict:
    """K1 and K2 launches of one prefill of ``cfg``. K1 runs once per
    attention layer (dense, moe, audio, vlm), per cross block of a vlm
    (one after every full segment of ``cross_attn_every`` layers:
    llama-3.2-vision-11b 40 + 8) or per application of the hybrid's
    shared block, one after every full segment of ``attn_every`` Mamba2
    layers (zamba2-1.2b: 38 // 6 = 6); K2 once per Mamba2 layer."""
    if cfg.family in ("dense", "moe", "audio"):
        return {"attention": cfg.n_layers, "ssd": 0}
    if cfg.family == "vlm":
        return {"attention": cfg.n_layers + cfg.n_layers // cfg.cross_attn_every, "ssd": 0}
    if cfg.family == "ssm":
        return {"attention": 0, "ssd": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"attention": cfg.n_layers // cfg.attn_every, "ssd": cfg.n_layers}
    raise ValueError(f"no served path for family {cfg.family!r}")


def expected_decode_launches(cfg) -> dict:
    """K1 and K2 launches of one decode step: the vlm's cross blocks run K1
    over the cached image keys (8 a step for llama-3.2-vision-11b); self-
    attention decode and the Mamba2 decode step run neither kernel."""
    cross = cfg.n_layers // cfg.cross_attn_every if cfg.family == "vlm" else 0
    return {"attention": cross, "ssd": 0}


def serve(cfg, *, device: str, batch: int, prompt_len: int, decode_steps: int,
          mesh=None) -> dict:
    """Answer ``batch`` requests: one prefill, then greedy decode steps.

    Returns the timings, the launches of each kernel ({"attention": n,
    "ssd": m}) made by the timed prefill and by the whole timed request,
    and the generated tokens (B, 1 + decode_steps). Given a ``mesh``, the
    steps are the mesh path's, the params distributed into their
    shardings and the request placed with the batch's.
    """
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import RunConfig
    from repro_torch.parallel.sharding import whole
    from repro_torch.runtime.serve import build_decode_step, build_prefill_step
    from repro_torch.runtime.train import distribute

    rc = RunConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device=device)
    prefill, _, _, p_sh, model = build_prefill_step(cfg, mesh, B=batch, S=prompt_len, rc=rc)
    decode, *_, shardings, _ = build_decode_step(
        cfg, ShapeConfig("serve", "decode", prompt_len + decode_steps, batch), mesh, rc=rc)
    params = init_params(model)
    request, frames = make_request(cfg, batch, prompt_len, device, steps=decode_steps)
    if mesh is not None:
        params = distribute(params, p_sh)
        b_sh = next(iter(shardings[2].values()))   # the batch dim on dp, as every input's
        request = distribute(request, {k: b_sh for k in request})
        if frames is not None:
            frames = distribute({"f": frames}, {"f": b_sh})["f"]

    # warm-up at the timed shapes (GEMM plans, allocator pools), not timed
    warm_logits, warm_cache = prefill(params, request)
    greedy_decode(decode, params, warm_logits, warm_cache, 2, frames)
    del warm_logits, warm_cache
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.attention.launches = ops.ssd.launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, request)
    _sync(device)
    t1 = time.perf_counter()
    prefill_launches = _launches()
    gen, logits, cache = greedy_decode(decode, params, logits, cache, decode_steps, frames)
    _sync(device)
    t2 = time.perf_counter()
    launches = _launches()
    gen, logits = whole(gen), whole(logits)
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


@contextlib.contextmanager
def record_routing(log: list):
    """Append each MoE layer's routing to ``log``, in call order: a dict of
    its top-k choices ``idx`` (tokens, k), in rank order, the probabilities
    ``probs`` (tokens, Ep) they were taken from, and ``kept`` (tokens, Ep),
    True where a choice kept its place in its expert's capacity. For a
    comparison only."""
    from repro_torch.models import moe
    top_k, route = moe.top_k, moe.route
    chosen = []

    def recording_top_k(probs, k):
        vals, idx = top_k(probs, k)
        chosen.append((idx.detach(), probs.detach()))
        return vals, idx

    def recording_route(logits, cfg, group):
        dispatch, combine, aux = route(logits, cfg, group)
        idx, probs = chosen.pop()
        Ep = logits.shape[-1]
        log.append({"idx": idx.reshape(-1, idx.shape[-1]), "probs": probs.reshape(-1, Ep),
                    "kept": (dispatch.detach().float().sum(-1) > 0).reshape(-1, Ep)})
        return dispatch, combine, aux
    moe.top_k, moe.route = recording_top_k, recording_route
    try:
        yield
    finally:
        moe.top_k, moe.route = top_k, route


@contextlib.contextmanager
def count_sharded_ce(calls: list):
    """Append the local logits' shape to ``calls`` at each call of the
    loss on a vocab-sharded DTensor (``layers._sharded_cross_entropy``,
    the mesh path's CE on each rank's columns). For a check only."""
    from repro_torch.models import layers
    sharded = layers._sharded_cross_entropy

    def counting(logits, labels, vocab_size):
        calls.append(tuple(logits.to_local().shape))
        return sharded(logits, labels, vocab_size)
    layers._sharded_cross_entropy = counting
    try:
        yield
    finally:
        layers._sharded_cross_entropy = sharded


def routing_diff(log_a, log_b) -> dict:
    """Two runs' routings (``record_routing`` logs of the same layers and
    tokens) compared layer by layer.

    ``differ`` (layers, tokens): the token's top-k choices or its kept
    places differ. ``flips``: the token-layers whose top-k choices differ
    (rank order included). ``near_ties``: those of them at which every
    rank that differs swaps two experts whose probabilities lie within
    ``NEAR_TIE`` of each other in both runs.
    """
    import torch
    differ, flips, near_ties = [], 0, 0
    for a, b in zip(log_a, log_b):
        d_idx = a["idx"] != b["idx"]                               # (tokens, k)
        close = torch.ones_like(d_idx)
        for run in (a, b):
            gap = (run["probs"].gather(-1, a["idx"]) - run["probs"].gather(-1, b["idx"])).abs()
            close &= gap <= NEAR_TIE
        flipped = d_idx.any(-1)
        flips += int(flipped.sum())
        near_ties += int((flipped & (close | ~d_idx).all(-1)).sum())
        differ.append(flipped | (a["kept"] != b["kept"]).any(-1))
    return {"differ": torch.stack(differ) if differ else None, "flips": flips,
            "near_ties": near_ties}


def _inputs_prefix(request, split: int) -> dict:
    """The prefill batch of the first ``split`` positions (the image stays whole)."""
    return {k: v if k == "img_embeds" else v[:, :split] for k, v in request.items()}


def consistency(cfg, *, device: str, prefill_batch: int, prefill_len: int,
                batch: int, seq_len: int, split: int) -> dict:
    """f32 errors: prefill logits with the kernels vs their plain versions;
    prefill + decode vs forward.

    A MoE's routing is recorded in both prefills: K1 and its plain
    version differ by about 1e-6 in f32, enough to flip a near-tied
    top-k choice (or, through the capacity queue, another token's drop),
    which moves that request's logits by far more than the bound. The
    error is held on the requests none of whose tokens was routed
    differently in any layer, and the count of differing choices is
    returned. The decode check runs a MoE at ``DECODE_MOE_CAPACITY``.
    """
    import torch
    from repro_torch.models import RunConfig, build
    from repro_torch.runtime.serve import grow_cache

    rc = RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32, device=device)
    model = build(cfg, rc)
    params = init_params(model)

    request, _ = make_request(cfg, prefill_batch, prefill_len, device)
    runs = []
    for plain in (False, True):
        log = []
        with record_routing(log), (plain_kernels() if plain else contextlib.nullcontext()):
            logits, _ = model.prefill(params, request)
        runs.append((logits, log))
    (logits, log_k), (logits_plain, log_p) = runs
    rows = torch.ones(prefill_batch, dtype=torch.bool, device=logits.device)
    routing = routing_diff(log_k, log_p)
    if routing["differ"] is not None:
        rows &= ~routing["differ"].any(dim=0).reshape(prefill_batch, prefill_len).any(dim=1)
    _check(bool(rows.any()), "every request was routed differently with the plain kernels")
    err_plain = float((logits - logits_plain)[rows].abs().max())
    del logits, logits_plain, runs

    dcfg = (dataclasses.replace(cfg, capacity_factor=DECODE_MOE_CAPACITY) if cfg.n_experts
            else cfg)
    dmodel = build(dcfg, rc)
    request, _ = make_request(cfg, batch, seq_len, device)
    full, _, _ = dmodel.apply(params, request)
    _, cache = dmodel.prefill(params, _inputs_prefix(request, split))
    cache = grow_cache(cache, seq_len - split)
    outs = []
    for t in range(split, seq_len):
        step = ({"embeds": request["embeds"][:, t:t + 1]} if cfg.frontend == "audio"
                else {"tokens": request["tokens"][:, t:t + 1]})
        step_logits, cache = dmodel.decode(params, cache, step)
        outs.append(step_logits)
    err_decode = float((torch.cat(outs, dim=1) - full[:, split:]).abs().max())
    _check(bool(torch.isfinite(full).all()), "non-finite forward logits")
    out = {"prefill_kernels_vs_plain": err_plain, "prefill_decode_vs_forward": err_decode}
    if cfg.n_experts:
        out.update(routing_flips=routing["flips"], moe_layers=len(log_k),
                   requests_held=int(rows.sum()), requests=prefill_batch)
    return out


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


def attention_bwd_bound(B, S, T, H, K, hd, dtype, causal):
    """(bound_ms, bound_by): the least time of K1's backward on an H100.

    Bytes: q, the output and its gradient (H heads) and k, v (K heads)
    read once, dq (H heads) and dk, dv (K heads) written once. Operations:
    the five products of ``ref.attention_bwd`` (q.k recomputed, dV, dP, dQ,
    dK), 2 FLOPs per multiply-add each over the (query, key) pairs the
    mask keeps, for every query head: 2.5 times the forward's.
    """
    import torch
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (4 * B * S * H * hd + 4 * B * T * K * hd) * itemsize
    pairs = sum(min(i + 1, T) for i in range(S)) if causal else S * T
    flops = 10 * B * H * hd * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOP_PER_S[_dtype_name(dtype)]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_k1_grad(gen, cases) -> dict:
    """K1 under a gradient against autograd through its plain version, at each
    of ``cases`` ((B, S, T, H, K, hd, dtype, causal)); at the first, the
    backward's time beside its bound and SDPA forward + backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    main, worst = None, 0.0
    for B, S, T, H, K, hd, dtype, causal in cases:
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((B, T, K, hd), generator=gen, device="cuda").to(dtype)
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
        print(f"  K1 grad B={B} S={S} T={T} H={H} K={K} hd={hd} {_dtype_name(dtype)} "
              f"causal={causal}: dq/dk/dv max_abs_err={err:.3e} (tol {tol:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        _check(ok, f"K1's gradient disagrees with its plain version's: {err}")
        if main is None:
            main = (q.detach(), k.detach(), v.detach(), out.detach(), dout, causal)
            worst = err
        del inputs, out, got, expect

    q, k, v, out, dout, causal = main
    (B, S, H, hd), (T, K) = q.shape, k.shape[1:3]
    bwd_ms = time_ms(lambda: ref.attention_bwd(q, k, v, out, dout, causal=causal),
                     iters=20, warmup=3)
    fwd_ms = time_ms(lambda: ops.attention(q, k, v, causal=causal))
    bound_ms, bound_by = attention_bwd_bound(B, S, T, H, K, hd, q.dtype, causal)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, ref.repeat_kv(k, H), ref.repeat_kv(v, H)))
    dot = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        torch.autograd.grad(o, (qt, kt, vt), dot)
    sdpa_ms = time_ms(sdpa_fwd_bwd, iters=20, warmup=3)
    print(f"  K1 under a gradient at B={B} S={S} T={T} H={H} K={K} hd={hd} "
          f"({_dtype_name(q.dtype)}, causal={causal}): forward {fwd_ms:.4f} ms, backward "
          f"(tensor ops) {bwd_ms:.4f} ms, its bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / bwd_ms:.1%} of it; SDPA forward + backward on full-H k/v "
          f"{sdpa_ms:.4f} ms (yardstick; the port never calls it)", flush=True)
    return {"shape": "B,S,T,H,K,hd=" + ",".join(map(str, (B, S, T, H, K, hd))),
            "causal": causal, "max_abs_err": worst, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "bwd_bound_ms": bound_ms, "bwd_bound_by": bound_by, "sdpa_fwd_bwd_ms": sdpa_ms}


def _grads_rel_err(got, expect) -> float:
    """Largest abs error over matching gradients, each over its expected
    tensor's largest abs value."""
    err = 0.0
    for g, e in zip(got, expect):
        scale = float(e.float().abs().max())
        err = max(err, float((g.float() - e.float()).abs().max()) / (scale or 1.0))
    return err


def check_k2_grad(gen) -> dict:
    """K2 under a gradient (``SSDScanFn``) against autograd through both plain
    versions, and its times at the train shapes (``K2_TRAIN_SHAPES``).

    Returns, per arch, the forward's ms at chunk 32 beside ``ssd_chunked``'s
    and the bound, and the ms of ``SSDScanFn.backward`` (``ssd_chunked``
    recomputed and its autograd) a layer.
    """
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models.ssm import ssd_chunked

    f32, bf16 = torch.float32, torch.bfloat16
    grads = torch.autograd.grad
    cases = [(arch, shape, dtype, with_init)
             for arch, shape in K2_TRAIN_SHAPES.items()
             for dtype in (bf16, f32) for with_init in (False, True)]
    cases += [(None, (2, 64) + shape[2:], dtype, with_init)     # small: against ssd_ref
              for shape in K2_TRAIN_SHAPES.values()
              for dtype in (bf16, f32) for with_init in (False, True)]
    timed = {}
    for arch, (b, s, h, p, n, chunk), dtype, with_init in cases:
        x, dt, A, B, C, st = ssd_inputs(gen, b, s, h, p, n, dtype, dtype, with_init)
        inputs = [t.requires_grad_(True) for t in (x, dt, A, B, C, st) if t is not None]
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        before = ops.ssd.launches
        y, _ = ops.ssd(x, dt, A, B, C, chunk=chunk, init_state=st)
        _check(ops.ssd.launches == before + 1 and y.grad_fn is not None,
               "ops.ssd under grad did not go through SSDScanFn")
        got = grads(y, inputs, dy)
        _check(ops.ssd.launches == before + 1, "SSDScanFn's backward launched K2")
        _check(all(g.dtype == t.dtype for g, t in zip(got, inputs)),
               f"gradient dtypes {[g.dtype for g in got]}")
        chunked = grads(ssd_chunked(x, dt, A, B, C, chunk, init_state=st)[0], inputs, dy)
        err = _grads_rel_err(got, chunked)
        tol, vs = K2_GRAD_TOL, "ssd_chunked"
        if arch is None:
            err = _grads_rel_err(got, grads(ref.ssd_ref(x, dt, A, B, C, init_state=st)[0],
                                            inputs, dy))
            tol, vs = K2_GRAD_REF_TOL[_dtype_name(dtype)], "ssd_ref"
        torch.cuda.synchronize()
        print(f"  K2 grad b={b} s={s} h={h} p={p} n={n} chunk={chunk} {_dtype_name(dtype)} "
              f"init_state={with_init} kernel={ssd_mod.kernel_path(dtype, dtype)}: x/dt/A/B/C"
              f"{'/init' if with_init else ''} vs autograd through {vs}: max err "
              f"{err:.3e} of the largest (tol {tol:g}) {'ok' if err <= tol else 'FAIL'}",
              flush=True)
        _check(err <= tol, f"K2's gradient disagrees with autograd through {vs}: {err}")
        if arch is not None and dtype == bf16 and not with_init:
            timed[arch] = [t.detach() for t in (x, dt, A, B, C)] + [dy]
        del x, dt, A, B, C, st, inputs, y, got, chunked

    at = {}
    for arch, (x, dt, A, B, C, dy) in timed.items():
        b, s, h, p, n, chunk = K2_TRAIN_SHAPES[arch]
        err = _k2_err(f"{arch}'s train shape, y vs ssd_chunked",
                      ops.ssd(x, dt, A, B, C, chunk=chunk)[0],
                      ssd_chunked(x, dt, A, B, C, chunk)[0], K2_REF_TOL["bfloat16"])
        ms = time_ms(lambda: ops.ssd(x, dt, A, B, C, chunk=chunk))
        plain_ms = time_ms(lambda: ssd_chunked(x, dt, A, B, C, chunk), iters=10, warmup=2)
        inputs = [t.requires_grad_(True) for t in (x, dt, A, B, C)]
        y = ops.ssd(*inputs, chunk=chunk)[0]
        bwd_ms = time_ms(lambda: grads(y, inputs, dy, retain_graph=True), iters=5, warmup=2)
        bound_ms, bound_by = ssd_bound(b, s, h, p, n, chunk, bf16, bf16)
        at[f"{arch} train"] = {
            "shape": "b,s,h,p,n,chunk=" + ",".join(map(str, K2_TRAIN_SHAPES[arch])),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "bwd_ms": bwd_ms}
        print(f"  K2 at {arch}'s train shape ({at[f'{arch} train']['shape']}, bf16): forward "
              f"{ms:.4f} ms (plain ssd_chunked {plain_ms:.4f} ms), bound {bound_ms:.4f} ms "
              f"({bound_by}), {bound_ms / ms:.1%} of the bound; backward (ssd_chunked "
              f"recomputed + its autograd) {bwd_ms:.4f} ms a layer", flush=True)
    return at


def remat_agreement(cfg, *, device: str, batch: int, seq_len: int) -> dict:
    """One f32 forward + backward of ``cfg`` (the train chunk) with remat off,
    ``"full"`` and ``"dots"``, from one state and one batch: each one's loss,
    gradient leaves, peak memory and launches."""
    import torch
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import ops
    from repro_torch.models import RunConfig, build
    from repro_torch.runtime.train import value_and_grad
    from repro_torch.tree import tree_flatten_with_path

    rc = RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32, device=device,
                   ssd_chunk=SSD_TRAIN_CHUNK)
    params = build(cfg, rc).init(torch.Generator(device=device).manual_seed(SEED))
    b = to_device(next(synthetic_data(cfg, batch, seq_len)), device)
    runs = {}
    for name, kw in (("off", {}), ("full", dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        model = build(cfg, rc.replace(**kw))
        _sync(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.attention.launches = ops.ssd.launches = 0
        loss, grads = value_and_grad(model.loss, params, b)
        _sync(device)
        runs[name] = {"loss": float(loss), "grads": tree_flatten_with_path(grads),
                      "launches": _launches(),
                      "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                               if torch.device(device).type == "cuda"
                                               else None)}
    base = runs["off"]
    return {name: {"loss": run["loss"],
                   "loss_rel": abs(run["loss"] - base["loss"]) / abs(base["loss"]),
                   "grads_rel": _grads_rel_err([run["grads"][k] for k in base["grads"]],
                                               list(base["grads"].values())),
                   "launches": run["launches"],
                   "max_memory_allocated": run["max_memory_allocated"]}
            for name, run in runs.items()}


def _tree_bytes(cfg, dtype) -> int:
    """Bytes of ``cfg``'s params tree in ``dtype`` (its f32 leaves stay f32),
    from the meta tree."""
    import torch
    from repro_torch.models import RunConfig, build
    from repro_torch.tree import tree_leaves
    rc = RunConfig(param_dtype=dtype, compute_dtype=dtype, device="meta")
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(build(cfg, rc).init_eval_shape()))


def _train_state_gb(cfg) -> float:
    """GB of ``cfg``'s f32 train state at a step's peak: 28 bytes a parameter
    (the old and the new params, m and v, and the gradients, 4 bytes each)."""
    import torch
    return 7 * _tree_bytes(cfg, torch.float32) / 1e9


def _max_abs_diff(a, b) -> float:
    from repro_torch.tree import tree_leaves
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def train_rc(device: str, **kw):
    """The train steps' RunConfig: f32 params, bf16 compute, on ``device``."""
    import torch
    from repro_torch.models import RunConfig
    return RunConfig(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                     device=device, **kw)


def expected_train_launches(cfg, rc) -> dict:
    """K1 and K2 launches of one train step of ``cfg`` under ``rc``.

    As in a prefill (``expected_launches``), but a block that ``rc.remat``
    checkpoints runs its forward again in the backward, kernel and all
    (``SSDScanFn`` and ``FlashAttentionFn`` are no matmuls, so
    ``remat_policy="dots"`` recomputes them too); the backwards launch
    none. As in the JAX package, only the layer stacks' blocks are
    checkpointed: not the hybrid's shared block, nor the vlm's cross
    blocks (llama-3.2-vision-11b under remat: 2 * 40 + 8)."""
    once = expected_launches(cfg)
    again = 2 if rc.remat else 1
    if cfg.family == "hybrid":
        return {"attention": once["attention"], "ssd": again * once["ssd"]}
    if cfg.family == "vlm":
        return {"attention": again * cfg.n_layers + cfg.n_layers // cfg.cross_attn_every,
                "ssd": 0}
    return {k: again * n for k, n in once.items()}


def synthetic_data(cfg, batch: int, seq_len: int):
    """``SyntheticLM`` batches of ``cfg``'s frontend (frame embeddings for
    audio, tokens and image embeddings for vision), seeded with SEED."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(batch, seq_len, cfg.vocab_size, seed=SEED),
                       frontend=cfg.frontend, d_model=cfg.d_model,
                       n_img_tokens=cfg.n_img_tokens)


def init_train_state(model):
    """``runtime.train``'s seeded state of ``model``; a vlm's cross-block
    gates set to ``CROSS_GATE``, as ``init_params`` does: at 0 they make
    every cross-attention gradient exactly zero, so a wrong backward of K1
    at the cross shape would pass."""
    from repro_torch.runtime.train import init_sharded_state
    state = init_sharded_state(model, None, None, SEED)
    if "cross_blocks" in state.params:
        state.params["cross_blocks"]["gate"].fill_(CROSS_GATE)
    return state


def train(cfg, *, device: str, batch: int, seq_len: int, steps: int,
          resume_after: Optional[int] = None, ckpt_dir=None, rc=None,
          lr: float = 3e-4, mesh=None, grad_accum: int = 1) -> dict:
    """``steps`` AdamW steps on ``synthetic_data`` batches through
    ``runtime.train`` from ``init_train_state``, under ``rc``
    (``train_rc(device)`` when None), at peak learning rate ``lr`` (2
    warmup steps, then the cosine to ``steps``), each batch cut into
    ``grad_accum`` micro-batches. Given a ``mesh``, the
    step is the mesh path's: the state is distributed into its shardings
    and each batch placed with ``shard_batch``.

    With ``resume_after``, a checkpoint saved after that step is restored
    into a fresh (meta) state and step ``resume_after + 1`` is taken again
    from it. Returns the per-step metrics and times, the launches of each
    kernel per step, the peak memory and the resume errors.
    """
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.parallel.sharding import specs_of
    from repro_torch.runtime.train import TrainRunConfig, build_train_step, distribute
    from repro_torch.tree import tree_map

    rc = rc or train_rc(device)
    trc = TrainRunConfig(opt=OptConfig(lr=lr, warmup_steps=2, total_steps=steps),
                         grad_accum=grad_accum)
    step, state_meta, _, st_sh, b_sh, model = build_train_step(cfg, mesh, B=batch,
                                                               S=seq_len, rc=rc, trc=trc)
    state = init_train_state(model)
    if mesh is not None:
        state = distribute(state, st_sh)
    data = synthetic_data(cfg, batch, seq_len)

    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    metrics, step_ms, launches = [], [], []
    ops.attention.launches = ops.ssd.launches = 0
    for i in range(1, steps + 1):
        b = (to_device(next(data), device) if mesh is None
             else shard_batch(next(data), mesh, specs_of(b_sh)))
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
            ckpt = Checkpointer(ckpt_dir, keep=1)
            ckpt.save(state, i)
            ckpt.wait()
            save_s = time.perf_counter() - t0
        if resume_after is not None and i == resume_after + 1:
            # held on the host, so that it takes no room in the card's peak memory
            after_resume = tree_map(lambda t: t.to("cpu", copy=True), state.params)
            batch_resume = b
    total_launches = _launches()
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else None)
    del state
    timed = step_ms[1:] or step_ms
    out = {
        "metrics": metrics, "step_ms": step_ms,
        "median_step_ms": statistics.median(timed),
        "tokens_per_s": batch * seq_len / (statistics.median(timed) / 1e3),
        "launches_per_step": launches, "launches": total_launches,
        "max_memory_allocated": peak,
    }
    if resume_after is None:
        return out

    t0 = time.perf_counter()
    restored = ckpt.restore(state_meta, device=device)
    restore_s = time.perf_counter() - t0
    _check(int(restored.step) == resume_after, f"restored step {int(restored.step)}")
    resumed, met = step(restored, batch_resume)
    del restored
    loss_err = abs(float(met["loss"]) - metrics[resume_after]["loss"])
    params_err = _max_abs_diff(tree_map(lambda t: t.to("cpu"), resumed.params),
                               after_resume)
    return {**out, "save_s": save_s, "restore_s": restore_s,
            "resume_loss_err": loss_err, "resume_params_err": params_err}


def _leaf_errors(got: dict, expect: dict):
    """({key: max abs error over the expected leaf's max abs value}, {key: that
    max abs value}) over two ``tree_flatten_with_path`` gradient trees."""
    rel, scale = {}, {}
    for key, e in expect.items():
        scale[key] = float(e.abs().max())
        err = float((got[key] - e).abs().max())
        rel[key] = err / scale[key] if scale[key] else err
    return rel, scale


def train_consistency(cfg, *, device: str, batch: int, seq_len: int, **rc_kw) -> dict:
    """f32 errors of one train step with the kernels against the same step with
    their plain versions, from one state and one batch, and of its gradients
    leaf by leaf (max abs error over the plain leaf's max abs value).
    ``rc_kw`` go to the RunConfig (remat, ssd_chunk).

    The gradients carry the check of K1's backward: at step 1 the learning
    rate is 3e-6 and Adam's first step is sign-normalised, so the updated
    params can differ by at most about 6e-6 whatever the gradients are.
    """
    import torch
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import RunConfig
    from repro_torch.runtime.train import build_train_step, value_and_grad
    from repro_torch.tree import tree_flatten_with_path

    rc = RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32, device=device,
                   **rc_kw)
    step, *_, model = build_train_step(cfg, None, B=batch, S=seq_len, rc=rc)
    state = init_train_state(model)
    b = to_device(next(synthetic_data(cfg, batch, seq_len)), device)
    new, met = step(state, b)
    grads = tree_flatten_with_path(value_and_grad(model.loss, state.params, b)[1])
    with plain_kernels():
        new_plain, met_plain = step(state, b)
        grads_plain = tree_flatten_with_path(
            value_and_grad(model.loss, state.params, b)[1])

    def rel(key):
        return abs(float(met[key]) - float(met_plain[key])) / abs(float(met_plain[key]))
    grads_rel, grads_scale = _leaf_errors(grads, grads_plain)
    return {"loss_rel": rel("loss"), "grad_norm_rel": rel("grad_norm"),
            "params_abs": _max_abs_diff(new.params, new_plain.params),
            "grads_rel": grads_rel, "grads_scale": grads_scale,
            "loss": float(met["loss"])}


def grads_vs_plain(cfg, *, device: str, batch: int, seq_len: int) -> dict:
    """f32 loss and gradients of ``Model.loss`` with the kernels against the
    same with their plain versions, from one state (``init_params``: a
    vlm's gates at ``CROSS_GATE``) and one ``synthetic_data`` batch; no
    optimizer step, so about 12 bytes a parameter (params and two sets of
    gradients). Each gradient leaf's error is taken over its plain leaf's
    largest value. A MoE's routing is recorded in both runs
    (``routing_diff``); the kernels' run's launches are returned."""
    import torch
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import ops
    from repro_torch.models import RunConfig, build
    from repro_torch.runtime.train import value_and_grad
    from repro_torch.tree import tree_flatten_with_path

    model = build(cfg, RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32,
                                 device=device))
    params = init_params(model)
    b = to_device(next(synthetic_data(cfg, batch, seq_len)), device)
    runs = []
    for plain in (False, True):
        log = []
        ops.attention.launches = ops.ssd.launches = 0
        with record_routing(log), (plain_kernels() if plain else contextlib.nullcontext()):
            loss, grads = value_and_grad(model.loss, params, b)
        runs.append((float(loss), tree_flatten_with_path(grads), log, _launches()))
        del grads
    (loss, grads, log_k, launches), (loss_p, grads_p, log_p, _) = runs
    grads_rel, grads_scale = _leaf_errors(grads, grads_p)
    out = {"loss": loss, "loss_rel": abs(loss - loss_p) / abs(loss_p),
           "grads_rel": grads_rel, "grads_scale": grads_scale, "launches": launches}
    if cfg.n_experts:
        routing = routing_diff(log_k, log_p)
        out.update(routing_flips=routing["flips"], near_ties=routing["near_ties"],
                   token_layers=sum(int(entry["idx"].shape[0]) for entry in log_k))
    return out


def train_and_check(phase: str, cfg, label: str, *, steps: int, rc,
                    lr: float = TRAIN_7_LR, losses_out: Optional[list] = None) -> dict:
    """``train`` ``cfg`` (8 x 512 tokens a step, peak learning rate ``lr``)
    under ``rc``; print each step and the run, and check a finite, falling
    loss and ``expected_train_launches`` every step. Returns the launches a
    step; the losses are appended to ``losses_out`` when given."""
    import torch
    tr = train(cfg, device="cuda", batch=TRAIN_BATCH, seq_len=TRAIN_LEN, steps=steps,
               rc=rc, lr=lr)
    for i, (met, ms, la) in enumerate(zip(tr["metrics"], tr["step_ms"],
                                          tr["launches_per_step"]), 1):
        print(f"{phase} {label} train step {i}: loss {met['loss']:.6f} grad_norm "
              f"{met['grad_norm']:.6f} lr {met['lr']:.6e}, {ms:.3f} ms, launches {la}",
              flush=True)
    print(f"{phase} {label}, remat \"{rc.remat_policy if rc.remat else 'off'}\", ssd_chunk "
          f"{rc.ssd_chunk}, peak lr {lr:g}: {steps} steps of {TRAIN_BATCH} x "
          f"{TRAIN_LEN} tokens: median step (2-{steps}) {tr['median_step_ms']:.3f} ms, "
          f"{tr['tokens_per_s']:.1f} trained tokens/s, max_memory_allocated "
          f"{tr['max_memory_allocated']} B; losses {[m['loss'] for m in tr['metrics']]}",
          flush=True)
    losses = [m["loss"] for m in tr["metrics"]]
    if losses_out is not None:
        losses_out.extend(losses)
    _check(all(np.isfinite(losses)) and all(np.isfinite([m["grad_norm"]
                                                          for m in tr["metrics"]])),
           f"{label}: non-finite loss or grad norm")
    _check(losses[-1] < losses[0], f"{label}: the loss did not fall: {losses}")
    per_step = expected_train_launches(cfg, rc)
    _check(all(la == per_step for la in tr["launches_per_step"]),
           f"{label} train steps launched {tr['launches_per_step']}, not {per_step} each")
    del tr
    torch.cuda.empty_cache()
    return per_step


def _digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes: two runs'
    tokens compared bit for bit from their logs."""
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def cut_depth(arch: str, layers: Optional[int]):
    """(``arch``'s config cut to ``layers`` at full widths, or at full depth
    when None; its label)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is None:
        return cfg, arch
    return (dataclasses.replace(cfg, n_layers=layers),
            f"{arch} ({layers} of {cfg.n_layers} layers)")


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


def _diamond(name: str, payload=None):
    """A diamond DAG (0 -> 1, 2 -> 3) whose tasks run ``payload`` (None: the
    virtual payload, the tasks' calibrated durations)."""
    from repro_torch.core.dag import Task, Workflow
    edges = {"0": ([], ["1", "2"]), "1": (["0"], ["3"]), "2": (["0"], ["3"]),
             "3": (["1", "2"], [])}
    return Workflow(name, {tid: Task(id=tid, inputs=i, outputs=o, payload=payload)
                           for tid, (i, o) in edges.items()})


def matmul_diamond(*, device: str, n: int, iters: int) -> dict:
    """A diamond DAG (0 -> 1, 2 -> 3) of ``matmul_payload`` pods under the
    engine with ``payload_mode="real"``: each pod's seconds (its virtual
    run time is its wall time) and output."""
    from repro_torch.core.payloads import matmul_payload
    from repro_torch.core.runner import ControlPlane

    mm = matmul_payload(n=n, iters=iters, device=device)
    outs = {}

    def pod(volume, task):
        mm(volume, task)
        outs[task.id] = volume.get(f"{task.id}/out")
    wf = _diamond("diamond", pod)
    plane = ControlPlane("kubeadaptor", payload_mode="real", seed=SEED)
    plane.gateway.load([wf.with_instance(0)])
    res = plane.run()
    seconds = {p.task_id: p.finished - p.started for p in res.cluster.pod_log
               if p.task_id in wf.tasks}
    return {"pod_seconds": seconds, "outputs": outs,
            "order_consistent": res.metrics.order_consistent(wf.with_instance(0))}


def example_twins() -> dict:
    """Run the host-only twins of ``examples/quickstart.py`` and
    ``examples/multi_workflow.py`` (``repro_torch.examples.quickstart``,
    ``multi_workflow``) in this process: {name: its stdout}."""
    import io
    from repro_torch.examples import multi_workflow, quickstart
    out = {}
    for name, mod in (("quickstart", quickstart), ("multi_workflow", multi_workflow)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        out[name] = buf.getvalue()
    return out


def sharded_diamonds(*, processes: bool, device: Optional[str], n: int = MATMUL_N,
                     iters: int = MATMUL_ITERS) -> dict:
    """A 2-shard ``ShardedControlPlane`` with one diamond workflow per tenant
    in ``SHARD_TENANTS`` (one tenant a shard). With ``device``, every task is
    a ``matmul_payload(n, iters)`` pod on it under ``payload_mode="real"``,
    and each pod's run is logged in run order (tenant, task, the bytes it
    allocated on the card above what was live, its output); without, the
    tasks are virtual. Returns the result and the log."""
    import torch
    from repro_torch.core.payloads import matmul_payload
    from repro_torch.core.shard import ShardedControlPlane
    log = []

    def pod_of(tenant):
        mm = matmul_payload(n=n, iters=iters, device=device)

        def pod(volume, task):
            cuda = torch.device(device).type == "cuda"
            if cuda:
                torch.cuda.reset_peak_memory_stats()
                live = torch.cuda.memory_allocated()
            mm(volume, task)
            log.append({"tenant": tenant, "task": task.id,
                        "device_bytes": torch.cuda.max_memory_allocated() - live if cuda else 0,
                        "out": volume.get(f"{task.id}/out")})
        return pod
    plane = ShardedControlPlane(len(SHARD_TENANTS), payload_mode="real" if device else "virtual",
                                seed=SEED, processes=processes, heartbeat_s=0.5,
                                shard_timeout_s=SHARD_TIMEOUT_S)
    for tenant in SHARD_TENANTS:
        plane.add_stream(_diamond(f"diamond-{tenant}", pod_of(tenant) if device else None),
                         tenant=tenant)
    return {"result": plane.run(), "log": log}


def sharded_plane_checks(reference_out) -> dict:
    """Phase 6's sharded plane on the card: inline (``processes=False``) with
    real ``matmul_payload`` pods, each tenant's diamond run in order and on
    the card by its own shard, every output bit-equal to ``reference_out``
    (the unsharded diamond's); the same plane with virtual payloads in
    forked workers equal to its inline run; and forked workers that would
    run the card's payloads fail as a ``ShardFailure`` within
    ``SHARD_TIMEOUT_S`` (CUDA cannot be used in a child forked after the
    parent initialised it, as with the reference's fork context)."""
    import torch
    from repro_torch.core.shard import ShardFailure, shard_of
    real = sharded_diamonds(processes=False, device="cuda")
    res, log = real["result"], real["log"]
    order = {tenant: [r["task"] for r in log if r["tenant"] == tenant]
             for tenant in SHARD_TENANTS}
    by_shard = {}
    for r in log:
        by_shard.setdefault(shard_of(r["tenant"], len(SHARD_TENANTS)), []).append(r)
    _check(res.completed_workflows == len(SHARD_TENANTS) and res.failed_workflows == 0
           and not res.degraded, f"sharded plane: {res.completed_workflows} completed, "
           f"{res.failed_workflows} failed, degraded={res.degraded}")
    _check(all(o[0] == "0" and o[-1] == "3" and sorted(o) == ["0", "1", "2", "3"]
               for o in order.values()), f"sharded plane ran out of order: {order}")
    _check(sorted(by_shard) == list(range(len(SHARD_TENANTS)))
           and all(r["device_bytes"] >= 4 * MATMUL_N ** 2 for r in log),
           f"a shard's pods did not run on the card: {by_shard}")
    _check(all(np.array_equal(r["out"], reference_out) for r in log),
           "sharded pods' outputs differ from the unsharded diamond's")
    inline = sharded_diamonds(processes=False, device=None)["result"]
    forked = sharded_diamonds(processes=True, device=None)["result"]
    _check(forked.tenant_summary() == inline.tenant_summary()
           and forked.completed_workflows == inline.completed_workflows == len(SHARD_TENANTS),
           f"forked virtual plane {forked.tenant_summary()} differs from inline "
           f"{inline.tenant_summary()}")
    t0 = time.perf_counter()
    try:
        sharded_diamonds(processes=True, device="cuda", n=64, iters=1)
    except ShardFailure as exc:
        failure = {"shard": exc.shard, "tenants": exc.tenants, "reason": exc.reason}
    else:
        raise RuntimeError("forked workers ran the card's payloads: expected a ShardFailure")
    failure["seconds"] = time.perf_counter() - t0
    _check("CUDA" in failure["reason"] and failure["seconds"] < SHARD_TIMEOUT_S,
           f"forked card payloads: {failure}")
    torch.cuda.synchronize()
    return {"pod_order": order, "pods_by_shard": {s: len(r) for s, r in by_shard.items()},
            "device_bytes": [r["device_bytes"] for r in log], "forked_card_failure": failure}


def train_moe_audio_vlm(rc, t_phase: float):
    """Phase 8: K1 under a gradient at the vlm's cross-attention shape; the
    moe, audio and vlm families' train steps at ``TRAIN_8_LAYERS`` under
    ``rc``; their f32 gradients, kernels vs plain, at
    ``TRAIN_8_PLAIN_LAYERS``. Returns (K1's numbers at the cross shape
    under a gradient, the launches a step of each trained model)."""
    import torch
    from repro_torch.configs import get_config
    bf16, f32 = torch.bfloat16, torch.float32
    print("[8] (a) K1 under a gradient at the vlm's cross-attention shape", flush=True)
    k1_cross_grad = check_k1_grad(torch.Generator(device="cuda").manual_seed(SEED), [
        K1_CROSS_SHAPES[K1_CROSS_TRAIN] + (dtype, False) for dtype in (bf16, f32)])
    torch.cuda.empty_cache()
    t_phase = _phase_done(8, t_phase, "(a)")
    trained = {}
    for part, (arch, layers) in zip("bcd", TRAIN_8_LAYERS.items()):
        cfg, label = cut_depth(arch, layers)
        if layers is not None:
            print(f"[8] ({part}) {arch} cut to {layers} layers (full widths): its f32 train "
                  f"state at full depth, at 28 bytes a parameter, would be "
                  f"{_train_state_gb(get_config(arch)):.1f} GB; cut, "
                  f"{_train_state_gb(cfg):.1f} GB", flush=True)
        trained[label] = train_and_check(f"[8] ({part})", cfg, label,
                                         steps=TRAIN_8_STEPS, rc=rc, lr=TRAIN_8_LR[arch])
        t_phase = _phase_done(8, t_phase, f"({part}) {arch}")
    for part, (arch, layers) in zip("efg", TRAIN_8_PLAIN_LAYERS.items()):
        cfg, label = cut_depth(arch, layers)
        errs = grads_vs_plain(cfg, device="cuda", batch=TRAIN_BATCH, seq_len=TRAIN_LEN)
        held = errs["grads_rel"]
        if cfg.n_experts:
            print(f"[8] ({part}) {label}: {errs['routing_flips']} of {errs['token_layers']} "
                  f"f32 token-layers routed differently by the kernels than by their plain "
                  f"versions, {errs['near_ties']} of them near-ties (probabilities within "
                  f"{NEAR_TIE:g})", flush=True)
            _check(errs["near_ties"] == errs["routing_flips"],
                   f"{label}: {errs['routing_flips'] - errs['near_ties']} routing flips "
                   f"that are no near-tie")
            if errs["routing_flips"]:
                held = {k: e for k, e in held.items() if not k.startswith("blocks/moe/")}
        print(f"[8] ({part}) {label}: f32 forward + backward, kernels vs plain: "
              f"{json.dumps(errs)}", flush=True)
        _check(errs["loss_rel"] <= TRAIN_PLAIN_TOL and max(held.values()) <= TRAIN_PLAIN_TOL,
               f"{label}: f32 gradients, kernels vs plain, exceed {TRAIN_PLAIN_TOL}: {errs}")
        _check(errs["launches"] == expected_launches(cfg),
               f"{label}: the forward + backward launched {errs['launches']}")
        nonzero = [f"blocks/attn/{w}" for w in ("wq", "wk", "wv")]
        if cfg.n_experts:
            nonzero += [f"blocks/moe/{w}" for w in ("router", "w1", "w2", "w3")]
        if cfg.family == "vlm":
            nonzero += [f"cross_blocks/{w}" for w in ("attn/wq", "attn/wk", "attn/wv",
                                                      "gate")]
        _check(all(errs["grads_scale"][key] > 0 for key in nonzero),
               f"{label}: a zero gradient among {nonzero}: {errs['grads_scale']}")
        torch.cuda.empty_cache()
        t_phase = _phase_done(8, t_phase, f"({part}) {arch}")
    return k1_cross_grad, trained


def train_gemma(rc, t_phase: float):
    """Phase 9: K1 under a gradient at gemma-7b's hd 256 shape; 4 train steps
    of gemma-7b cut to ``TRAIN_9_LAYERS`` under ``rc``; its f32 gradients,
    kernels vs plain, at ``TRAIN_9_PLAIN_LAYERS``. Returns (K1's numbers
    under a gradient, {label: the launches a step})."""
    import torch
    from repro_torch.configs import get_config
    bf16, f32 = torch.bfloat16, torch.float32
    print("[9] (a) K1 under a gradient at gemma-7b's shape, hd 256", flush=True)
    k1_gemma_grad = check_k1_grad(torch.Generator(device="cuda").manual_seed(SEED), [
        K1_GEMMA_TRAIN + (dtype, True) for dtype in (bf16, f32)])
    torch.cuda.empty_cache()
    t_phase = _phase_done(9, t_phase, "(a)")
    cfg, label = cut_depth(GEMMA_ARCH, TRAIN_9_LAYERS)
    print(f"[9] (b) {label} (full widths): its f32 train state at full depth, at 28 bytes "
          f"a parameter, would be {_train_state_gb(get_config(GEMMA_ARCH)):.1f} GB; cut, "
          f"{_train_state_gb(cfg):.1f} GB", flush=True)
    trained = {label: train_and_check("[9] (b)", cfg, label, steps=TRAIN_9_STEPS, rc=rc,
                                      lr=TRAIN_9_LR)}
    t_phase = _phase_done(9, t_phase, "(b)")
    cfg, label = cut_depth(GEMMA_ARCH, TRAIN_9_PLAIN_LAYERS)
    errs = grads_vs_plain(cfg, device="cuda", batch=TRAIN_BATCH, seq_len=TRAIN_LEN)
    print(f"[9] (c) {label}: f32 forward + backward, kernels vs plain: {json.dumps(errs)}",
          flush=True)
    _check(errs["loss_rel"] <= TRAIN_PLAIN_TOL
           and max(errs["grads_rel"].values()) <= TRAIN_PLAIN_TOL,
           f"{label}: f32 gradients, kernels vs plain, exceed {TRAIN_PLAIN_TOL}: {errs}")
    _check(errs["launches"] == expected_launches(cfg),
           f"{label}: the forward + backward launched {errs['launches']}")
    nonzero = ["embed"] + [f"blocks/attn/{w}" for w in ("wq", "wk", "wv", "wo")] + [
        f"blocks/mlp/{w}" for w in ("w1", "w2", "w3")]
    _check(all(errs["grads_scale"][key] > 0 for key in nonzero),
           f"{label}: a zero gradient among {nonzero}: {errs['grads_scale']}")
    torch.cuda.empty_cache()
    _phase_done(9, t_phase, "(c)")
    return k1_gemma_grad, trained


# ---------------------------------------------------------------------------
# Phase 10: the mesh paths at world size 1, and K1 at a query offset
# ---------------------------------------------------------------------------
def check_k1_offset(gen) -> dict:
    """K1 on row blocks at their q offsets (what each rank of a "seq" mesh
    runs), at qwen2-0.5b's prefill shape: each block against the plain
    version at the same offset (``K1_TOL``), the blocks together against
    the unsharded K1 (``OFFSET_WHOLE_TOL``), and under a gradient against
    autograd through the plain version (``K1_GRAD_TOL``); the timed block
    (``OFFSET_TIMED``) beside its bound, SDPA with the bottom-right causal
    mask (the same function) and SDPA with an explicit boolean mask."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels import ops, ref

    B, S, T, H, K, hd = K1_SHAPES[ARCH]
    out = {"max_abs_err": 0.0, "whole_bit_equal": True}
    for dtype in (torch.bfloat16, torch.float32):
        name = _dtype_name(dtype)
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((B, T, K, hd), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        whole = ops.attention(q, k, v, causal=True)
        for tp in OFFSET_TPS:
            n = S // tp
            blocks, worst = [], 0.0
            for r in range(tp):
                qb = q[:, r * n:(r + 1) * n].contiguous()
                got = ops.attention(qb, k, v, causal=True, q_offset=r * n)
                expect = ref.attention_ref(qb, k, v, causal=True, q_offset=r * n)
                err, ok = _grads_err([got], [expect], K1_TOL[name])
                _check(ok, f"K1 at q_offset {r * n} ({name}) disagrees with its plain "
                           f"version: {err}")
                worst = max(worst, err)
                blocks.append(got)
            cat = torch.cat(blocks, dim=1)
            whole_err = float((cat.float() - whole.float()).abs().max())
            bit_equal = torch.equal(cat, whole)
            print(f"  K1 {name} in {tp} row blocks at q_offset r * {n}: vs plain "
                  f"max_abs_err={worst:.3e} (tol {K1_TOL[name]:g}); the blocks vs the "
                  f"unsharded K1 max_abs_err={whole_err:.3e} (tol {OFFSET_WHOLE_TOL[name]:g}), "
                  f"bit-equal {bit_equal}", flush=True)
            _check(whole_err <= OFFSET_WHOLE_TOL[name],
                   f"K1's row blocks differ from the unsharded K1: {whole_err}")
            out["max_abs_err"] = max(out["max_abs_err"], worst)
            out["whole_bit_equal"] = out["whole_bit_equal"] and bit_equal
        tp, r = OFFSET_TIMED
        n = S // tp
        qb = q[:, r * n:(r + 1) * n].contiguous()
        dout = torch.randn(qb.shape, generator=gen, device="cuda").to(dtype)
        inputs = [t.clone().requires_grad_(True) for t in (qb, k, v)]
        got = torch.autograd.grad(ops.attention(*inputs, causal=True, q_offset=r * n),
                                  inputs, dout)
        expect = torch.autograd.grad(ref.attention_ref(*inputs, causal=True, q_offset=r * n),
                                     inputs, dout)
        err, ok = _grads_err(got, expect, K1_GRAD_TOL[name])
        print(f"  K1 grad {name} at q_offset {r * n} (S={n}): dq/dk/dv max_abs_err="
              f"{err:.3e} (tol {K1_GRAD_TOL[name]:g}) {'ok' if ok else 'FAIL'}", flush=True)
        _check(ok, f"K1's gradient at q_offset {r * n} disagrees: {err}")
        del inputs, got, expect
        if dtype != torch.bfloat16:
            continue
        off = r * n
        ms = time_ms(lambda: ops.attention(qb, k, v, causal=True, q_offset=off))
        plain_ms = time_ms(lambda: ref.attention_ref(qb, k, v, causal=True, q_offset=off),
                           iters=20)
        # the timed block ends at T (offset T - n): its mask is SDPA's
        # bottom-right causal alignment, one library call of the same function
        _check(off + n == T, f"OFFSET_TIMED's block at {off} + {n} does not end at T={T}")
        qt, kt, vt = (x.transpose(1, 2) for x in (qb, ref.repeat_kv(k, H), ref.repeat_kv(v, H)))
        lower_right = causal_lower_right(n, T)
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lower_right).transpose(1, 2)
        lib_err = float((lib.float() - ref.attention_ref(qb, k, v, causal=True, q_offset=off)
                         .float()).abs().max())
        _check(lib_err <= K1_TOL[name], f"SDPA with causal_lower_right is not K1's function "
                                        f"at q_offset {off}: {lib_err}")
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=lower_right))
        mask = ref.causal_mask(n, T, off, q.device)
        mask_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        bound_ms, bound_by = attention_bound(B, n, T, H, K, hd, dtype, True, q_offset=off)
        out.update({"shape": "B,S,T,H,K,hd=" + ",".join(map(str, (B, n, T, H, K, hd))),
                    "q_offset": off, "causal": True, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                    "library_bool_mask_ms": mask_ms})
        print(f"  K1 at q_offset {off} ({out['shape']}, bf16, causal): {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, SDPA with causal_lower_right {library_ms:.4f} ms "
              f"({ms / library_ms:.2f}x; vs plain {lib_err:.3e}), SDPA with a boolean mask "
              f"{mask_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of the bound", flush=True)
    return out


def check_k2_local_heads(gen) -> dict:
    """K2 as each rank of a model=``K2_LOCAL_TP`` mesh runs it
    (``ssm._local_ssd``: its heads of x, dt, A, B/C whole), at the prefill
    shapes of ``K2_SHAPES`` in bf16 and f32: every rank's call bit-equal to
    those heads of the whole call (y and the final state), rank 0's held
    against the plain version and timed beside its bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.ssm import ssd_chunked
    at = {}
    for arch, (b, s, h, p, n, chunk) in K2_SHAPES.items():
        hl = h // K2_LOCAL_TP
        for dtype in (torch.bfloat16, torch.float32):
            x, dt, A, B, C, _ = ssd_inputs(gen, b, s, h, p, n, dtype, dtype)
            y, st = ops.ssd(x, dt, A, B, C, chunk=chunk)
            equal = True
            for r in range(K2_LOCAL_TP):
                sl = slice(r * hl, (r + 1) * hl)
                local = [t[:, :, sl].contiguous() for t in (x, dt)] + [A[sl].contiguous()]
                yl, stl = ops.ssd(*local, B, C, chunk=chunk)
                equal &= torch.equal(yl, y[:, :, sl]) and torch.equal(stl, st[:, sl])
            local = [t[:, :, :hl].contiguous() for t in (x, dt)] + [A[:hl].contiguous()]
            yl, stl = ops.ssd(*local, B, C, chunk=chunk)
            y_c, st_c = ssd_chunked(*local, B, C, chunk)
            tol = K2_REF_TOL[_dtype_name(dtype)] if dtype == torch.bfloat16 else K2_CHUNKED_TOL
            err = max(_k2_err(f"{arch} local heads ({hl} of {h}) y vs ssd_chunked", yl, y_c,
                              tol),
                      _k2_err(f"{arch} local heads state vs ssd_chunked", stl, st_c, tol))
            _check(equal, f"K2 on {arch}'s local heads differs from the whole call's heads")
            if dtype != torch.bfloat16:
                continue
            ms = time_ms(lambda: ops.ssd(*local, B, C, chunk=chunk))
            plain_ms = time_ms(lambda: ssd_chunked(*local, B, C, chunk), iters=10, warmup=2)
            bound_ms, bound_by = ssd_bound(b, s, hl, p, n, chunk, dtype, dtype)
            label = f"{arch}, a model={K2_LOCAL_TP} rank's local heads"
            at[label] = {"shape": "b,s,h,p,n,chunk=" + ",".join(map(str, (b, s, hl, p, n,
                                                                          chunk))),
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                         "bit_equal_to_the_whole_call": equal}
            print(f"[10] (g) K2 on {label} ({at[label]['shape']}, bf16): {ms:.4f} ms, plain "
                  f"ssd_chunked {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{bound_ms / ms:.1%} of the bound; each of the {K2_LOCAL_TP} ranks' calls "
                  f"bit-equal to its heads of the whole call (bf16 and f32): {equal}",
                  flush=True)
    return at


def _dry_run_args() -> list:
    """Phase 11's command lines of ``python -m repro_torch.launch.dryrun``."""
    arch, shape, layers, accum = DRYRUN_MULTI_POD
    cut = DRYRUN_SCOUT_CUT
    return [["--arch", DRYRUN_FULL[0], "--shape", DRYRUN_FULL[1]],
            ["--arch", ",".join(DRYRUN_SEGMENT_ARCHS), "--shape", DRYRUN_SEGMENT_SHAPE,
             "--segment"],
            ["--arch", arch, "--shape", shape, "--mesh", "multi", "--layers", str(layers),
             "--grad-accum", str(accum)],
            ["--arch", cut[0], "--shape", cut[1], "--mesh", "single", "--layers",
             str(cut[2]), "--grad-accum", str(cut[3])]] + [
            ["--arch", DRYRUN_SCOUT_FULL[0], "--shape", DRYRUN_SCOUT_FULL[1], "--mesh", m]
            for m in ("single", "multi")]


def start_dry_run() -> dict:
    """Phase 11's traces, each a subprocess started at once on the ``fake``
    backend (meta tensors, nothing launched), niced and with no card visible,
    their output in a temporary directory; they are killed and the
    directory removed when this script exits."""
    import atexit
    import shutil
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    runs = []
    for k, args in enumerate(_dry_run_args()):
        log = open(Path(out) / f"run{k}.log", "w")
        proc = subprocess.Popen(["nice", "-n", "19", sys.executable, "-m",
                                 "repro_torch.launch.dryrun", *args, "--out",
                                 str(Path(out) / "cells")], stdout=log,
                                stderr=subprocess.STDOUT, cwd=str(ROOT), env=env)
        runs.append((args, proc, log))

    def stop():
        for _, proc, log in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(out, ignore_errors=True)
    atexit.register(stop)
    return {"out": Path(out), "runs": runs, "t0": time.perf_counter()}


def _peak_holders(ma: dict) -> str:
    return "; ".join(f"{h['bytes'] / 1e9:.3f} GB {h['op']} {h['dtype']}{h['shape']} "
                     f"x{h['count']}" for h in ma["peak_holders"][:3])


def dry_run_cells(started: dict) -> list:
    """Phase 11: waits for ``start_dry_run``'s traces: ``DRYRUN_FULL`` at
    full depth, ``DRYRUN_SEGMENT_SHAPE`` of each of ``DRYRUN_SEGMENT_ARCHS``
    cut to one segment, ``DRYRUN_MULTI_POD`` on 512 ranks, held to JAX's
    FLOPs and temp of the same cut, ``DRYRUN_SCOUT_CUT`` on 256, held to
    JAX's FLOPs, and ``DRYRUN_SCOUT_FULL`` on both, held to JAX's temp.
    Prints each cell's per-device numbers; an erring cell, or a train cell
    whose gradient leaves ``autograd.grad`` larger than its param's shard,
    fails the run."""
    cells = []
    arch, shape, layers, accum = DRYRUN_MULTI_POD
    cut = DRYRUN_SCOUT_CUT
    deadline = started["t0"] + DRYRUN_TIMEOUT_S
    for args, proc, log in started["runs"]:
        try:
            rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        log.flush()
        print(f"[11] python -m repro_torch.launch.dryrun {' '.join(args)}: exit {rc}",
              flush=True)
        _check(rc == 0, f"the dry run failed:\n{Path(log.name).read_text()[-3000:]}")
    print(f"[11] the traces ended by {time.perf_counter() - started['t0']:.1f} s after their "
          f"start (after [1])", flush=True)
    for path in sorted((started["out"] / "cells").glob("*.json")):
        c = json.loads(path.read_text())
        _check(c["status"] == "ok", f"dry-run cell {path.stem}: {c}")
        per, ma, rf = c["trace_per_device"], c["memory_analysis"], c["roofline"]
        print(f"[11] {c['arch']} x {c['shape']} ({c['n_layers']} layers) on {c['mesh']} "
              f"({c['n_chips']} ranks, traced in {c['trace_s']} s): per device "
              f"{per['flops']:.4e} FLOPs, collectives "
              f"{json.dumps({k: round(v) for k, v in per['collective_bytes'].items()})} B, "
              f"arguments {ma['argument_bytes']} B, temp {ma['temp_bytes']} B; "
              f"roofline terms (arithmetic on the data-sheet peaks) compute "
              f"{rf['compute_s'] * 1e3:.3f} ms, memory {rf['memory_s'] * 1e3:.3f} ms, "
              f"collective {rf['collective_s'] * 1e3:.3f} ms, dominant {rf['dominant']}; "
              f"useful_flops_ratio {c['useful_flops_ratio']:.3f}", flush=True)
        shards = c.get("grad_shards")
        if shards:
            print(f"[11] {path.stem}: {len(shards['larger'])} of {shards['leaves']} "
                  f"gradient leaves left autograd.grad larger than their param's shard"
                  + "".join(f"; {g['leaf']} {g['grad']} (shard {g['shard']})"
                            for g in shards["larger"]), flush=True)
            _check(not shards["larger"], f"{path.stem}: gradients larger than their "
                   f"shard: {shards['larger']}")
        cells.append(c)
    _check(len(cells) == 5 + len(DRYRUN_SEGMENT_ARCHS), f"{len(cells)} dry-run cells")
    _check(sum(1 for c in cells if c.get("grad_shards")) == 5, "five train cells")
    full = next(c for c in cells if (c["arch"], c["shape"]) == DRYRUN_FULL)
    ma = full["memory_analysis"]
    print(f"[11] {DRYRUN_FULL[0]} x {DRYRUN_FULL[1]} at full depth, a device: temp "
          f"{ma['temp_bytes'] / 1e9:.3f} GB (JAX's temp_size_in_bytes, compiled on a CPU: "
          f"{JAX_DRYRUN_FULL_TEMP_BYTES / 1e9:.2f} GB; "
          f"{ma['temp_bytes'] / JAX_DRYRUN_FULL_TEMP_BYTES:.3f}x), arguments + temp "
          f"{ma['peak_bytes_per_device'] / 1e9:.3f} GB (limit {DRYRUN_DEVICE_BYTES / 1e9:g} GB); "
          f"held at the peak by {_peak_holders(ma)}", flush=True)
    _check(ma["peak_bytes_per_device"] <= DRYRUN_DEVICE_BYTES,
           f"{DRYRUN_FULL}: {ma['peak_bytes_per_device']} B a device")
    pod = next(c for c in cells if c["mesh"] == "pod2x16x16" and c["n_layers"] == layers)
    flops, ma = pod["trace_per_device"]["flops"], pod["memory_analysis"]
    print(f"[11] {arch} x {shape} on pod2x16x16 cut to {layers} layers at grad_accum "
          f"{accum}, a device: FLOPs {flops:.4e} (JAX's hlo_analysis of the same cut, "
          f"compiled on a CPU: {JAX_DRYRUN_MULTI_POD_FLOPS:.4e}; "
          f"{flops / JAX_DRYRUN_MULTI_POD_FLOPS:.3f}x), temp {ma['temp_bytes'] / 1e9:.3f} GB "
          f"(JAX's {JAX_DRYRUN_MULTI_POD_TEMP_BYTES / 1e9:.3f} GB; "
          f"{ma['temp_bytes'] / JAX_DRYRUN_MULTI_POD_TEMP_BYTES:.3f}x), arguments "
          f"{ma['argument_bytes']} B (JAX's {JAX_DRYRUN_MULTI_POD_ARGUMENT_BYTES} B); held "
          f"at the peak by {_peak_holders(ma)}", flush=True)
    _check(flops <= JAX_DRYRUN_MULTI_POD_FLOPS,
           f"{DRYRUN_MULTI_POD}: {flops:.4e} FLOPs a device, above JAX's")
    _check(ma["temp_bytes"] <= JAX_DRYRUN_MULTI_POD_TEMP_BYTES,
           f"{DRYRUN_MULTI_POD}: temp {ma['temp_bytes']} B, above JAX's")
    _check(ma["argument_bytes"] == JAX_DRYRUN_MULTI_POD_ARGUMENT_BYTES,
           f"{DRYRUN_MULTI_POD}: arguments {ma['argument_bytes']} B, not JAX's")
    single = next(c for c in cells if c["mesh"] == "pod16x16" and c["arch"] == cut[0]
                  and c["n_layers"] == cut[2])
    flops, ma = single["trace_per_device"]["flops"], single["memory_analysis"]
    print(f"[11] {cut[0]} x {cut[1]} on pod16x16 cut to {cut[2]} layers at grad_accum "
          f"{cut[3]}, a device: FLOPs {flops:.4e} (JAX's hlo_analysis of the same cut, "
          f"compiled on a CPU: {JAX_DRYRUN_SCOUT_CUT_FLOPS:.4e}; "
          f"{flops / JAX_DRYRUN_SCOUT_CUT_FLOPS:.3f}x, limit {DRYRUN_SCOUT_CUT_FLOPS_RATIO}x), "
          f"temp {ma['temp_bytes'] / 1e9:.3f} GB (JAX's "
          f"{JAX_DRYRUN_SCOUT_CUT_TEMP_BYTES / 1e9:.3f} GB; "
          f"{ma['temp_bytes'] / JAX_DRYRUN_SCOUT_CUT_TEMP_BYTES:.3f}x); held at the peak by "
          f"{_peak_holders(ma)}", flush=True)
    _check(flops <= DRYRUN_SCOUT_CUT_FLOPS_RATIO * JAX_DRYRUN_SCOUT_CUT_FLOPS,
           f"{DRYRUN_SCOUT_CUT}: {flops:.4e} FLOPs a device, above "
           f"{DRYRUN_SCOUT_CUT_FLOPS_RATIO}x JAX's")
    for mesh, jax_temp in JAX_DRYRUN_SCOUT_FULL_TEMP_BYTES.items():
        c = next(c for c in cells if (c["arch"], c["shape"]) == DRYRUN_SCOUT_FULL
                 and c["mesh"] == mesh and c["n_layers"] != cut[2])
        ma = c["memory_analysis"]
        print(f"[11] {c['arch']} x {c['shape']} on {mesh} at full depth ({c['n_layers']} "
              f"layers), a device: temp {ma['temp_bytes'] / 1e9:.3f} GB (JAX's "
              f"{jax_temp / 1e9:.2f} GB; {ma['temp_bytes'] / jax_temp:.3f}x), FLOPs "
              f"{c['trace_per_device']['flops']:.4e}; held at the peak by {_peak_holders(ma)}",
              flush=True)
        _check(ma["temp_bytes"] <= jax_temp,
               f"{DRYRUN_SCOUT_FULL} on {mesh}: temp {ma['temp_bytes']} B, above JAX's")
    return cells


def init_world_of_one():
    """The default process group of one rank on this card (NCCL, a free
    localhost port) and the (data=1, model=1) mesh over it."""
    import socket
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    return make_mesh((1, 1), ("data", "model"))


def elastic_resume(cfg, *, device: str, mesh, ckpt_dir, batch: int, seq_len: int,
                   steps: int = ELASTIC_STEPS, every: int = ELASTIC_CKPT_EVERY,
                   more: int = ELASTIC_MORE) -> dict:
    """``ElasticRunner`` at world size 1 (no mesh, as in the JAX package):
    ``steps`` steps checkpointed every ``every``, then a new runner on the
    same directory restores the last and takes ``more`` steps. Then that
    checkpoint is restored into ``mesh``'s placements
    (``restore(shardings=)``) and held bit-equal to a plain restore of it."""
    import torch
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.parallel.sharding import whole
    from repro_torch.runtime.elastic import ElasticRunner
    from repro_torch.runtime.train import TrainRunConfig, build_train_step
    from repro_torch.tree import tree_flatten_with_path

    rc = train_rc(device)
    trc = TrainRunConfig(opt=OptConfig(warmup_steps=2, total_steps=steps + more))
    kw = dict(rc=rc, trc=trc, ckpt_every=every)
    first = ElasticRunner(cfg, batch, seq_len, str(ckpt_dir), **kw)
    run1 = first.run(iter(synthetic_data(cfg, batch, seq_len)), steps=steps)
    del first
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    second = ElasticRunner(cfg, batch, seq_len, str(ckpt_dir), **kw)
    run2 = second.run(iter(synthetic_data(cfg, batch, seq_len)), steps=more)
    ckpt = second.ckpt
    del second
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    _, state_meta, _, st_sh, _, _ = build_train_step(cfg, mesh, B=batch, S=seq_len,
                                                     rc=rc, trc=trc)
    t0 = time.perf_counter()
    placed = tree_flatten_with_path(ckpt.restore(state_meta, step=steps, shardings=st_sh))
    restore_s = time.perf_counter() - t0
    plain = tree_flatten_with_path(ckpt.restore(state_meta, step=steps, device=device))
    equal = placed.keys() == plain.keys() and all(
        torch.equal(whole(placed[k]), plain[k]) for k in plain)
    placements = sorted({str(tuple(v.placements)) for v in placed.values()})
    del placed, plain
    return {"run1": run1, "run2": run2, "restore_shardings_s": restore_s,
            "restore_shardings_equal": equal, "placements": placements}


def mesh_paths(cfg, trained: dict, served_tokens: dict, serve_ms: dict,
               hybrid_losses: list, remat_rc, t_phase: float) -> dict:
    """Phase 10: the mesh paths of training and serving and the elastic
    runner on one card, a world of one NCCL rank; its counts set to 0
    before each run: (b)-(d) qwen2-0.5b's, then (e), (f) the
    ``MESH_SERVE_ARCHS`` served against [3]'s tokens (``served_tokens``;
    [3]'s times ``serve_ms`` printed beside),
    (g) zamba2-1.2b's train steps against [7]'s losses (``hybrid_losses``,
    under ``remat_rc``) and K2 on a model=4 rank's local heads, (h)
    qwen2-0.5b's steps at grad_accum ``MESH_ACCUM`` against the same steps
    without a mesh (bit-equal: the micro-batches are one process's). Returns
    the mesh path's launch counts and numbers."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config

    mesh = init_world_of_one()
    print(f"[10] world of {dist.get_world_size()} ({dist.get_backend()}), mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {mesh.device_type}", flush=True)
    ce_calls = []
    with count_sharded_ce(ce_calls):
        res = train(cfg, device="cuda", batch=TRAIN_BATCH, seq_len=TRAIN_LEN,
                    steps=TRAIN_STEPS, mesh=mesh)
    losses = [m["loss"] for m in res["metrics"]]
    plain = [m["loss"] for m in trained["metrics"]]
    diff = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    for i, (met, ms, la) in enumerate(zip(res["metrics"], res["step_ms"],
                                          res["launches_per_step"]), 1):
        print(f"[10] (b) {ARCH} mesh train step {i}: loss {met['loss']:.6f} (no mesh "
              f"{plain[i - 1]:.6f}) grad_norm {met['grad_norm']:.6f}, {ms:.3f} ms, "
              f"launches {la}", flush=True)
    print(f"[10] (b) {ARCH} on the (1, 1) mesh: {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_LEN} tokens: median step (2-{TRAIN_STEPS}) {res['median_step_ms']:.3f} ms "
          f"(no mesh, [5]: {trained['median_step_ms']:.3f} ms), "
          f"{res['tokens_per_s']:.1f} trained tokens/s, max_memory_allocated "
          f"{res['max_memory_allocated']} B ([5]: {trained['max_memory_allocated']} B); "
          f"losses vs [5]: max rel diff {diff:.3e} (tol {MESH_STEP_TOL:g}), bit-equal "
          f"{losses == plain}; the loss on the vocab-sharded CE {len(ce_calls)} times, "
          f"local logits {sorted(set(ce_calls))}", flush=True)
    per_step = {"attention": cfg.n_layers, "ssd": 0}
    _check(diff <= MESH_STEP_TOL, f"mesh train losses {losses} vs no mesh {plain}")
    _check(len(ce_calls) == TRAIN_STEPS, f"the vocab-sharded CE ran {len(ce_calls)} times")
    _check(all(la == per_step for la in res["launches_per_step"]),
           f"mesh train steps launched {res['launches_per_step']}, not {per_step} each")
    mesh_train = {ARCH: {"median_step_ms": res["median_step_ms"],
                         "no_mesh_median_step_ms": trained["median_step_ms"],
                         "max_memory_allocated": res["max_memory_allocated"],
                         "losses_max_rel_diff": diff, "losses_bit_equal": losses == plain}}
    train_launches = res["launches_per_step"][0]["attention"]
    torch.cuda.empty_cache()
    t_phase = _phase_done(10, t_phase, "(b)")

    kw = dict(device="cuda", batch=SERVE_BATCH, prompt_len=PROMPT_LEN,
              decode_steps=DECODE_STEPS)
    plain = serve(cfg, **kw)
    sv = serve(cfg, mesh=mesh, **kw)
    same = torch.equal(sv["tokens"], plain["tokens"])
    print(f"[10] (c) {ARCH} served on the (1, 1) mesh: {SERVE_BATCH} requests of "
          f"{PROMPT_LEN} tokens + {DECODE_STEPS} decode steps: prefill "
          f"{sv['prefill_ms']:.3f} ms, decode {sv['decode_ms_per_step']:.3f} ms/step (no "
          f"mesh, run just before: {plain['prefill_ms']:.3f} ms, "
          f"{plain['decode_ms_per_step']:.3f} ms/step), launches: prefill "
          f"{sv['prefill_launches']}, request {sv['request_launches']}; greedy tokens equal "
          f"to that no-mesh run's: {same} (to [3]'s, earlier in the process: "
          f"{torch.equal(sv['tokens'].cpu(), served_tokens[ARCH])})", flush=True)
    _check(same, "the mesh path's greedy tokens differ from the no-mesh serve's")
    _check(sv["prefill_launches"] == per_step and sv["request_launches"] == per_step,
           f"mesh serve launched {sv['prefill_launches']}, {sv['request_launches']}")
    # the counts this run measured: the first train step's, the prefill's,
    # and the decode steps' (the request's beyond its prefill) per step
    launches = {"train_per_step": train_launches,
                "prefill": sv["prefill_launches"]["attention"],
                "decode_per_step": (sv["request_launches"]["attention"]
                                    - sv["prefill_launches"]["attention"]) / DECODE_STEPS}
    mesh_serve = {ARCH: {**{k: sv[k] for k in ("prefill_ms", "decode_ms_per_step")},
                         **{f"no_mesh_{k}": plain[k]
                            for k in ("prefill_ms", "decode_ms_per_step")}}}
    launches_by_arch = {ARCH: {"prefill": sv["prefill_launches"],
                               "train_per_step": res["launches_per_step"][0]}}
    del sv, plain
    torch.cuda.empty_cache()
    t_phase = _phase_done(10, t_phase, "(c)")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_") as ckpt_dir:
        el = elastic_resume(cfg, device="cuda", mesh=mesh, ckpt_dir=ckpt_dir,
                            batch=TRAIN_BATCH, seq_len=TRAIN_LEN)
    run1, run2 = el["run1"], el["run2"]
    print(f"[10] (d) ElasticRunner at world size 1: {ELASTIC_STEPS} steps, checkpoints every "
          f"{ELASTIC_CKPT_EVERY}: losses {run1['losses']}, events {run1['events']}; a new "
          f"runner on the same directory: events {run2['events']}, {ELASTIC_MORE} more steps "
          f"losses {run2['losses']}, final step {run2['final_step']}; the step-"
          f"{ELASTIC_STEPS} checkpoint restored into the mesh's placements "
          f"{el['placements']} in {el['restore_shardings_s']:.2f} s: bit-equal to a plain "
          f"restore {el['restore_shardings_equal']}", flush=True)
    _check(run1["final_step"] == ELASTIC_STEPS and all(np.isfinite(run1["losses"])),
           f"elastic run: {run1}")
    _check(f"restored step={ELASTIC_STEPS} mesh=None" in run2["events"]
           and run2["final_step"] == ELASTIC_STEPS + ELASTIC_MORE
           and all(np.isfinite(run2["losses"])), f"elastic resume: {run2}")
    _check(el["restore_shardings_equal"], "restore(shardings=) differs from a plain restore")
    t_phase = _phase_done(10, t_phase, "(d)")

    # (e), (f): the other families served on the mesh, tokens against [3]'s
    for arch in MESH_SERVE_ARCHS:
        part = "e" if arch == HYBRID_ARCH else "f"
        fam = get_config(arch)
        sv = serve(fam, device="cuda", batch=SERVE_BATCH, prompt_len=PROMPT_LEN,
                   decode_steps=DECODE_STEPS, mesh=mesh)
        expect, per_step = expected_launches(fam), expected_decode_launches(fam)
        expect_request = {k: n + DECODE_STEPS * per_step[k] for k, n in expect.items()}
        differ = int((sv["tokens"].cpu() != served_tokens[arch]).sum())
        same = differ == 0
        print(f"[10] ({part}) {arch} served on the (1, 1) mesh: {SERVE_BATCH} requests of "
              f"{PROMPT_LEN} tokens + {DECODE_STEPS} decode steps: prefill "
              f"{sv['prefill_ms']:.3f} ms, decode {sv['decode_ms_per_step']:.3f} ms/step "
              f"([3]: {serve_ms[arch][0]:.3f} ms, {serve_ms[arch][1]:.3f} ms/step), "
              f"max_memory_allocated {sv['max_memory_allocated']} B; launches: prefill "
              f"{sv['prefill_launches']}, request {sv['request_launches']}; greedy tokens "
              f"equal to [3]'s: {same} ({differ} differ)", flush=True)
        _check(same, f"{arch}: the mesh path's greedy tokens differ from [3]'s")
        _check(sv["prefill_launches"] == expect and sv["request_launches"] == expect_request,
               f"{arch} mesh serve launched {sv['prefill_launches']}, "
               f"{sv['request_launches']}, not {expect}, {expect_request}")
        mesh_serve[arch] = {**{k: sv[k] for k in ("prefill_ms", "decode_ms_per_step",
                                                  "max_memory_allocated")},
                            "no_mesh_prefill_ms": serve_ms[arch][0],
                            "no_mesh_decode_ms_per_step": serve_ms[arch][1]}
        launches_by_arch[arch] = {"prefill": sv["prefill_launches"],
                                  "decode_per_step": per_step}
        del sv
        torch.cuda.empty_cache()
        t_phase = _phase_done(10, t_phase, f"({part}) {arch}")

    # (g): zamba2-1.2b's train steps on the mesh against [7]'s; K2 on local heads
    hyb = get_config(HYBRID_ARCH)
    ce_calls = []
    with count_sharded_ce(ce_calls):
        tr = train(hyb, device="cuda", batch=TRAIN_BATCH, seq_len=TRAIN_LEN,
                   steps=TRAIN_STEPS, rc=remat_rc, lr=TRAIN_7_LR, mesh=mesh)
    losses = [m["loss"] for m in tr["metrics"]]
    diff = max(abs(a - b) / abs(b) for a, b in zip(losses, hybrid_losses))
    per_step = expected_train_launches(hyb, remat_rc)
    print(f"[10] (g) {HYBRID_ARCH} on the (1, 1) mesh, remat \"full\", ssd_chunk "
          f"{remat_rc.ssd_chunk}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_LEN} tokens: "
          f"losses {losses} ([7] (b): {hybrid_losses}; max rel diff {diff:.3e}, tol "
          f"{MESH_STEP_TOL:g}, bit-equal {losses == hybrid_losses}); median step (2-"
          f"{TRAIN_STEPS}) {tr['median_step_ms']:.3f} ms, max_memory_allocated "
          f"{tr['max_memory_allocated']} B; launches a step {tr['launches_per_step']}; "
          f"the loss on the vocab-sharded CE {len(ce_calls)} times, local logits "
          f"{sorted(set(ce_calls))}", flush=True)
    _check(diff <= MESH_STEP_TOL, f"{HYBRID_ARCH} mesh train losses {losses} vs "
           f"{hybrid_losses}")
    _check(len(ce_calls) == TRAIN_STEPS, f"the vocab-sharded CE ran {len(ce_calls)} times")
    _check(all(la == per_step for la in tr["launches_per_step"]),
           f"{HYBRID_ARCH} mesh train steps launched {tr['launches_per_step']}, not {per_step}")
    mesh_train[HYBRID_ARCH] = {"median_step_ms": tr["median_step_ms"],
                               "max_memory_allocated": tr["max_memory_allocated"],
                               "losses_max_rel_diff": diff,
                               "losses_bit_equal": losses == hybrid_losses}
    launches_by_arch[HYBRID_ARCH]["train_per_step"] = per_step
    del tr
    torch.cuda.empty_cache()
    t_phase = _phase_done(10, t_phase, "(g)")

    # (h): qwen2-0.5b at grad_accum 2, the mesh step against the no-mesh one
    kw = dict(device="cuda", batch=TRAIN_BATCH, seq_len=TRAIN_LEN, steps=MESH_ACCUM_STEPS,
              grad_accum=MESH_ACCUM)
    plain = [m["loss"] for m in train(cfg, **kw)["metrics"]]
    torch.cuda.empty_cache()
    acc = train(cfg, mesh=mesh, **kw)
    losses = [m["loss"] for m in acc["metrics"]]
    per_step = {k: MESH_ACCUM * n
                for k, n in expected_train_launches(cfg, train_rc("cuda")).items()}
    print(f"[10] (h) {ARCH} on the (1, 1) mesh at grad_accum {MESH_ACCUM}: "
          f"{MESH_ACCUM_STEPS} steps of {TRAIN_BATCH} x {TRAIN_LEN} tokens, each cut into "
          f"{MESH_ACCUM} micro-batches: losses {losses} (no mesh, the same steps: {plain}; "
          f"bit-equal {losses == plain}); median step {acc['median_step_ms']:.3f} ms; K1 "
          f"launches a step {[la['attention'] for la in acc['launches_per_step']]} "
          f"(expected {per_step['attention']})", flush=True)
    _check(losses == plain, f"mesh grad_accum {MESH_ACCUM} losses {losses} vs {plain}")
    _check(all(la == per_step for la in acc["launches_per_step"]),
           f"mesh grad_accum steps launched {acc['launches_per_step']}, not {per_step}")
    mesh_train[f"{ARCH}, grad_accum {MESH_ACCUM}"] = {
        "median_step_ms": acc["median_step_ms"], "losses_bit_equal": losses == plain}
    del acc
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    k2_local = check_k2_local_heads(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.empty_cache()
    _phase_done(10, t_phase, "(h), K2 on local heads")
    launches["by_arch"] = launches_by_arch
    return {"train": mesh_train, "serve": mesh_serve, "launches": launches,
            "k2_local_heads": k2_local,
            "k2_launches": {arch: {k: (v["ssd"] if isinstance(v, dict) else v)
                                   for k, v in n.items()}
                            for arch, n in launches_by_arch.items()
                            if get_config(arch).family in ("ssm", "hybrid")}}


# ---------------------------------------------------------------------------
def _phase_done(n: int, t0: float, what: str = "") -> float:
    """Print phase ``n``'s seconds since ``t0``; return the time now."""
    now = time.perf_counter()
    print(f"[{n}] {what + ' ' if what else ''}phase took {now - t0:.1f} s", flush=True)
    return now


def main() -> int:
    use_expandable_segments()
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
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[1] device: {kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    built = _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    for res in built.values():
        print(f"[1] built {res.name} in {res.seconds:.2f} s", flush=True)
        for line in res.ptxas.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"    {res.name}: {line.strip()}")
    dry_run = start_dry_run()
    t_phase = _phase_done(1, t_phase)

    # 2. K1 and K2 against their plain versions, and their times
    print("[2] K1 against its plain version", flush=True)
    k1 = check_k1(torch.Generator(device="cuda").manual_seed(SEED))
    print("[2] K2 against its plain versions", flush=True)
    k2 = check_k2(torch.Generator(device="cuda").manual_seed(SEED))
    t_phase = _phase_done(2, t_phase)

    # 3 and 4, for each model: serve at full width and depth in bf16, then f32
    # consistency
    served, decode_served, serve_ms, served_tokens = {}, {}, {}, {}
    for arch in SERVE_ARCHS:
        full = get_config(arch)
        cfg, label = cut_depth(arch, SERVE_LAYERS.get(arch))
        if arch in SERVE_LAYERS:
            print(f"[3] {label} (full widths): its bf16 params at full depth would be "
                  f"{_tree_bytes(full, torch.bfloat16) / 1e9:.1f} GB; cut, "
                  f"{_tree_bytes(cfg, torch.bfloat16) / 1e9:.1f} GB", flush=True)
        res = serve(cfg, device="cuda", batch=SERVE_BATCH, prompt_len=PROMPT_LEN,
                    decode_steps=DECODE_STEPS)
        print(f"[3] {arch} ({cfg.n_layers} layers): served {SERVE_BATCH} requests of "
              f"{PROMPT_LEN} tokens + {DECODE_STEPS} decode steps: prefill "
              f"{res['prefill_ms']:.3f} ms, decode {res['decode_ms_per_step']:.3f} ms/step, "
              f"{res['tokens_per_s']:.1f} generated tokens/s, "
              f"max_memory_allocated {res['max_memory_allocated']} B; launches: "
              f"prefill {res['prefill_launches']}, request {res['request_launches']}; "
              f"tokens sha256 {_digest(res['tokens'])}", flush=True)
        expect, per_step = expected_launches(cfg), expected_decode_launches(cfg)
        expect_request = {k: n + DECODE_STEPS * per_step[k] for k, n in expect.items()}
        _check(res["prefill_launches"] == expect,
               f"{arch} prefill launched {res['prefill_launches']}, not {expect}")
        _check(res["request_launches"] == expect_request,
               f"{arch} request launched {res['request_launches']}, not {expect_request} "
               f"(prefill {expect} + {DECODE_STEPS} steps x {per_step})")
        served[arch] = res["prefill_launches"]
        if arch == ARCH or arch in MESH_SERVE_ARCHS:
            served_tokens[arch] = res["tokens"].cpu()
        decode_served[arch] = per_step
        serve_ms[arch] = (res["prefill_ms"], res["decode_ms_per_step"])
        del res
        torch.cuda.empty_cache()             # the bf16 model is gone before [4]
        t_phase = _phase_done(3, t_phase, arch)

        layers = CONSISTENCY_LAYERS.get(arch, full.n_layers)
        cut = (f" cut to {layers} layers (full widths; its f32 params at full depth "
               f"alone are {_tree_bytes(full, torch.float32) / 1e9:.1f} GB)"
               if layers != full.n_layers else "")
        errs = consistency(dataclasses.replace(full, n_layers=layers), device="cuda",
                           prefill_batch=SERVE_BATCH, prefill_len=PROMPT_LEN, batch=2,
                           seq_len=96, split=32)
        print(f"[4] {arch}{cut}: f32 consistency: {json.dumps(errs)}", flush=True)
        if cfg.n_experts:
            print(f"[4] {arch}: {errs['routing_flips']} of {SERVE_BATCH * PROMPT_LEN} "
                  f"tokens x {errs['moe_layers']} layers take other top-k choices "
                  f"with the kernels than with their plain versions; the prefill bound is held "
                  f"on the {errs['requests_held']} of {errs['requests']} requests routed alike "
                  f"throughout; decode vs forward at capacity_factor {DECODE_MOE_CAPACITY:g} "
                  f"(drop-free: capacity drops depend on the batch)", flush=True)
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
    bf16, f32 = torch.bfloat16, torch.float32
    k1_grad = check_k1_grad(torch.Generator(device="cuda").manual_seed(SEED), [
        (TRAIN_BATCH, TRAIN_LEN, TRAIN_LEN, 14, K, 64, dtype, causal)   # qwen2-0.5b's
        for K in (2, 14) for dtype in (bf16, f32) for causal in (True, False)])
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
          f"{res['resume_loss_err']:.3e}, params {res['resume_params_err']:.3e}; losses "
          f"{[m['loss'] for m in res['metrics']]}", flush=True)
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
    torch.cuda.synchronize()
    ops_before, mem_before = _launches(), torch.cuda.memory_allocated()
    twins = example_twins()
    _check(_launches() == ops_before and torch.cuda.memory_allocated() == mem_before,
           "the host-only example twins touched the card")
    for twin, text in twins.items():
        print(f"[6] repro_torch.examples.{twin}:\n" + "\n".join(
            "    " + line for line in text.splitlines()), flush=True)
    engines = [line for line in twins["quickstart"].splitlines() if "order_consistent=" in line]
    rows = twins["multi_workflow"].splitlines()
    _check(len(engines) == 3 and all("order_consistent=True" in line for line in engines),
           f"quickstart twin: {engines}")
    _check(rows[-1] == "OK" and sum(line.endswith(" True") for line in rows) == 4,
           f"multi_workflow twin: {rows}")
    shards = sharded_plane_checks(mm["outputs"]["0"])
    print(f"[6] ShardedControlPlane, {len(SHARD_TENANTS)} shards, a diamond of "
          f"matmul_payload(n={MATMUL_N}, iters={MATMUL_ITERS}) pods per tenant "
          f"{list(SHARD_TENANTS)}, processes=False, payload_mode=\"real\": every workflow "
          f"completed, order by tenant {json.dumps(shards['pod_order'])}, pods by shard "
          f"{json.dumps(shards['pods_by_shard'])}, bytes each pod allocated on the card "
          f"{shards['device_bytes']}, outputs bit-equal to the unsharded diamond's; the plane "
          f"with virtual payloads, processes=True: merged tenant summary equal to "
          f"processes=False; processes=True with the card's payloads (CUDA initialised in "
          f"the parent): {json.dumps(shards['forked_card_failure'])}", flush=True)
    t_phase = _phase_done(6, t_phase)

    # 7. the ssm and hybrid families' training, and remat
    torch.cuda.empty_cache()
    print("[7] (a) K2 under a gradient against autograd through its plain versions",
          flush=True)
    k2_train = check_k2_grad(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.empty_cache()
    t_phase = _phase_done(7, t_phase, "(a)")
    remat_rc = train_rc("cuda", remat=True, remat_policy="full", ssd_chunk=SSD_TRAIN_CHUNK)
    train_launches, hybrid_losses = {}, []
    for part, arch, layers, steps in (("b", HYBRID_ARCH, None, TRAIN_STEPS),
                                      ("c", SSM_ARCH, SSM_TRAIN_LAYERS, SSM_TRAIN_STEPS),
                                      ("d", DENSE_REMAT_ARCH, None, DENSE_REMAT_STEPS)):
        cfg, label = cut_depth(arch, layers)
        train_launches[label] = train_and_check(
            f"[7] ({part})", cfg, label, steps=steps, rc=remat_rc,
            losses_out=hybrid_losses if arch == HYBRID_ARCH else None)
        t_phase = _phase_done(7, t_phase, f"({part}) {arch}")

    cut = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=HYBRID_PLAIN_LAYERS)
    errs = train_consistency(cut, device="cuda", batch=TRAIN_BATCH, seq_len=TRAIN_LEN,
                             remat=True, remat_policy="full", ssd_chunk=SSD_TRAIN_CHUNK)
    print(f"[7] (e) {HYBRID_ARCH} cut to {HYBRID_PLAIN_LAYERS} layers, remat \"full\": f32 "
          f"train step, kernels vs plain: {json.dumps(errs)}", flush=True)
    _check(errs["loss_rel"] <= TRAIN_PLAIN_TOL and errs["grad_norm_rel"] <= TRAIN_PLAIN_TOL
           and errs["params_abs"] <= TRAIN_PLAIN_TOL
           and max(errs["grads_rel"].values()) <= TRAIN_PLAIN_TOL,
           f"f32 hybrid train step, kernels vs plain, exceeds {TRAIN_PLAIN_TOL}: {errs}")
    nonzero = ([f"blocks/mamba/{w}" for w in ("in_x", "in_B", "in_C", "in_dt", "A_log")]
               + [f"shared_block/attn/{w}" for w in ("wq", "wk", "wv")])
    _check(all(errs["grads_scale"][key] > 0 for key in nonzero),
           f"a zero gradient among {nonzero}: {errs['grads_scale']}")
    torch.cuda.empty_cache()
    agree = remat_agreement(cut, device="cuda", batch=TRAIN_BATCH, seq_len=TRAIN_LEN)
    print(f"[7] (f) {HYBRID_ARCH} cut to {HYBRID_PLAIN_LAYERS} layers, f32 forward + "
          f"backward, remat off / \"full\" / \"dots\": {json.dumps(agree)}", flush=True)
    for policy, run in agree.items():
        _check(run["loss_rel"] <= REMAT_LOSS_TOL and run["grads_rel"] <= REMAT_GRAD_TOL,
               f"remat {policy} changes the loss or the gradients: {run}")
        _check(run["launches"] == expected_train_launches(
                   cut, remat_rc.replace(remat=policy != "off")),
               f"remat {policy} launched {run['launches']}")
    torch.cuda.empty_cache()
    t_phase = _phase_done(7, t_phase, "(e, f)")

    # 8. the moe, audio and vlm families' training
    k1_cross_grad, trained = train_moe_audio_vlm(remat_rc, t_phase)
    train_launches.update(trained)

    # 9. gemma-7b's training: K1 at hd 256 under a gradient
    k1_gemma_grad, trained = train_gemma(remat_rc, time.perf_counter())
    train_launches.update(trained)

    # 10. K1 at a query offset; the mesh paths and the elastic runner at world size 1
    t_phase = time.perf_counter()
    print("[10] (a) K1 at a query offset (row blocks of a \"seq\" mesh)", flush=True)
    k1_offset = check_k1_offset(torch.Generator(device="cuda").manual_seed(SEED))
    t_phase = _phase_done(10, t_phase, "(a)")
    mesh_run = mesh_paths(get_config(ARCH), res, served_tokens, serve_ms, hybrid_losses,
                          remat_rc, t_phase)
    k2["at"].update(mesh_run.pop("k2_local_heads"))
    k2["mesh_launches"] = mesh_run.pop("k2_launches")

    # 11. the dry run of launch/ on the fake backend
    t_phase = time.perf_counter()
    dry_run_cells(dry_run)
    _phase_done(11, t_phase)

    # 12. results; the ok line is last
    # launches: the sum over the served models' timed prefills (each counted
    # from 0), and per model
    for entry, kernel in ((k1, "attention"), (k2, "ssd")):
        entry["launches_by_arch"] = {arch: n[kernel] for arch, n in served.items()}
        entry["launches"] = sum(entry["launches_by_arch"].values())
        entry["decode_launches_per_step_by_arch"] = {
            arch: n[kernel] for arch, n in decode_served.items() if n[kernel]}
    k1["train_launches_per_step"] = res["launches_per_step"][0]["attention"]
    train_launches[ARCH] = res["launches_per_step"][0]
    for entry, kernel in ((k1, "attention"), (k2, "ssd")):
        entry["train_launches_per_step_by_arch"] = {
            arch: n[kernel] for arch, n in train_launches.items() if n[kernel]}
    k2["at"].update(k2_train)
    k1.update({f"train_{key}": val for key, val in k1_grad.items()})
    k1["at"][f"{K1_CROSS_TRAIN}, under a gradient"] = k1_cross_grad
    k1["at"][f"{GEMMA_ARCH}, under a gradient"] = k1_gemma_grad
    k1["workflow_serve_launches_by_pod"] = serve_pod_launches
    k1["workflow_train_launches_per_step"] = tw["step_k1_launches"][0]
    k1["workflow_eval_launches"] = tw["pod_k1_launches"]["eval"][0]
    k1["at"][f"{ARCH}, q_offset"] = k1_offset
    k1["mesh_launches"] = mesh_run["launches"]
    k1["mesh_train"] = mesh_run["train"]
    k1["mesh_serve"] = mesh_run["serve"]
    print(json.dumps({"kernels": [k1, k2]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
