"""Hill-climbing runner: re-trace one cell under named variants.

The port's counterpart of the JAX package's ``repro/launch/perf.py``.
Each variant overrides RunConfig / ShardingPolicy / TrainRunConfig knobs
and writes a tagged artifact next to the baseline's, so the per-device
terms of two variants can be diffed. The reference's attention-dispatch
variants (``chunk512``, ``chunk2048``, ``densattn``, and
``attn_dense_max`` in ``best_dense``) have no counterpart: one K1 call
serves every prefill length.

  PYTHONPATH=src python -m repro_torch.launch.perf --cell deepseek-67b:train_4k \\
      --variant accum8
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import (DEFAULT_OUT, init_fake_world, make_runconfig,
                                       pick_grad_accum, run_cell)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim.adamw import OptConfig
from repro_torch.parallel.sharding import ShardingPolicy
from repro_torch.runtime.train import TrainRunConfig


def variants_for(cfg, shape):
    """Named knob bundles. Each is (rc, policy, trc)."""
    base_rc = make_runconfig(cfg, shape)
    base_trc = TrainRunConfig(opt=OptConfig(),
                              grad_accum=pick_grad_accum(cfg, shape))
    pol = ShardingPolicy()

    def trc_accum(a):
        return TrainRunConfig(opt=OptConfig(), grad_accum=a)

    return {
        "baseline": (base_rc, pol, base_trc),
        # microbatching: fewer FSDP weight regathers vs more activations
        "accum4": (base_rc, pol, trc_accum(4)),
        "accum8": (base_rc, pol, trc_accum(8)),
        "accum2": (base_rc, pol, trc_accum(2)),
        # params kept bf16 (no f32 master copies)
        "bf16params": (base_rc.replace(param_dtype=torch.bfloat16), pol, base_trc),
        # no FSDP: pure TP + replicated storage (small models only)
        "nofsdp": (base_rc, ShardingPolicy(fsdp=False), base_trc),
        # remat policy: save matmul outputs instead of recomputing everything
        "rematdots": (base_rc.replace(remat_policy="dots"), pol, base_trc),
        "noremat": (base_rc.replace(remat=False), pol, base_trc),
        # MoE dispatch group sizing
        "moegroup4096": (base_rc.replace(moe_group=4096), pol, base_trc),
        "moegroup1024": (base_rc.replace(moe_group=1024), pol, base_trc),
        "moegroup8192": (base_rc.replace(moe_group=8192), pol, base_trc),
        "moe8192_accum8": (base_rc.replace(moe_group=8192), pol, trc_accum(8)),
        "moe8192_accum4": (base_rc.replace(moe_group=8192), pol, trc_accum(4)),
        "moe16384_accum4": (base_rc.replace(moe_group=16384), pol, trc_accum(4)),
        "moe8192_a8_bf16": (base_rc.replace(moe_group=8192, param_dtype=torch.bfloat16),
                            pol, trc_accum(8)),
        "moe8192_a8_bf16_ax": (base_rc.replace(moe_group=8192, param_dtype=torch.bfloat16,
                                               attn_exit_constrain=True), pol, trc_accum(8)),
        "attnexit": (base_rc.replace(attn_exit_constrain=True), pol, base_trc),
        # Megatron-SP residual carries (layer-stash / collective trade)
        "spcarry": (base_rc.replace(seq_shard_carry=True), pol, base_trc),
        "spcarry_accum8": (base_rc.replace(seq_shard_carry=True), pol, trc_accum(8)),
        "spcarry_accum4": (base_rc.replace(seq_shard_carry=True), pol, trc_accum(4)),
        "spcarry_dots": (base_rc.replace(seq_shard_carry=True, remat_policy="dots"), pol,
                         base_trc),
        "spcarry_noremat": (base_rc.replace(seq_shard_carry=True, remat=False), pol,
                            base_trc),
        # combined best-known (deepseek cell): SP carries + accum4 + bf16 params
        "best_dense": (base_rc.replace(seq_shard_carry=True, param_dtype=torch.bfloat16),
                       pol, trc_accum(4)),
        "sp_a4_bf16": (base_rc.replace(seq_shard_carry=True, param_dtype=torch.bfloat16),
                       pol, trc_accum(4)),
        # SSD chunk sizing (ssm/hybrid)
        "ssdchunk128": (base_rc.replace(ssd_chunk=128), pol, base_trc),
        "ssdchunk32": (base_rc.replace(ssd_chunk=32), pol, base_trc),
        "ssdchunk16": (base_rc.replace(ssd_chunk=16), pol, base_trc),
    }


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--segment", action="store_true",
                    help="cut the arch to one segment (dryrun.one_segment)")
    args = ap.parse_args(argv)

    arch, shape_name = args.cell.split(":")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rc, pol, trc = variants_for(cfg, shape)[args.variant]
    init_fake_world(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    r = run_cell(arch, shape_name, args.multi_pod, Path(args.out), mesh=mesh,
                 rc=rc, policy=pol, trc=trc, tag=args.variant, segment=args.segment)
    return 0 if r["status"] == "ok" else 1


if __name__ == "__main__":
    raise SystemExit(main())
