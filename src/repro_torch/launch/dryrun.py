"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the meta device.

The port's counterpart of the JAX package's ``repro/launch/dryrun.py``.
For each cell this script:
  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod)
     over a process group of the ``fake`` backend of that many ranks
     (``main`` makes one per mesh size; this process plays rank 0),
  2. builds the step (train_step / prefill / decode) with the real
     sharding rules, and its inputs (train state, params, batch, cache)
     as DTensors whose local shards are meta tensors (no allocation),
  3. runs the step once under ``launch.trace_analysis.TraceAnalysis``:
     any sharding the port cannot run fails HERE (where the JAX package
     lowers and compiles, the port traces; ``trace_s`` is that time),
  4. prints the per-device FLOPs, memory traffic, collectives and the
     roofline terms,
  5. writes a JSON artifact to ``artifacts/dryrun_torch/``.

Nothing is launched and nothing is allocated: K1 and K2 are meta
operators with FLOP formulas (``kernels/ops.py``). The roofline terms
are arithmetic on the H100's data-sheet peaks below, not timings.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama4-scout-17b-a16e \
      --shape train_4k --mesh multi --layers 2 --grad-accum 16

``--layers`` cuts each arch's depth, which changes ``pick_grad_accum``'s
count (it reads the parameters of the config it is given): a cut cell
that stands for the full model passes the full model's count with
``--grad-accum``. Such a cell's artifact is tagged (``L2_ga16``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs import REGISTRY, SHAPES, get_config, shape_applicable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.trace_analysis import TraceAnalysis
from repro_torch.models import RunConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.parallel.sharding import ShardingPolicy, batch_specs, is_sharding, to_named
from repro_torch.runtime.serve import build_decode_step, build_prefill_step
from repro_torch.runtime.train import TrainRunConfig, build_train_step
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

# NVIDIA H100 SXM data-sheet peaks, per card (NVIDIA H100 80GB HBM3, power
# limit 700 W; a card set below 700 W runs slower under load)
PEAK_FLOPS = 989e12       # bf16 dense
HBM_BW = 3.35e12          # bytes/s
LINK_BW = 450e9           # bytes/s, NVLink each way

DEFAULT_OUT = "artifacts/dryrun_torch"


def pick_grad_accum(cfg, shape) -> int:
    """Microbatch count keeping activations-per-card sane (the JAX package's)."""
    if cfg.family in ("ssm", "hybrid"):
        return 8            # SSD intra-chunk tensors are fat per param
    n = cfg.param_count()
    if n > 30e9:
        return 16
    if n > 8e9:
        return 8
    if n > 2e9:
        return 4
    return 2


def make_runconfig(cfg, shape) -> RunConfig:
    """The JAX package's run config of a cell, on the meta device. Its
    ``attn_chunk`` and ``attn_dense_max`` have no counterpart: one K1 call
    serves every prefill length."""
    return RunConfig(
        param_dtype=torch.float32,
        compute_dtype=torch.bfloat16,
        device="meta",
        remat=(shape.kind == "train"),
        remat_policy="full",   # save only layer-boundary carries
        ssd_chunk=32 if shape.kind == "train" else 0,   # prefill runs at the config's 128
    )


def one_segment(cfg):
    """``cfg`` cut to one segment: 1 layer, or one period of the hybrid's
    shared block (``attn_every``) or of the vlm's cross blocks
    (``cross_attn_every``), so the segment's special block is traced too."""
    return dataclasses.replace(cfg, n_layers=cfg.attn_every or cfg.cross_attn_every or 1)


def _place_meta(tree, shardings):
    """Each meta leaf as a DTensor of ``shardings``' placements whose local
    shard is a meta tensor; a host int (the cache's ``pos``) as it is."""
    def place(sh, x):
        if not isinstance(x, torch.Tensor):
            return x
        return distribute_tensor(x, sh.mesh, sh.placements(x.ndim), src_data_rank=None)
    return tree_map(place, shardings, tree, is_leaf=is_sharding)


def build_cell(cfg, shape, mesh, rc=None, policy=None, trc=None):
    """Returns (fn, kwargs of meta DTensors): ``fn(*kwargs.values())`` runs
    the step (a decode cell's cache ``pos`` at its last slot)."""
    rc = rc or make_runconfig(cfg, shape)
    policy = policy or ShardingPolicy()
    if shape.kind == "train":
        trc = trc or TrainRunConfig(opt=OptConfig(),
                                    grad_accum=pick_grad_accum(cfg, shape))
        step, state_meta, batch_meta, st_sh, b_sh, _ = build_train_step(
            cfg, mesh, B=shape.global_batch, S=shape.seq_len, rc=rc, policy=policy, trc=trc)
        return step, {"state": _place_meta(state_meta, st_sh),
                      "batch": _place_meta(batch_meta, b_sh)}
    if shape.kind == "prefill":
        step, params_meta, batch_meta, p_sh, model = build_prefill_step(
            cfg, mesh, B=shape.global_batch, S=shape.seq_len, rc=rc, policy=policy)
        b_sh = to_named(batch_specs(batch_meta, mesh, policy), mesh)
        return step, {"params": _place_meta(params_meta, p_sh),
                      "batch": _place_meta(batch_meta, b_sh)}
    if shape.kind == "decode":
        step, params_meta, cache_meta, batch_meta, (p_sh, c_sh, b_sh), _ = build_decode_step(
            cfg, shape, mesh, rc=rc, policy=policy)
        cache_meta["pos"] = shape.seq_len - 1       # the new token takes the last slot
        return step, {"params": _place_meta(params_meta, p_sh),
                      "cache": _place_meta(cache_meta, c_sh),
                      "batch": _place_meta(batch_meta, b_sh)}
    raise ValueError(shape.kind)


def grad_shards(params, grads) -> dict:
    """How the gradients that leave ``autograd.grad`` lie beside their params:
    the number of leaves, each gradient's placements by leaf path, and the
    leaves whose local gradient is larger than the param's local shard (a
    gradient left whole on a mesh dim that shards its param)."""
    ps, gs = tree_flatten_with_path(params), tree_flatten_with_path(grads)
    larger = []
    for k, p in ps.items():
        g = gs[k]
        gl = g.to_local() if isinstance(g, DTensor) else g
        pl = p.to_local() if isinstance(p, DTensor) else p
        if gl.numel() > pl.numel():
            larger.append({"leaf": k, "grad": list(gl.shape), "shard": list(pl.shape)})
    return {"leaves": len(ps), "larger": larger,
            "placements": {k: [str(x) for x in getattr(g, "placements", ())]
                           for k, g in gs.items()}}


@contextlib.contextmanager
def recording_grad_shards():
    """Within it, the first (params, grads) that the train step's
    ``value_and_grad`` returns is summed up by ``grad_shards`` into the
    dict it yields (empty until a train step runs)."""
    from repro_torch.runtime import train as train_lib
    real, seen = train_lib.value_and_grad, {}

    def record(loss_fn, params, batch):
        loss, grads = real(loss_fn, params, batch)
        if not seen:
            seen.update(grad_shards(params, grads))
        return loss, grads
    train_lib.value_and_grad = record
    try:
        yield seen
    finally:
        train_lib.value_and_grad = real


def roofline_terms(stats):
    """Arithmetic on the data-sheet peaks: each count over its peak rate."""
    compute_s = stats.flops / PEAK_FLOPS
    memory_s = stats.mem_bytes / HBM_BW
    collective_s = stats.total_collective_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    return terms, dominant


def model_flops(cfg, shape) -> float:
    """Analytic 6ND / 2ND 'useful' FLOPs for the cell (global)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch          # decode: one token


def local_bytes(tree) -> int:
    """The bytes of the local shards of a tree's tensors (DTensor or not)."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            total += local.numel() * local.element_size()
    return total


def _global_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def ideal_step_seconds(cfg, shape, n_chips: int, kwargs) -> float:
    """The roofline floor for this cell on this mesh.

    train/prefill: compute-bound floor (MODEL_FLOPS at peak bf16).
    decode: ALSO bandwidth-bound floor -- every step must stream the
    (bf16) weights + the KV/SSM cache once; the larger floor governs.
    """
    comp = model_flops(cfg, shape) / n_chips / PEAK_FLOPS
    if shape.kind != "decode":
        return comp
    bytes_ideal = cfg.active_param_count() * 2
    if "cache" in kwargs:
        bytes_ideal += _global_bytes(kwargs["cache"])
    return max(comp, bytes_ideal / n_chips / HBM_BW)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             mesh=None, verbose: bool = True, policy=None, rc=None,
             trc=None, tag: str = "", segment: bool = False,
             layers: Optional[int] = None) -> dict:
    """Trace one cell; ``segment`` cuts the arch to ``one_segment``,
    ``layers`` to that many layers."""
    cfg = get_config(arch)
    if segment:
        cfg = one_segment(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "tag": tag, "n_layers": cfg.n_layers, "status": "ok"}

    if not shape_applicable(cfg, shape):
        result["status"] = "skipped"
        result["reason"] = ("long_500k requires a sub-quadratic family; "
                            f"{arch} is pure full-attention (see DESIGN.md)")
        print(f"[dryrun] SKIP {cell_id}: {result['reason']}")
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{cell_id}.json").write_text(json.dumps(result, indent=1))
        return result

    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    t0 = time.time()
    try:
        fn, kwargs = build_cell(cfg, shape, mesh, rc=rc, policy=policy, trc=trc)
        t_build = time.time() - t0
        with TraceAnalysis() as ta, recording_grad_shards() as shards:
            out = fn(*kwargs.values())
        t_trace = time.time() - t0 - t_build
    except Exception as e:  # a failing cell is a bug we must surface
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"[:2000]
        result["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] FAIL {cell_id}: {result['error'][:500]}")
        return result

    stats = ta.stats
    terms, dominant = roofline_terms(stats)
    mf = model_flops(cfg, shape)
    flops_global = stats.flops * n_chips
    arg_b = local_bytes(kwargs)
    ideal = ideal_step_seconds(cfg, shape, n_chips, kwargs)
    result.update({
        "n_chips": int(n_chips),
        "build_s": round(t_build, 2),
        "trace_s": round(t_trace, 2),
        "memory_analysis": {
            "argument_bytes": arg_b,
            "output_bytes": local_bytes(out),
            "temp_bytes": stats.peak_live_bytes,
            "alias_bytes": 0,
            "peak_bytes_per_device": arg_b + stats.peak_live_bytes,
            "peak_holders": stats.peak_holders,
        },
        "trace_per_device": {
            "flops": stats.flops,
            "flops_by_op": dict(stats.flops_by_op),
            "mem_bytes": stats.mem_bytes,
            "collective_bytes": dict(stats.collective_bytes),
            "collective_counts": dict(stats.collective_counts),
            "total_collective_bytes": stats.total_collective_bytes,
        },
        "roofline": {**terms, "dominant": dominant,
                     "step_time_bound_s": max(terms.values())},
        "model_flops_global": mf,
        "traced_flops_global": flops_global,
        "useful_flops_ratio": mf / flops_global if flops_global else 0.0,
        "ideal_step_s": ideal,
        "grad_shards": shards,
        "roofline_fraction": ideal / max(terms.values()) if max(terms.values()) > 0 else 0.0,
    })

    if verbose:
        ma = result["memory_analysis"]
        print(f"[dryrun] OK   {cell_id}  ({cfg.n_layers} layers) trace={t_trace:.1f}s")
        print(f"  memory_analysis: args={ma['argument_bytes']/1e9:.2f}GB "
              f"temp={ma['temp_bytes']/1e9:.2f}GB "
              f"peak/device={ma['peak_bytes_per_device']/1e9:.2f}GB")
        print("  temp held at its peak by: " + "; ".join(
            f"{h['bytes']/1e9:.3f}GB {h['op']} {h['dtype']}{h['shape']} x{h['count']}"
            for h in ma["peak_holders"][:3]))
        if shards:
            print(f"  gradients larger than their param's shard: {len(shards['larger'])} "
                  f"of {shards['leaves']} leaves")
        print(f"  trace/dev: flops={stats.flops:.3e} "
              f"mem={stats.mem_bytes/1e9:.2f}GB "
              f"coll={stats.total_collective_bytes/1e9:.3f}GB "
              f"{dict(stats.collective_counts)}")
        print(f"  roofline (data-sheet peaks): compute={terms['compute_s']*1e3:.2f}ms "
              f"memory={terms['memory_s']*1e3:.2f}ms "
              f"collective={terms['collective_s']*1e3:.2f}ms "
              f"dominant={dominant} useful_ratio={result['useful_flops_ratio']:.3f} "
              f"roofline_frac={result['roofline_fraction']:.3f}", flush=True)

    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell_id}.json").write_text(json.dumps(result, indent=1))
    return result


def table(out_dir: Path) -> str:
    """A markdown table of the cells' JSONs in ``out_dir``: status,
    per-device FLOPs, useful_flops_ratio, collective GB by type, argument
    and temp GB, the gradient leaves larger than their shard (a train
    cell's; "-" otherwise), the three roofline terms (ms, arithmetic on
    the data-sheet peaks), the dominant one and ``trace_s``."""
    kinds = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")
    rows = ["| cell | layers | status | FLOPs/dev | useful | collective GB (" +
            ", ".join(kinds) + ") | args GB | temp GB | grads > shard | compute ms | "
            "memory ms | collective ms | dominant | trace s |",
            "| --- " * 14 + "|"]
    for path in sorted(Path(out_dir).glob("*.json")):
        c = json.loads(path.read_text())
        name = f"{c['arch']} {c['shape']} {c['mesh']}" + (f" {c['tag']}" if c.get("tag") else "")
        if c["status"] != "ok":
            rows.append(f"| {name} | {c.get('n_layers', '')} | {c['status']} |" + " |" * 11)
            continue
        per, ma, rf = c["trace_per_device"], c["memory_analysis"], c["roofline"]
        coll = ", ".join(f"{per['collective_bytes'].get(k, 0) / 1e9:.3f}" for k in kinds)
        shards = c.get("grad_shards")
        larger = f"{len(shards['larger'])} of {shards['leaves']}" if shards else "-"
        rows.append(
            f"| {name} | {c['n_layers']} | ok | {per['flops']:.3e} | "
            f"{c['useful_flops_ratio']:.3f} | {coll} | {ma['argument_bytes'] / 1e9:.2f} | "
            f"{ma['temp_bytes'] / 1e9:.1f} | {larger} | {rf['compute_s'] * 1e3:.2f} | "
            f"{rf['memory_s'] * 1e3:.2f} | {rf['collective_s'] * 1e3:.2f} | "
            f"{rf['dominant'].removesuffix('_s')} | {c['trace_s']} |")
    return "\n".join(rows)


def init_fake_world(n: int) -> None:
    """A process group of ``n`` ranks on the ``fake`` backend, this process
    rank 0: collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-cached", action="store_true")
    ap.add_argument("--segment", action="store_true",
                    help="cut each arch to one segment (one_segment)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each arch to this many layers")
    ap.add_argument("--grad-accum", type=int, default=None,
                    help="the train cells' micro-batch count (default pick_grad_accum)")
    ap.add_argument("--table", action="store_true",
                    help="print the markdown table of the cells in --out and exit")
    args = ap.parse_args(argv)
    if args.table:
        print(table(Path(args.out)))
        return 0

    import torch.distributed as dist
    archs = sorted(REGISTRY) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out_dir = Path(args.out)
    trc = (None if args.grad_accum is None
           else TrainRunConfig(opt=OptConfig(), grad_accum=args.grad_accum))
    tag = "_".join(t for t in (f"L{args.layers}" if args.layers else "",
                               f"ga{args.grad_accum}" if args.grad_accum else "") if t)

    summary = []
    for multi in meshes:
        init_fake_world(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi)
        for arch in archs:
            for shape in shapes:
                mesh_name = "pod2x16x16" if multi else "pod16x16"
                cached = out_dir / (f"{arch}__{shape}__{mesh_name}"
                                    + (f"__{tag}" if tag else "") + ".json")
                if args.skip_cached and cached.exists():
                    prev = json.loads(cached.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[dryrun] CACHED {cached.stem} ({prev['status']})")
                        summary.append(prev)
                        continue
                summary.append(run_cell(arch, shape, multi, out_dir, mesh=mesh,
                                        segment=args.segment, layers=args.layers,
                                        trc=trc, tag=tag))
        dist.destroy_process_group()

    ok = sum(1 for r in summary if r["status"] == "ok")
    sk = sum(1 for r in summary if r["status"] == "skipped")
    bad = [r for r in summary if r["status"] == "error"]
    print(f"\n[dryrun] total={len(summary)} ok={ok} skipped={sk} failed={len(bad)}")
    for r in bad:
        print(f"  FAILED {r['arch']} x {r['shape']} x {r['mesh']}: {r['error'][:300]}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
