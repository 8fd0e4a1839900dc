"""The port's dry run (``repro_torch.launch.dryrun`` + ``trace_analysis``)
against the JAX package's (``repro.launch.dryrun`` + ``hlo_analysis``).

Each side runs in a subprocess: the port's on a process group of the
``fake`` backend (one process plays rank 0 of the mesh, every local shard
a meta tensor, nothing allocated), the JAX package's on 8 host devices
(lowered and compiled, its optimized HLO parsed).

The parity cell is qwen2-0.5b at full width cut to 2 layers, ``train_4k``
cut to B=8, S=512, on a (data=4, model=2) mesh; both sides build it with
their own ``build_cell`` (remat "full", grad_accum 2). Per-device FLOPs
count the matrix products. The attention term is reported apart: JAX's
``full_attention`` (dense below ``attn_dense_max``) computes all S x T
scores, 8 products of 2*B*H*S*T*hd a layer under remat (the forward, its
recompute, 4 in the backward); the port's K1 counts only the live
(query, key) pairs of the causal mask (``flash_attention.flops``) in the
forward and its recompute, and its tensor-op backward
(``ref.attention_bwd``) 5 full products (the scores again, dV, dP, dQ,
dK). The totals agree within 10%. ``argument_bytes`` (the local shards
of the train state and the batch) equals JAX's ``argument_size_in_bytes``.

The count of the port at 4 layers less its count at 2 equals 2 layers'
local products reckoned from the shapes within 1%, and its count at 2
layers equals the reckoned products of the whole step within 1%: DTensor
runs each new op signature once on global shapes to propagate its
sharding, which no rank does, and a count that saw those runs would be
off by about the model's global products.

qwen2-0.5b ``train_4k`` itself (B=256, S=4096) cut to 2 layers on the
16x16 production mesh sets the port's temporaries a device (the traced
step's live-storage high-water mark) beside JAX's ``temp_size_in_bytes``:
at most twice JAX's, which holds because the loss runs on each rank's
vocab shard. In the same subprocess no collective and no storage alive at
that cell's peak has the embedding table's whole shape (the lookup reads
each rank's vocab rows); llama4-scout-17b-a16e ``train_4k`` cut to 1 layer
at grad_accum 16 gives every gradient in its param's shard (each layer's
weights gathered where the layer runs); and musicgen-medium's temp grows
from 2 to 4 layers by at most twice JAX's growth a layer (each checkpointed
layer saves its rank's cut of the carry).

A multi-pod cell where a rank holds fewer rows than micro-batches
(``SCOUT``: llama4-scout-17b-a16e at full width cut to 1 layer, B=8,
S=512 on (pod 2, data 2, model 2), grad_accum 8, as the full model's 16
on 2x16x16 leaves 8 rows a rank) goes through both sides' ``build_cell``
in the same two subprocesses (JAX's compiles in about 5 s on the CPU, so
the cell keeps its full width): each micro-batch of one row sits on one
dp rank, the head's product and loss are shared by every rank (the rows
against each rank's vocab slice, cut model-major inside its model slice:
no collective takes or gives more than that slice, and no storage of the
whole head's shape is alive at the peak), and the port's per-device FLOPs
are at most 1.10x JAX's, argument bytes equal. And at 2 rows a rank (``HEAD``:
qwen2-0.5b, 1 layer, B=16 on (4, 2), grad_accum 2) the head multiplies
each rank's own rows: no product of the head takes more rows than the
rank holds, and no collective moves logits.

Last, every arch x shape cell on the 256-rank production mesh, each cut
to one segment, traces with status ``ok`` or, where ``shape_applicable``
says so, ``skipped``.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
B, S = 8, 512
MESH = (4, 2)
LAYERS = 2
FLOPS_TOL = 0.10
RECKON_TOL = 0.01
CELLS_TIMEOUT_S = 900
# the multi-pod cell (both sides) and the 2-rows-a-rank head cell (the port)
SCOUT = {"arch": "llama4-scout-17b-a16e", "layers": 1, "grid": [2, 2, 2], "B": 8, "S": 512,
         "accum": 8}
SCOUT_FLOPS_RATIO = 1.10
HEAD = {"arch": "qwen2-0.5b", "layers": 1, "grid": [4, 2], "B": 16, "S": 512, "accum": 2}

_JAX = """
import dataclasses, json
import jax, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch import hlo_analysis
from repro.launch.dryrun import build_cell
from repro.launch.mesh import make_mesh

cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=LAYERS)
shape = ShapeConfig("train_4k_cut", "train", S, B)
mesh = make_mesh(MESH, ("data", "model"))
jitted, kwargs = build_cell(cfg, shape, mesh)
compiled = jitted.lower(*kwargs.values()).compile()
stats = hlo_analysis.analyze(compiled.as_text())
leaves = {}
shardings = jax.tree_util.tree_leaves(compiled.input_shardings[0])
args = jax.tree_util.tree_flatten_with_path(tuple(kwargs.values()))[0]
assert len(shardings) == len(args)
for (path, sds), sh in zip(args, shardings):
    key = "/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                   for k in path)
    leaves[key] = int(np.prod(sh.shard_shape(sds.shape))) * np.dtype(sds.dtype).itemsize
mem = compiled.memory_analysis()

from repro.optim.adamw import OptConfig
from repro.runtime.train import TrainRunConfig
sc = SCOUT_ARGS
scout_cfg = dataclasses.replace(get_config(sc["arch"]), n_layers=sc["layers"])
scout_fn, scout_kw = build_cell(
    scout_cfg, ShapeConfig("train_cut", "train", sc["S"], sc["B"]),
    make_mesh(tuple(sc["grid"]), ("pod", "data", "model")),
    trc=TrainRunConfig(opt=OptConfig(), grad_accum=sc["accum"]))
scout = scout_fn.lower(*scout_kw.values()).compile()
print(json.dumps({"flops": stats.flops,
                  "argument_bytes": mem.argument_size_in_bytes,
                  "temp_bytes": mem.temp_size_in_bytes,
                  "collective_bytes": dict(stats.collective_bytes),
                  "leaves": leaves,
                  "scout": {"flops": hlo_analysis.analyze(scout.as_text()).flops,
                            "argument_bytes": scout.memory_analysis().argument_size_in_bytes,
                            "temp_bytes": scout.memory_analysis().temp_size_in_bytes}}))
"""

_PORT = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.trace_analysis import TraceAnalysis
from repro_torch.tree import tree_flatten_with_path

dryrun.init_fake_world(MESH[0] * MESH[1])
mesh = make_mesh(MESH, ("data", "model"))
shape = ShapeConfig("train_4k_cut", "train", S, B)
out = {}
for layers in (LAYERS, 2 * LAYERS):
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=layers)
    fn, kwargs = dryrun.build_cell(cfg, shape, mesh)
    with TraceAnalysis() as ta:
        fn(*kwargs.values())
    leaves = {k: dryrun.local_bytes(v) for k, v in tree_flatten_with_path(kwargs).items()}
    out[layers] = {"flops": ta.stats.flops, "flops_by_op": dict(ta.stats.flops_by_op),
                   "argument_bytes": dryrun.local_bytes(kwargs),
                   "temp_bytes": ta.stats.peak_live_bytes,
                   "collective_bytes": dict(ta.stats.collective_bytes),
                   "leaves": leaves}

import torch
from repro_torch.launch.trace_analysis import _collective, _tensors
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.train import TrainRunConfig


class Shapes(TraceAnalysis):
    # also records the products' operand shapes and the collectives' outputs
    def __init__(self):
        super().__init__()
        self.mm, self.moved = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or self._propagating:
            return out
        if str(func._overloadpacket) == "aten.mm":
            self.mm.append([list(args[0].shape), list(args[1].shape)])
        elif _collective(func):
            self.moved += [[_collective(func), list(t.shape)]
                           for t in _tensors((args, kwargs, out))]
        return out


# the MoE's straddle branch (a group across two ranks' rows: the batch
# gathered, every rank routing it all) is its only gather of the tokens' rows
from repro_torch.models import moe
straddled = []


def unshard_dim(x, dim):
    straddled.append(x.ndim == 3 and dim % x.ndim == 0)
    return mesh_lib.unshard_dim(x, dim)


from repro_torch.parallel import mesh as mesh_lib
moe.unshard_dim = unshard_dim

for name, c in (("scout", SCOUT_ARGS), ("head", HEAD_ARGS)):
    straddled.clear()
    axes = ("pod", "data", "model")[-len(c["grid"]):]
    cfg = dataclasses.replace(get_config(c["arch"]), n_layers=c["layers"])
    fn, kwargs = dryrun.build_cell(cfg, ShapeConfig("train_cut", "train", c["S"], c["B"]),
                                   make_mesh(tuple(c["grid"]), axes),
                                   trc=TrainRunConfig(opt=OptConfig(), grad_accum=c["accum"]))
    with Shapes() as ta:
        fn(*kwargs.values())
    head = [cfg.vocab_padded, cfg.d_model]
    out[name] = {"flops": ta.stats.flops, "argument_bytes": dryrun.local_bytes(kwargs),
                 "temp_bytes": ta.stats.peak_live_bytes, "vocab_padded": cfg.vocab_padded,
                 "d_model": cfg.d_model, "mm": ta.mm, "moved": ta.moved,
                 "straddled": sum(straddled), "moe_gathers": len(straddled),
                 "head_at_peak": sum(list(made[1]) == head
                                     for _, _, made in ta._at_peak.values())}
print(json.dumps(out))
"""


def _run(code: str, env_extra: dict, timeout: int) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env_extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _fill(code: str) -> str:
    return (code.replace("LAYERS", repr(LAYERS)).replace("MESH", repr(MESH))
            .replace("S, B)", f"{S}, {B})").replace("SCOUT_ARGS", repr(SCOUT))
            .replace("HEAD_ARGS", repr(HEAD)))


def _keyed(port_out: dict) -> dict:
    """The port's JSON: the parity cell by depth (int keys), the rest by name."""
    return {int(k) if k.isdigit() else k: v for k, v in port_out.items()}


@pytest.fixture(scope="module")
def parity():
    jax_out = json.loads(_run(_fill(_JAX), {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"}, 600).strip().splitlines()[-1])
    port_out = json.loads(_run(_fill(_PORT), {}, 600).strip().splitlines()[-1])
    return {"jax": jax_out, "port": _keyed(port_out)}


def _reckoned(layers: int) -> dict:
    """The local products of the parity step on one device, from the shapes:
    the layers' projections (forward, remat recompute, and the backward's
    two products each: 8 * tokens * params, less the recompute of each
    layer's last product, w2, which the checkpoint stops before: its output
    is needed by no backward), their attention (K1's causal forward twice,
    the backward's 5 full products), and the tied head (forward and two
    backward products: 6 * tokens * D * V / tp)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=layers)
    data, tp = MESH
    d, hd, H, K, F = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    tokens = B * S // data                        # this device's rows, all micro-batches
    per_layer = (d * H * hd * 2 + d * K * hd * 2 + 3 * d * F) // tp
    linear = (8 * per_layer - 2 * F * d // tp) * tokens * layers
    micro = 2                                      # dryrun.pick_grad_accum
    bl, hl = B // data // micro, H // tp
    attn = micro * layers * (2 * fa.flops(bl, S, S, hl, hd, True)
                             + 5 * 2 * bl * hl * S * S * hd)
    head = 6 * tokens * d * cfg.vocab_padded // tp
    return {"linear": linear, "attention": attn, "head": head,
            "total": linear + attn + head}


def test_per_device_flops_match_hlo_analysis(parity):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    jax_flops, port_flops = parity["jax"]["flops"], parity["port"][LAYERS]["flops"]
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=LAYERS)
    bl, hl, hd = B // MESH[0], cfg.n_heads // MESH[1], cfg.resolved_head_dim
    # the attention term of each convention, reported apart
    jax_attn = LAYERS * 8 * 2 * bl * hl * S * S * hd
    port_attn = _reckoned(LAYERS)["attention"]
    print(f"per-device FLOPs: JAX {jax_flops:.4e} (attention, all S x T scores, "
          f"{jax_attn:.4e}), port {port_flops:.4e} (attention, K1 causal pairs + "
          f"tensor-op backward, {port_attn:.4e}); rel diff "
          f"{abs(port_flops - jax_flops) / jax_flops:.4f}")
    assert abs(port_flops - jax_flops) <= FLOPS_TOL * jax_flops
    assert abs((port_flops - port_attn) - (jax_flops - jax_attn)) <= \
        FLOPS_TOL * (jax_flops - jax_attn)
    # K1: the forward and its remat recompute, each micro-batch (grad_accum 2)
    k1 = 2 * 2 * LAYERS * fa.flops(bl // 2, S, S, hl, hd, True)
    assert parity["port"][LAYERS]["flops_by_op"]["repro_torch.k1_fwd"] == k1


def test_argument_bytes_equal_jax(parity):
    jax_out, port = parity["jax"], parity["port"][LAYERS]
    print(f"per-device bytes: arguments port {port['argument_bytes']}, JAX "
          f"{jax_out['argument_bytes']}; temporaries port {port['temp_bytes']} (the live "
          f"storages' high-water mark), JAX {jax_out['temp_bytes']} (temp_size_in_bytes)")
    if port["argument_bytes"] != jax_out["argument_bytes"]:
        names = {k.split("/")[-1]: v for k, v in port["leaves"].items()}
        diff = {k: (names.get(k.split("/")[-1]), v) for k, v in jax_out["leaves"].items()
                if names.get(k.split("/")[-1]) != v}
        pytest.fail(f"argument bytes: port {port['argument_bytes']}, JAX "
                    f"{jax_out['argument_bytes']}; leaves that differ: {diff}")
    assert sum(port["leaves"].values()) == port["argument_bytes"]


def test_multi_pod_cell_with_fewer_rows_than_micro_batches(parity):
    """``SCOUT``: 8 rows on 4 dp ranks, 8 micro-batches of one row. JAX
    compiles it; the port cuts each micro-batch as one process does and
    puts its row on one dp rank (``runtime.train.micro_batch``), its head
    shared by every rank. Before, every rank gathered the batch and held
    the micro-batch's row, which DTensor then split as it chose."""
    jax_out, port = parity["jax"]["scout"], parity["port"]["scout"]
    ratio = port["flops"] / jax_out["flops"]
    print(f"{SCOUT['arch']} ({SCOUT['layers']} layer, B={SCOUT['B']}, S={SCOUT['S']}, "
          f"grad_accum {SCOUT['accum']}, mesh {SCOUT['grid']}): per-device FLOPs port "
          f"{port['flops']:.4e}, JAX {jax_out['flops']:.4e} ({ratio:.3f}x); arguments "
          f"{port['argument_bytes']} / {jax_out['argument_bytes']} B; temp port "
          f"{port['temp_bytes'] / 1e9:.3f} GB, JAX {jax_out['temp_bytes'] / 1e9:.3f} GB")
    assert ratio <= SCOUT_FLOPS_RATIO
    assert port["argument_bytes"] == jax_out["argument_bytes"]
    # each rank routes its own row's groups (512 tokens, one group a row):
    # the MoE's straddle branch never runs
    assert port["moe_gathers"] > 0 and port["straddled"] == 0, port["straddled"]
    # the head's products take each rank's slice of the vocab, cut over all 8
    # ranks (25,280 of 202,240 rows), not the model rank's half: no product
    # has a larger dim
    share = -(-port["vocab_padded"] // (SCOUT["grid"][0] * SCOUT["grid"][1] * SCOUT["grid"][2]))
    assert max(d for a, b in port["mm"] for d in a + b) <= share
    # those slices are cut model-major, each inside the rank's own model
    # slice of the head: no collective takes or gives more than that slice,
    # and no storage of the whole head's shape is alive at the peak (DTensor,
    # cutting the vocab pod-major, went through the whole head to reach them)
    model_slice = -(-port["vocab_padded"] // SCOUT["grid"][2]) * port["d_model"]
    largest = max(port["moved"], key=lambda m: math.prod(m[1]))
    print(f"the largest tensor a collective took or gave: {largest}; the head's model "
          f"slice {model_slice} elements; whole-head storages at the peak "
          f"{port['head_at_peak']}")
    assert math.prod(largest[1]) <= model_slice, largest
    assert port["head_at_peak"] == 0, port["head_at_peak"]


def test_head_takes_each_ranks_own_rows(parity):
    """``HEAD``: 16 rows on data=4, grad_accum 2: a micro-batch of 8 rows,
    2 a rank. The head's D is gathered (its FSDP dim, on data as the
    rows are), so its product takes the rank's 2 rows against its vocab
    slice, and no logits move. Left to DTensor, the product took the
    micro-batch's 8 rows against a quarter of D, its logits all-gathered
    and reduce-scattered: (8, 512, 76032) and (2, 512, 76032) for this
    cell, bf16."""
    port = parity["port"]["head"]
    cols = port["vocab_padded"] // HEAD["grid"][1]
    rows = HEAD["B"] // HEAD["accum"] // HEAD["grid"][0] * HEAD["S"]
    head = [(a, b) for a, b in port["mm"] if b[1] == cols]
    assert head and all(a[0] == rows for a, _ in head), head
    logits = [m for m in port["moved"] if len(m[1]) == 3 and m[1][-1] == cols]
    assert not logits, logits


def test_collective_bytes_counted(parity):
    port = parity["port"][LAYERS]["collective_bytes"]
    assert sum(port.values()) > 0 and port.get("all-gather", 0) > 0, port
    assert sum(parity["jax"]["collective_bytes"].values()) > 0


def test_no_global_shape_propagation_is_counted(parity):
    """4 layers less 2 is 2 layers' local products; 2 layers is the
    reckoned step. A propagation run counted would add global products."""
    two, four = parity["port"][LAYERS]["flops"], parity["port"][2 * LAYERS]["flops"]
    layers_2 = _reckoned(2 * LAYERS)["total"] - _reckoned(LAYERS)["total"]
    assert abs((four - two) - layers_2) <= RECKON_TOL * layers_2, (four - two, layers_2)
    total = _reckoned(LAYERS)["total"]
    assert abs(two - total) <= RECKON_TOL * total, (two, total)


# qwen2-0.5b train_4k at full width and batch, cut to PROD_LAYERS layers, on
# the 16x16 production mesh: the port's temporaries against JAX's
PROD_LAYERS = 2
PROD_TEMP_RATIO = 2.0
# llama4-scout-17b-a16e train_4k at full width cut to 1 layer, at the full
# model's grad_accum 16: the gradients that leave autograd.grad
SCOUT_PROD = ("llama4-scout-17b-a16e", 1, 16)
# musicgen-medium train_4k at 2 and 4 layers: the temp's growth a layer
CARRY_ARCH, CARRY_LAYERS = "musicgen-medium", (2, 4)
# JAX's temp_size_in_bytes of that arch's train_4k on 16x16 at 4 layers less
# at 2, over 2: (4,281,807,368 - 4,253,594,120) / 2, compiled on a CPU by
# PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_dryrun_cell.py
# musicgen-medium train_4k --layers N
JAX_CARRY_BYTES_PER_LAYER = 14_106_624

_JAX_PROD = """
import dataclasses, json
from repro.configs import SHAPES, get_config
from repro.launch.dryrun import build_cell
from repro.launch.mesh import make_production_mesh

cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=LAYERS)
jitted, kwargs = build_cell(cfg, SHAPES["train_4k"], make_production_mesh(multi_pod=False))
mem = jitted.lower(*kwargs.values()).compile().memory_analysis()
print(json.dumps({"temp_bytes": mem.temp_size_in_bytes,
                  "argument_bytes": mem.argument_size_in_bytes}))
"""

_PORT_PROD = """
import dataclasses, json, torch
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.trace_analysis import TraceAnalysis, _collective, _tensors
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.train import TrainRunConfig


class Shapes(TraceAnalysis):
    # also records the shapes each collective takes and gives
    def __init__(self):
        super().__init__()
        self.moved = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and not self._propagating and _collective(func):
            self.moved += [list(t.shape) for t in _tensors((args, kwargs, out))]
        return out


def trace(arch, layers, accum=None):
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    trc = None if accum is None else TrainRunConfig(opt=OptConfig(), grad_accum=accum)
    fn, kwargs = dryrun.build_cell(cfg, SHAPES["train_4k"], mesh, trc=trc)
    with Shapes() as ta, dryrun.recording_grad_shards() as shards:
        fn(*kwargs.values())
    return cfg, kwargs, ta, shards


dryrun.init_fake_world(256)
mesh = make_production_mesh(multi_pod=False)
cfg, kwargs, ta, _ = trace("qwen2-0.5b", LAYERS)
table = [cfg.vocab_padded, cfg.d_model]
out = {"temp_bytes": ta.stats.peak_live_bytes,
       "argument_bytes": dryrun.local_bytes(kwargs),
       "collective_counts": dict(ta.stats.collective_counts),
       "table": table,
       "table_moved": sum(m == table for m in ta.moved),
       "table_at_peak": sum(list(made[1]) == table for _, _, made in ta._at_peak.values()),
       "largest_moved": max(ta.moved, key=lambda m: torch.Size(m).numel())}
_, _, _, out["scout"] = trace(*SCOUT_PROD)
out["carry"] = {n: trace(CARRY_ARCH, n)[2].stats.peak_live_bytes for n in CARRY_LAYERS}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def prod():
    """``_JAX_PROD`` and ``_PORT_PROD`` at once (JAX's ``repro.launch.dryrun``
    makes 512 host devices as it is imported; the mesh takes 256)."""
    def start(code, env_extra):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env_extra)
        return subprocess.Popen([sys.executable, "-c", _fill_prod(code)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=env, cwd=str(ROOT))
    procs = [start(_JAX_PROD, {"JAX_PLATFORMS": "cpu"}), start(_PORT_PROD, {})]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    jax_out, port = (json.loads(o.strip().splitlines()[-1]) for o, _ in outs)
    return {"jax": jax_out, "port": port}


def _fill_prod(code: str) -> str:
    return (code.replace("CARRY_LAYERS", repr(CARRY_LAYERS)).replace("CARRY_ARCH", repr(CARRY_ARCH))
            .replace("SCOUT_PROD", repr(SCOUT_PROD)).replace("LAYERS", repr(PROD_LAYERS)))


def test_train_4k_temporaries_within_twice_jax(prod):
    """The port's temporaries a device (the live storages' high-water mark
    of the traced step) at most ``PROD_TEMP_RATIO`` times JAX's
    ``temp_size_in_bytes`` on the same cell: the loss runs on each rank's
    vocab shard (152,064 columns over model = 16), as XLA partitions
    JAX's. Gathering the logits' vocab made the port's 379.1 GB against
    JAX's 5.23."""
    jax_out, port = prod["jax"], prod["port"]
    print(f"qwen2-0.5b train_4k, {PROD_LAYERS} layers, 16x16: temporaries a device port "
          f"{port['temp_bytes'] / 1e9:.3f} GB, JAX {jax_out['temp_bytes'] / 1e9:.3f} GB "
          f"({port['temp_bytes'] / jax_out['temp_bytes']:.3f}x); collectives "
          f"{port['collective_counts']}")
    assert port["argument_bytes"] == jax_out["argument_bytes"]
    assert port["temp_bytes"] <= PROD_TEMP_RATIO * jax_out["temp_bytes"], (port, jax_out)


def test_no_whole_embedding_table_moves_or_lives(prod):
    """qwen2-0.5b's lookup reads each rank's vocab rows (the table's D
    gathered, a sixteenth of the table), so no collective takes or gives a
    tensor of the whole table's shape, and no storage of that shape is
    alive at the temp's peak. Before, every rank gathered the table."""
    port = prod["port"]
    print(f"the largest tensor a collective took or gave: {port['largest_moved']}; "
          f"the table {port['table']}")
    assert port["table_moved"] == 0 and port["table_at_peak"] == 0, port


def test_gradients_leave_autograd_in_their_params_shards(prod):
    """llama4-scout-17b-a16e ``train_4k`` at full width cut to
    ``SCOUT_PROD``'s layer and grad_accum on 16x16: every gradient that
    leaves ``autograd.grad`` is no larger than its param's local shard,
    each layer's reduce-scattered where the layer runs, and ``wo``'s
    (40 heads on 16 model ranks) is sharded on ``model``. Before, the
    stacked weights' gradients left it whole along their FSDP dim, and
    ``wo``'s whole on ``model`` too."""
    shards = prod["port"]["scout"]
    print(f"{SCOUT_PROD}: {len(shards['larger'])} of {shards['leaves']} gradient leaves "
          f"larger than their shard; wo's placements {shards['placements']['blocks/attn/wo']}")
    assert shards["leaves"] > 0 and not shards["larger"], shards["larger"]
    assert shards["placements"]["blocks/attn/wo"][1].startswith("S("), shards["placements"]


def test_saved_carry_grows_per_layer_within_twice_jax(prod):
    """``CARRY_ARCH`` ``train_4k`` on 16x16 at ``CARRY_LAYERS`` layers: the
    port's temp grows per layer by at most twice JAX's per-layer growth
    (``JAX_CARRY_BYTES_PER_LAYER``): each checkpointed layer saves its
    rank's cut of the residual carry, not the whole (8, 4096, 1536) on
    every model rank (100.7 MB a layer before)."""
    carry = prod["port"]["carry"]
    a, b = CARRY_LAYERS
    per_layer = (carry[str(b)] - carry[str(a)]) / (b - a)
    print(f"{CARRY_ARCH} train_4k temp: {carry}; {per_layer / 1e6:.2f} MB a layer "
          f"(JAX {JAX_CARRY_BYTES_PER_LAYER / 1e6:.2f})")
    assert per_layer <= 2 * JAX_CARRY_BYTES_PER_LAYER, carry


# the archs of the cells' three subprocesses, about equal in trace time
CELL_GROUPS = ("zamba2-1.2b", "mamba2-2.7b,llama-3.2-vision-11b,deepseek-67b,musicgen-medium",
               "gemma-7b,llama4-scout-17b-a16e,qwen2-0.5b,qwen2-1.5b,qwen2-moe-a2.7b")


def test_every_cell_traces_on_the_production_mesh(tmp_path):
    """In ``CELL_GROUPS``' three subprocesses at once, each with its own
    ``fake`` world of 256 ranks."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", archs, "--shape", "all",
         "--segment", "--out", str(tmp_path)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT)) for archs in CELL_GROUPS]
    try:
        outs = [p.communicate(timeout=CELLS_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cells = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    errors = {f"{c['arch']} x {c['shape']}": c.get("error") for c in cells
              if c["status"] == "error"}
    assert all(p.returncode == 0 for p in procs) and not errors, (
        errors, [(o[0][-2000:], o[1][-2000:]) for o in outs])
    from repro_torch.configs import REGISTRY, SHAPES, get_config, shape_applicable
    assert len(cells) == len(REGISTRY) * len(SHAPES) == 40
    for c in cells:
        expect = "ok" if shape_applicable(get_config(c["arch"]), SHAPES[c["shape"]]) else "skipped"
        assert c["status"] == expect, c
        if expect == "ok":
            assert c["n_chips"] == 256 and c["trace_per_device"]["flops"] > 0, c
            assert c["memory_analysis"]["argument_bytes"] > 0, c


def test_perf_variants_are_the_references_but_attention_dispatch(tmp_path):
    """``launch/perf.py``'s variants: the JAX package's, less the three that
    size its attention dispatch (one K1 call serves every length), and one
    traced through the CLI to a tagged artifact."""
    import re
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.perf import variants_for
    text = (ROOT / "src/repro/launch/perf.py").read_text()
    reference = set(re.findall(r'^\s+"(\w+)": \(', text, flags=re.M))
    port = set(variants_for(get_config("qwen2-0.5b"), SHAPES["train_4k"]))
    assert reference - port == {"chunk512", "chunk2048", "densattn"}
    assert port <= reference
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.perf", "--cell",
         "qwen2-moe-a2.7b:prefill_32k", "--variant", "moegroup4096", "--segment",
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    cell = json.loads((tmp_path / "qwen2-moe-a2.7b__prefill_32k__pod16x16__moegroup4096.json")
                      .read_text())
    assert cell["status"] == "ok" and cell["tag"] == "moegroup4096", cell


def card_check(out_dir: Path) -> None:
    """The port's side of these tests, without JAX (the card's machine has
    none, and its torch may differ from the tests'): the reckoning of the
    parity cell, every cell on the production mesh, and the production
    cells' table, gradients and carry. ``python
    tests/test_torch_dryrun.py card-check <dir>``."""
    port_out = json.loads(_run(_fill(_PORT), {}, 600).strip().splitlines()[-1])
    test_no_global_shape_propagation_is_counted({"port": _keyed(port_out)})
    test_head_takes_each_ranks_own_rows({"port": _keyed(port_out)})
    test_every_cell_traces_on_the_production_mesh(out_dir)
    prod_out = {"port": json.loads(_run(_fill_prod(_PORT_PROD), {}, 600).strip().splitlines()[-1])}
    test_no_whole_embedding_table_moves_or_lives(prod_out)
    test_gradients_leave_autograd_in_their_params_shards(prod_out)
    test_saved_carry_grows_per_layer_within_twice_jax(prod_out)
    print(f"CARD_CHECK_OK: per-device FLOPs of the parity cell {port_out[str(LAYERS)]['flops']:.4e}"
          f" (reckoned {_reckoned(LAYERS)['total']:.4e}); every cell ok or skipped; no whole "
          f"table, every gradient in its shard, the saved carry cut")


if __name__ == "__main__" and sys.argv[1:2] == ["card-check"]:
    sys.path.insert(0, str(ROOT / "src"))
    card_check(Path(sys.argv[2]))
