"""Sharded paths of the port (repro_torch) on CPU gloo worlds: the twins of
``tests/test_distributed.py``'s ring, sharded train step and elastic tests,
plus sharded serving, local shards against JAX's and the production meshes.

One world of 8 spawned ranks (``python tests/test_torch_distributed.py
worker <rank> ...``, gloo over a ``file://`` rendezvous in the test's tmp
dir, so parallel test workers never share a port; ``tests/torch_world.py``
spawns and joins them) runs every check in turn and rank 0 writes the
results; the test functions read them. The
ranks import no JAX. A rank that does not finish within ``TIMEOUT_S``
fails the tests, it does not hang them.

The model is qwen2-0.5b reduced to 2 layers of width 128 with its own
head counts (H=14 over K=2, hd 32) and its vocab cut to 500 (padded to
512), in f32 compute, with weights made by the JAX package's init; B=8,
S=32. On the (4, 2) mesh the attention shards heads (14 % 2 == 0: each
rank's 7 q heads read one KV head), on (2, 4) query rows (14 % 4 != 0:
each rank's 8 rows run at q_offset 0, 8, 16 or 24 against the full
k/v); a third case takes the (4, 2) step with grad_accum 2, each
micro-batch the rows one process's cut gives it, spread over the data
ranks (``runtime.train.micro_batch``), and a fourth (``pod_spread``) the
(pod 2, data 2, model 2) step at grad_accum 4, whose micro-batches of 2
rows on 4 dp ranks take the head's spread path (each rank's model-major
piece of the vocab). Two more run under remat: on the
(1, 7) mesh over 7 of the 8 ranks below ("dots": 2 of the 14 heads a
rank, straddling the GQA groups), and on (2, 4) ("full": each layer's
weights gathered and its carry cut over tp inside the checkpoint, and
``wo``'s input cut over tp so its gradient keeps its shard). Serving
(prefill, then greedy decode against the grown cache) runs on (4, 2), on
(2, 4) (the cache's head_dim on tp, so decode sums its scores over tp)
and on a (1, 7) mesh over 7 of the 8 ranks (2 of the 14 heads a rank,
straddling the GQA groups of 7; the 8 rows replicated over the 7). The
elastic run starts from a checkpoint of the same weights at step 0.

Every result is held twice: against the port in one process, and against
the JAX package on the same weights and batches (one subprocess of 8 host
devices: its sharded train steps on the same meshes with the same
RunConfig knobs, its sharded prefill and decode on the same meshes, its
ElasticRunner 8 -> 4 from the same checkpoint). Train: loss within 1e-5
relative, every gradient leaf within 1e-4 of its leaf's largest value,
params after the step within STEP_TOL (Adam's first step turns a gradient
within f32 rounding of zero into up to the learning rate, 1e-3, of param
difference); serving: logits within 1e-5; elastic: losses within STEP_TOL
relative.
"""
import contextlib
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.optim.adamw import OptConfig, init_state  # noqa: E402
from repro_torch.parallel.sharding import specs_of, whole  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_rebuild  # noqa: E402

WORLD = 8
TIMEOUT_S = 420
B, S = 8, 32
VOCAB = 500
LAYERS = 2
STEP_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=0)
STRADDLE_TP = 7            # 14 heads on model=7: rank 3 holds heads 6 and 7 of groups 0 and 1
# mesh shape, the RunConfig knobs and the grad_accum of each train case
TRAIN_CASES = {"heads": ((4, 2), {"attn_exit_constrain": True}, 1),
               "seq": ((2, 4), {"seq_shard_carry": True}, 1),
               "heads_accum": ((4, 2), {}, 2),
               "straddle": ((1, STRADDLE_TP), {"remat": True, "remat_policy": "dots"}, 1),
               "seq_remat": ((2, 4), {"remat": True, "remat_policy": "full"}, 1),
               "pod_spread": ((2, 2, 2), {}, 4)}
# the axes of a mesh by its rank
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
# (4, 2): heads and the cache's KV heads on tp; (2, 4): query rows, and the
# cache's head_dim on tp (2 KV heads on 4), so decode sums its scores over tp
SERVE_MESHES = {"serve": (4, 2), "serve_seq": (2, 4)}
DECODE_STEPS = 3
ELASTIC = dict(steps=10, fail_at=8, fail_devices=4, ckpt_every=5)
ELASTIC_OPT = dict(warmup_steps=2, total_steps=30)
SHARD_MESH = (2, 2, 2)
SHARD_AXES = ("pod", "data", "model")
SHARD_SPECS = [(("pod", "data"), "model", None), (("data", "model"), None, None),
               (None, ("pod", "model"), "data"), (("pod", "data", "model"), None, None),
               ("model", ("pod", "data"), None), (None, None, None)]
SHARD_SHAPE = (8, 8, 4)


def _cfg():
    return dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=LAYERS,
                               n_heads=14, n_kv_heads=2, vocab_size=VOCAB)


def _rc(**kw):
    return RunConfig(device="cpu", compute_dtype=torch.float32, **kw)


def _whole(tree):
    return {k: whole(v).detach().clone() for k, v in tree_flatten_with_path(tree).items()}


# ---------------------------------------------------------------------------
# the rank's side (no JAX)
# ---------------------------------------------------------------------------
def _ring(out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.overlap import psum_overlapped
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("x",))
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 5)).astype(np.float32))
    r = dist.get_rank()
    local = xs[r * 8:(r + 1) * 8].clone()
    ring = psum_overlapped(local, mesh, "x", use_ring=True)
    ref = psum_overlapped(local, mesh, "x", use_ring=False)
    err = torch.tensor(float((ring - ref).abs().max()))
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    out["ring"] = {"err": float(err), "local_unchanged": bool(torch.equal(
        local, xs[r * 8:(r + 1) * 8]))}


def _local_shards(tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.mesh import P, to_placements
    mesh = init_device_mesh("cpu", SHARD_MESH, mesh_dim_names=SHARD_AXES)
    x = torch.arange(int(np.prod(SHARD_SHAPE))).reshape(SHARD_SHAPE)
    mine = []
    for spec in SHARD_SPECS:
        local = distribute_tensor(x, mesh, to_placements(mesh, P(*spec), x.ndim),
                                  src_data_rank=None).to_local()
        start = np.unravel_index(int(local.min()), SHARD_SHAPE)
        mine.append([[int(a), int(a) + n] for a, n in zip(start, local.shape)])
    coord = mesh.get_coordinate()
    (tmp / f"shards_{dist.get_rank()}.json").write_text(json.dumps(
        {"coord": list(coord), "slices": mine}))


def _train(out, params, batch, meshes):
    cfg = _cfg()
    for name, (shape, kw, accum) in TRAIN_CASES.items():
        trc = ttrain.TrainRunConfig(opt=OptConfig(**OPT), grad_accum=accum)
        mesh = meshes[shape]
        if mesh is None:            # a rank outside the straddle mesh's 7
            continue
        step, _, _, st_sh, b_sh, model = ttrain.build_train_step(
            cfg, mesh, B=B, S=S, rc=_rc(**kw), trc=trc)
        state = ttrain.distribute(init_state(params), st_sh)
        db = shard_batch(batch, mesh, specs_of(b_sh))
        with _recording_grads() as seen, counting_spread_heads() as spread:
            new, met = step(state, db)
        loss, grads = seen[0]                 # the first (micro-)batch's
        out[name] = {"attn_shard": model.rc.attn_shard, "loss": float(_whole({"l": loss})["l"]),
                     "grads": _whole(grads), "params": _whole(new.params),
                     "step_loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                     "spread_heads": len(spread),
                     "placements": {k: [str(p) for p in v.placements]
                                    for k, v in tree_flatten_with_path(new.params).items()}}


@contextlib.contextmanager
def counting_spread_heads():
    """Count the head's products on rows cut unevenly (``_logits``' spread
    path: each rank's model-major piece of the vocab)."""
    from repro_torch.models import transformer
    calls, real = [], transformer.spread_logits

    def spread(*args):
        calls.append(1)
        return real(*args)
    transformer.spread_logits = spread
    try:
        yield calls
    finally:
        transformer.spread_logits = real


@contextlib.contextmanager
def _recording_grads():
    """Record each (loss, grads) the train step's ``value_and_grad`` returns
    (one a micro-batch), so a step yields its own gradients."""
    seen, real = [], ttrain.value_and_grad

    def record(*args):
        seen.append(real(*args))
        return seen[-1]
    ttrain.value_and_grad = record
    try:
        yield seen
    finally:
        ttrain.value_and_grad = real


def _serve(out, params, batch, meshes):
    for case, shape in SERVE_MESHES.items():
        out[case] = serve_logits(params, batch, meshes[shape])
    # 7 of the 8 ranks: each holds 2 of the 14 heads, which straddle GQA groups
    mesh = meshes[(1, STRADDLE_TP)]
    if mesh is not None:
        out["serve_straddle"] = serve_logits(params, batch, mesh)


def serve_logits(params, batch, mesh):
    """Prefill of ``batch``'s tokens, the cache grown by DECODE_STEPS, then
    DECODE_STEPS greedy decode steps: every step's logits, whole."""
    cfg = _cfg()
    nb = batch["tokens"].shape[0]
    prefill, _, _, p_sh, _ = tserve.build_prefill_step(cfg, mesh, B=nb, S=S, rc=_rc())
    shape = ShapeConfig("serve", "decode", S + DECODE_STEPS, nb)
    decode, _, _, _, shardings, _ = tserve.build_decode_step(cfg, shape, mesh, rc=_rc())
    prompt = {"tokens": batch["tokens"]}
    if mesh is not None:
        b_sh = shardings[2]      # the batch dim on dp, as for the prompt's
        params = ttrain.distribute(params, p_sh)
        prompt = shard_batch(prompt, mesh, specs_of(b_sh))
    else:
        prompt = {k: torch.from_numpy(v) for k, v in prompt.items()}
    with torch.no_grad():
        logits, cache = prefill(params, prompt)
        cache = tserve.grow_cache(cache, DECODE_STEPS)
        steps = [_whole({"l": logits})["l"]]
        for _ in range(DECODE_STEPS):
            tok = steps[-1][:, -1:].argmax(-1).to(torch.int32).numpy()
            tb = ({"tokens": torch.from_numpy(tok)} if mesh is None
                  else shard_batch({"tokens": tok}, mesh, specs_of(b_sh)))
            logits, cache = decode(params, cache, tb)
            steps.append(_whole({"l": logits})["l"])
    return torch.stack([s[:, -1] for s in steps])


def _elastic(out, ckpt_dir):
    from repro_torch.runtime.elastic import ElasticRunner
    cfg = _cfg()
    data = iter(SyntheticLM(DataConfig(batch=B, seq_len=S, vocab_size=cfg.vocab_size)))
    runner = ElasticRunner(cfg, B, S, str(ckpt_dir), rc=_rc(),
                           trc=ttrain.TrainRunConfig(opt=OptConfig(**ELASTIC_OPT)),
                           ckpt_every=ELASTIC["ckpt_every"])
    res = runner.run(data, steps=ELASTIC["steps"], fail_at=ELASTIC["fail_at"],
                     fail_devices=ELASTIC["fail_devices"])
    out["elastic"] = res


def worker(rank: int, tmp: Path) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'rendezvous'}",
                            rank=rank, world_size=WORLD)
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    params = tree_rebuild(build(_cfg(), _rc()).init_eval_shape(), inputs["params"])
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import mesh_from_ranks
    meshes = {shape: init_device_mesh("cpu", shape, mesh_dim_names=AXES[len(shape)])
              for shape in ((4, 2), (2, 4), (2, 2, 2))}
    # every rank takes part in making it; rank 7 gets None
    meshes[(1, STRADDLE_TP)] = mesh_from_ranks(range(STRADDLE_TP), (1, STRADDLE_TP),
                                               ("data", "model"))
    out = {"seconds": {}}
    phases = (("ring", lambda: _ring(out)), ("shards", lambda: _local_shards(tmp)),
              ("train", lambda: _train(out, params, inputs["batch"], meshes)),
              ("serve", lambda: _serve(out, params, inputs["batch"], meshes)),
              ("elastic", lambda: _elastic(out, tmp / "ckpt")))
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        out["seconds"][name] = time.perf_counter() - t0
    if rank == 0:
        torch.save(out, tmp / "results.pt")
    dist.barrier()      # the ranks that left the elastic run wait for the rest
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the test's side
# ---------------------------------------------------------------------------
_JAX = """
import dataclasses, json, pickle
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.checkpoint.checkpointer import Checkpointer
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import DataConfig, SyntheticLM, shard_batch
from repro.launch.mesh import make_mesh
from repro.models import RunConfig, build
from repro.optim.adamw import OptConfig, init_state
from repro.runtime import serve
from repro.runtime.elastic import ElasticRunner
from repro.runtime.train import TrainRunConfig, build_train_step

tmp = Path(TMP)
a = json.loads((tmp / "jax_args.json").read_text())
out = {}

# the local shards of each spec on the (2, 2, 2) mesh
mesh = make_mesh(a["shard_mesh"], a["shard_axes"])
x = np.arange(int(np.prod(a["shard_shape"]))).reshape(a["shard_shape"])
shards = {}
for i, spec in enumerate(a["shard_specs"]):
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    arr = jax.device_put(x, NamedSharding(mesh, P(*spec)))
    for sh in arr.addressable_shards:
        coord = [int(c) for c in np.argwhere(mesh.devices == sh.device)[0]]
        sl = [[s.start or 0, s.stop if s.stop is not None else d]
              for s, d in zip(sh.index, x.shape)]
        shards.setdefault(json.dumps(coord), [None] * len(a["shard_specs"]))[i] = sl
out["shards"] = shards


def flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def mesh_of(shape):
    n = int(np.prod(shape))
    return jax.make_mesh(tuple(shape), ("pod", "data", "model")[-len(shape):],
                         devices=jax.devices()[:n], axis_types=(AxisType.Auto,) * len(shape))


cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), **a["cfg"])
rc = RunConfig(param_dtype="float32", compute_dtype="float32")
model = build(cfg, rc)
params = model.init(jax.random.PRNGKey(0))
host = jax.tree.map(np.asarray, params)     # placed anew for each donating step
batch = {k: jnp.asarray(v) for k, v in np.load(tmp / "batch.npz").items()}
B, S = a["B"], a["S"]

# the full batch's loss and gradients: the step's mean gradient in every case
loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
out["loss"], out["grads"] = float(loss), flat(grads)
for name, (shape, kw, accum) in a["train"].items():
    if accum > 1:       # the first micro-batch's, as one process cuts it
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(
            params, {k: v[:B // accum] for k, v in batch.items()})
        out[name + "/micro0"] = {"loss": float(loss), "grads": flat(grads)}
    mesh = mesh_of(shape)
    trc = TrainRunConfig(opt=OptConfig(**a["opt"]), grad_accum=accum)
    step, _, _, st_sh, b_sh, _ = build_train_step(cfg, mesh, B=B, S=S, rc=rc.replace(**kw),
                                                  trc=trc)
    new, met = step(jax.device_put(init_state(host), st_sh),
                    shard_batch(batch, mesh, jax.tree.map(lambda s: s.spec, b_sh)))
    out[name] = {"step_loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                 "params": flat(new.params)}

# prefill, the cache grown by the decode steps, greedy decode: last-position logits
n = a["decode_steps"]
for case, shape in a["serve"].items():
    mesh = mesh_of(shape)
    prefill, _, _, p_sh, _ = serve.build_prefill_step(cfg, mesh, B=B, S=S, rc=rc)
    decode, *_, (_, c_sh, _), _ = serve.build_decode_step(
        cfg, ShapeConfig("serve", "decode", S + n, B), mesh, rc=rc)
    sp = jax.device_put(host, p_sh)
    logits, cache = prefill(sp, {"tokens": batch["tokens"]})
    pad = ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))
    cache = jax.device_put(dict(cache, k=jnp.pad(cache["k"], pad),
                                v=jnp.pad(cache["v"], pad)), c_sh)
    steps = [logits[:, -1]]
    for _ in range(n):
        tok = jnp.argmax(steps[-1], axis=-1)[:, None].astype(jnp.int32)
        logits, cache = decode(sp, cache, {"tokens": tok})
        steps.append(logits[:, -1])
    out[case] = np.stack([np.asarray(l) for l in steps])

# the elastic run from the weights' checkpoint at step 0
ck = tmp / "jax_ckpt"
Checkpointer(str(ck)).save(init_state(params), 0, blocking=True)
data = iter(SyntheticLM(DataConfig(batch=B, seq_len=S, vocab_size=cfg.vocab_size)))
el = a["elastic"]
runner = ElasticRunner(cfg, B, S, str(ck), rc=rc, ckpt_every=el["ckpt_every"],
                       trc=TrainRunConfig(opt=OptConfig(**a["elastic_opt"])))
out["elastic"] = runner.run(data, steps=el["steps"], fail_at=el["fail_at"],
                            fail_devices=el["fail_devices"])
(tmp / "jax_refs.pkl").write_bytes(pickle.dumps(out))
print("JAX_REFS_OK")
"""


def _jax_args():
    return {"cfg": {"n_layers": LAYERS, "n_heads": 14, "n_kv_heads": 2, "vocab_size": VOCAB},
            "B": B, "S": S, "opt": OPT, "decode_steps": DECODE_STEPS,
            "train": TRAIN_CASES, "elastic": ELASTIC, "elastic_opt": ELASTIC_OPT,
            "serve": dict(SERVE_MESHES, serve_straddle=(1, STRADDLE_TP)),
            "shard_mesh": SHARD_MESH, "shard_axes": SHARD_AXES, "shard_shape": SHARD_SHAPE,
            "shard_specs": SHARD_SPECS}


def _jax_params(cfg):
    import jax
    from repro.configs import get_config as jax_config
    from repro.models import RunConfig as JaxRunConfig, build as jax_build
    from repro_torch.convert import params_from_jax
    jc = dataclasses.replace(jax_config("qwen2-0.5b").reduced(), n_layers=LAYERS,
                             n_heads=14, n_kv_heads=2, vocab_size=VOCAB)
    assert (jc.n_heads, jc.n_kv_heads, jc.vocab_size) == (cfg.n_heads, cfg.n_kv_heads,
                                                          cfg.vocab_size)
    jm = jax_build(jc, JaxRunConfig(param_dtype="float32", compute_dtype="float32"))
    return params_from_jax(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                           device="cpu")


def _batch():
    toks = np.random.default_rng(0).integers(0, VOCAB, (B, S + 1)).astype(np.int32)
    return {"tokens": np.ascontiguousarray(toks[:, :-1]),
            "labels": np.ascontiguousarray(toks[:, 1:])}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the world once; the port's single-process references and the
    JAX package's beside it. Every run starts from the JAX init's weights
    (the elastic runs from their checkpoint at step 0)."""
    from tests.torch_world import join_world, run_world
    from tests.util import run_subprocess
    tmp = tmp_path_factory.mktemp("gloo_world")
    cfg = _cfg()
    params, batch = _jax_params(cfg), _batch()
    torch.save({"params": tree_flatten_with_path(params), "batch": batch}, tmp / "inputs.pt")
    np.savez(tmp / "batch.npz", **batch)
    (tmp / "jax_args.json").write_text(json.dumps(_jax_args()))
    ckpt = Checkpointer(tmp / "ckpt")
    ckpt.save(init_state(params), 0, blocking=True)
    deadline = time.monotonic() + TIMEOUT_S
    procs = run_world(__file__, WORLD, tmp)
    try:
        run_subprocess(_JAX.replace("TMP", repr(str(tmp))), devices=WORLD)
        train = _single_train(cfg, params, batch)
        port = {"heads": train, "seq": train, "straddle": train, "seq_remat": train,
                "heads_accum": _single_train(cfg, params, batch, grad_accum=2),
                "pod_spread": _single_train(cfg, params, batch, grad_accum=4),
                "elastic": _single_elastic(cfg, params)}
        port["serve"] = port["serve_seq"] = port["serve_straddle"] = serve_logits(
            params, batch, None)
    finally:
        join_world(procs, tmp, deadline, TIMEOUT_S)
    jax_refs = pickle.loads((tmp / "jax_refs.pkl").read_bytes())
    for case in TRAIN_CASES:        # the step's mean gradient is the full batch's
        first = jax_refs.get(case + "/micro0", jax_refs)    # the step's first (micro-)batch
        jax_refs[case].update(step_grads=jax_refs["grads"], loss=first["loss"],
                              grads=first["grads"])
    return {"out": torch.load(tmp / "results.pt", weights_only=False),
            "refs": {"port": port, "jax": jax_refs}, "tmp": tmp}


def _single_train(cfg, params, batch, grad_accum=1):
    trc = ttrain.TrainRunConfig(opt=OptConfig(**OPT), grad_accum=grad_accum)
    step, *_, model = ttrain.build_train_step(cfg, None, B=B, S=S, rc=_rc(), trc=trc)
    state = init_state(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with _recording_grads() as seen:
        new, met = step(state, tb)
    loss, grads = seen[0]
    micro = [_whole(g) for _, g in seen]          # the step's mean gradient
    step_grads = {k: sum(g[k] for g in micro) / len(micro) for k in micro[0]}
    return {"loss": float(loss), "grads": _whole(grads), "params": _whole(new.params),
            "step_grads": step_grads,
            "step_loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])}


def _single_elastic(cfg, params):
    """The elastic run's schedule in one process: steps 1-8 from the
    weights, then, from the state after step 5 (the restored checkpoint),
    the next batches 9 and 10."""
    trc = ttrain.TrainRunConfig(opt=OptConfig(**ELASTIC_OPT))
    step, *_ = ttrain.build_train_step(cfg, None, B=B, S=S, rc=_rc(), trc=trc)
    state = init_state(params)
    data = iter(SyntheticLM(DataConfig(batch=B, seq_len=S, vocab_size=cfg.vocab_size)))
    losses, saved = [], None
    for i in range(1, ELASTIC["steps"] + 1):
        if i == ELASTIC["fail_at"] + 1:
            state = saved
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        if i == ELASTIC["ckpt_every"]:
            saved = state
    return {"losses": losses}


def test_ring_all_reduce_matches_all_reduce(world):
    ring = world["out"]["ring"]
    assert ring["err"] < 1e-5, ring
    assert ring["local_unchanged"]


def test_local_shards_equal_jax_addressable_shards(world):
    jax_shards = world["refs"]["jax"]["shards"]
    got = [json.loads(p.read_text()) for p in sorted(world["tmp"].glob("shards_*.json"))]
    assert len(got) == WORLD and len(jax_shards) == WORLD
    for rank in got:
        assert rank["slices"] == jax_shards[json.dumps(rank["coord"])], rank["coord"]


def _check_train(got, ref, case):
    """The loss and gradients are those of the step's first (micro-)batch
    (its first ``value_and_grad``). With grad_accum the mesh step cuts its
    micro-batches as one process and JAX's ``split`` cut them (the rows
    ``[0, B / a)`` first), so the first micro-batch's loss and every
    gradient leaf are compared, and the step's loss, grad norm and params."""
    assert got["attn_shard"] == ("heads" if _cfg().n_heads % TRAIN_CASES[case][0][-1] == 0
                                 else "seq")
    for key in ("loss", "step_loss", "grad_norm"):
        assert abs(got[key] - ref[key]) <= 1e-5 * abs(ref[key]), (key, got[key], ref[key])
    for k, g in ref["grads"].items():
        g = torch.as_tensor(g)
        scale = float(g.abs().max())
        assert scale > 0, k
        assert float((got["grads"][k] - g).abs().max()) <= 1e-4 * scale, k
    assert got["params"].keys() == ref["params"].keys()
    lr = OPT["lr"]
    for k, p in ref["params"].items():
        # Adam's first step moves each element by about lr * sign(g): where
        # the step's gradient lies within the gradients' tolerance of 0, the
        # two runs may take opposite signs, up to 2 lr apart
        g = torch.as_tensor(ref["step_grads"][k])
        near0 = g.abs() <= 1e-4 * float(g.abs().max())
        diff = (got["params"][k] - torch.as_tensor(p)).abs()
        assert float(diff[~near0].max()) <= STEP_TOL, k
        assert float(diff.max()) <= 2 * lr + STEP_TOL, k
    # the state keeps the param specs' placements: wq's columns on tp, its rows on
    # fsdp (and replicated over a pod)
    assert got["placements"]["blocks/attn/wq"] == ["R"] * (len(TRAIN_CASES[case][0]) - 2) + [
        "S(1)", "S(2)"]


def test_only_uneven_micro_batches_take_the_spread_head(world):
    """``pod_spread``: 8 rows at grad_accum 4 on (pod 2, data 2, model 2), a
    micro-batch of 2 rows on 4 dp ranks: each of its 4 heads runs on each
    rank's model-major vocab piece (``layers.spread_logits``: taken along
    pod, its D brought together over data), held to one process and JAX by
    the train tests. The even cases never take it."""
    for case, (shape, _, accum) in TRAIN_CASES.items():
        dp = int(np.prod(shape[:-1]))
        expect = accum if (B // accum) % dp else 0
        if case in world["out"]:
            assert world["out"][case]["spread_heads"] == expect, (case, expect)
    assert world["out"]["pod_spread"]["spread_heads"] == 4


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_sharded_train_step_matches_single_process(world, case):
    _check_train(world["out"][case], world["refs"]["port"][case], case)
    assert world["out"][case]["grads"].keys() == world["refs"]["port"][case]["grads"].keys()


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_sharded_train_step_matches_jax(world, case):
    """Against the JAX package's sharded step on the same mesh and knobs."""
    _check_train(world["out"][case], world["refs"]["jax"][case], case)


@pytest.mark.parametrize("ref_of", ["port", "jax"])
@pytest.mark.parametrize("case", ["serve", "serve_seq", "serve_straddle"])
def test_sharded_prefill_and_decode_match_single_process(world, case, ref_of):
    """``ref_of`` "port": one process of the port; "jax": the JAX package's
    sharded prefill and decode on the same mesh."""
    got, ref = world["out"][case], torch.as_tensor(world["refs"][ref_of][case])
    assert got.shape == ref.shape == (DECODE_STEPS + 1, B, 512)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("ref_of", ["port", "jax"])
def test_elastic_shrink_restores_and_replays(world, ref_of):
    """``ref_of`` "port": a single-process loop that replays the schedule;
    "jax": the JAX package's ElasticRunner on 8 host devices."""
    res, ref = world["out"]["elastic"], world["refs"][ref_of]["elastic"]
    assert "device failure: 8 -> 4" in res["events"], res["events"]
    assert any(e.startswith("restored step=5") for e in res["events"]), res["events"]
    assert res["final_step"] == ELASTIC["ckpt_every"] + ELASTIC["steps"] - ELASTIC["fail_at"]
    if ref_of == "jax":
        assert [e.split(" mesh=")[0] for e in res["events"] if "rank" not in e] == \
            [e.split(" mesh=")[0] for e in ref["events"]], (res["events"], ref["events"])
        assert res["final_step"] == ref["final_step"]
    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=STEP_TOL, atol=0)


def test_production_meshes_on_the_fake_backend():
    code = (
        "import torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "from repro_torch.parallel.mesh import mesh_axes\n"
        "for n, multi in ((256, False), (512, True)):\n"
        "    dist.init_process_group('fake', store=FakeStore(), rank=0, world_size=n)\n"
        "    m = make_production_mesh(multi_pod=multi)\n"
        "    print(n, mesh_axes(m), m.device_type)\n"
        "    dist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines() == [
        "256 {'data': 16, 'model': 16} cpu",
        "512 {'pod': 2, 'data': 16, 'model': 16} cpu"]


def test_chip_smoke_mesh_helpers_on_a_cpu_world_of_one(tmp_path):
    """chip_smoke.py phase 10's helpers, rehearsed on a gloo world of one rank
    and a (1, 1) mesh at a tiny size: the mesh path's train steps equal the
    no-mesh ones (also at grad_accum 2), its greedy tokens too, and the
    elastic runner resumes."""
    code = (
        "import dataclasses, torch, torch.distributed as dist\n"
        "import chip_smoke as cs\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch.mesh import make_mesh\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path / 'rdv'}',\n"
        "                        rank=0, world_size=1)\n"
        "mesh = make_mesh((1, 1), ('data', 'model'))\n"
        "cfg = dataclasses.replace(get_config('qwen2-0.5b').reduced(), n_layers=1)\n"
        "kw = dict(device='cpu', batch=2, seq_len=16, steps=2)\n"
        "a, b = cs.train(cfg, **kw), cs.train(cfg, mesh=mesh, **kw)\n"
        "assert [m['loss'] for m in a['metrics']] == [m['loss'] for m in b['metrics']]\n"
        "a, b = cs.train(cfg, grad_accum=2, **kw), cs.train(cfg, mesh=mesh, grad_accum=2, **kw)\n"
        "assert [m['loss'] for m in a['metrics']] == [m['loss'] for m in b['metrics']]\n"
        "kw = dict(device='cpu', batch=2, prompt_len=8, decode_steps=2)\n"
        "a, b = cs.serve(cfg, **kw), cs.serve(cfg, mesh=mesh, **kw)\n"
        "assert torch.equal(a['tokens'], b['tokens']) and b['prefill_launches'] == \\\n"
        "    {'attention': 0, 'ssd': 0}\n"
        f"el = cs.elastic_resume(cfg, device='cpu', mesh=mesh, ckpt_dir='{tmp_path / 'ck'}',\n"
        "                       batch=2, seq_len=16, steps=2, every=1, more=1)\n"
        "assert el['restore_shardings_equal'], el\n"
        "assert 'restored step=2 mesh=None' in el['run2']['events'], el\n"
        "assert el['run2']['final_step'] == 3, el\n"
        "dist.destroy_process_group()\n"
        "print('MESH_HELPERS_OK')\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MESH_HELPERS_OK" in out.stdout


def card_check(tmp: Path) -> None:
    """The world against the port in one process, on weights of the port's
    own seeded init (the elastic run from their checkpoint at step 0): the
    run for a machine without JAX (the card's, whose torch may differ from
    the one the tests run on). ``python tests/test_torch_distributed.py
    card-check <tmp>``: the script's directory is on the path (a ``tests``
    package installed elsewhere may shadow this one)."""
    from torch_world import join_world, run_world
    cfg = _cfg()
    params, batch = build(cfg, _rc()).init(torch.Generator().manual_seed(0)), _batch()
    torch.save({"params": tree_flatten_with_path(params), "batch": batch}, tmp / "inputs.pt")
    Checkpointer(tmp / "ckpt").save(init_state(params), 0, blocking=True)
    t0 = time.monotonic()
    join_world(run_world(__file__, WORLD, tmp), tmp, t0 + TIMEOUT_S, TIMEOUT_S)
    train = _single_train(cfg, params, batch)
    port = {"heads": train, "seq": train, "straddle": train, "seq_remat": train,
            "heads_accum": _single_train(cfg, params, batch, grad_accum=2),
            "pod_spread": _single_train(cfg, params, batch, grad_accum=4),
            "elastic": _single_elastic(cfg, params)}
    port["serve"] = port["serve_seq"] = port["serve_straddle"] = serve_logits(params, batch,
                                                                              None)
    world = {"out": torch.load(tmp / "results.pt", weights_only=False),
             "refs": {"port": port}, "tmp": tmp}
    test_ring_all_reduce_matches_all_reduce(world)
    for case in sorted(TRAIN_CASES):
        test_sharded_train_step_matches_single_process(world, case)
    test_only_uneven_micro_batches_take_the_spread_head(world)
    for case in ("serve", "serve_seq", "serve_straddle"):
        test_sharded_prefill_and_decode_match_single_process(world, case, "port")
    test_elastic_shrink_restores_and_replays(world, "port")
    print(f"CARD_CHECK_OK torch {torch.__version__}: the ring, {len(TRAIN_CASES)} train "
          f"cases, 3 served and the elastic run on the gloo world of {WORLD} equal one "
          f"process; seconds {world['out']['seconds']}")


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), Path(sys.argv[3]))
if __name__ == "__main__" and sys.argv[1:2] == ["card-check"]:
    card_check(Path(sys.argv[2]))
