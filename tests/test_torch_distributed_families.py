"""The mesh paths of the ssm, hybrid, moe, audio and vlm families in the
port (repro_torch), on a CPU gloo world of 4 ranks on a (data=2, model=2)
mesh: the twins of ``tests/test_torch_distributed.py``'s dense ones.

One world of 4 spawned ranks (``python
tests/test_torch_distributed_families.py worker <rank> <tmp>``, started
and joined by ``tests/torch_world.py``: a ``file://`` rendezvous in the
test's tmp dir, killed on the first failure or after ``TIMEOUT_S``)
runs every case in turn and rank 0 writes the results. The ranks import
no JAX.

The models are reduced mamba2-2.7b (16 SSD heads of P 16, N 16),
zamba2-1.2b (two Mamba2 layers and the shared attention block after
them), qwen2-moe-a2.7b (8 experts padded to 16, top 2, a shared
expert), musicgen-medium (frame embeddings in) and llama-3.2-vision-11b
(one cross block over 16 image embeddings, its gate set to ``GATE``,
since at 0 it hides the cross path), each at 2 layers of width 128 in
f32, with weights made by the JAX package's init. On the mesh the SSD
heads, the attention heads and the experts are split over model=2 and
the batch of B=4 over data=2: K2 and K1 run on each rank's local heads.
Serving is a prefill of S=32 and ``DECODE_STEPS`` greedy decode steps
against the grown cache (for audio, seeded frames); the MoE routes at
the default group (128 tokens, straddling the two data ranks' rows:
each rank routes them all). zamba2 is also served one request
alone (``LONG_CTX``): with the batch below the data axis the decode
cache takes the long-context layout, its T cut over data, so each rank
writes and attends over its own slots and the softmax is reduced over
them. Training is one AdamW step of mamba2, zamba2 and qwen2-moe, the
MoE at ``TRAIN_MOE_GROUP`` (each rank routes its own groups), and the
``ACCUM`` cases: mamba2 at grad_accum 4, qwen2-moe at 2 and 4. Each
micro-batch holds the rows one process's cut gives it, spread over the
data ranks (``runtime.train.micro_batch``): at 2, one row a rank; at 4
(a micro-batch of one row on two data ranks), one rank holds the row
and the other none. An MoE's micro-batch loss is not linear in its rows
(the aux loss is a product of two means over its tokens, and its
capacity groups are its own), so the step's loss and gradient equal one
process's only when every micro-batch holds the same rows. At 4 each
micro-batch's head takes the spread path (``layers.spread_logits``: all
its rows against each rank's model-major piece of the vocab).

Every result is held twice: against the port in one process, and
against the JAX package's sharded twin on the same weights and inputs
(one subprocess of 4 host devices running its sharded prefill, decode
and train step on the same mesh). Serving: logits within 1e-5. Train:
loss within 1e-5 relative, every gradient leaf within 1e-4 of its leaf's
largest value (the step's loss and gradient: their means over its
micro-batches, which are the whole batch's), params after the step within ``STEP_TOL`` (Adam's first
step turns a gradient within f32 rounding of zero into up to 2 lr of
param difference). And K2's local-heads call (``ssm._local_ssd``)
joined over the ranks equals the whole call on the CPU's plain path.
"""
import contextlib
import dataclasses
import json
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import shard_batch  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.optim.adamw import OptConfig, init_state  # noqa: E402
from repro_torch.parallel.sharding import (ShardingPolicy, batch_specs, specs_of,  # noqa: E402
                                           to_named, whole)
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_rebuild  # noqa: E402

WORLD = 4
MESH = (2, 2)
AXES = ("data", "model")
TIMEOUT_S = 420
B, S = 4, 32
LAYERS = 2
DECODE_STEPS = 2
GATE = 0.5
SERVE_ARCHS = ("mamba2-2.7b", "zamba2-1.2b", "qwen2-moe-a2.7b", "musicgen-medium",
               "llama-3.2-vision-11b")
TRAIN_ARCHS = ("mamba2-2.7b", "zamba2-1.2b", "qwen2-moe-a2.7b")
TRAIN_MOE_GROUP = 32        # each data rank's 2 x 32 rows hold whole groups
LONG_CTX = "zamba2-1.2b"    # also served at batch 1: the cache's T on data
# the train cases at grad_accum > 1: case -> (arch, grad_accum). The batch puts
# 2 rows on each data rank: at 2 a micro-batch holds one row a rank, at 4 one
# row on the first data rank and none on the second (an empty shard)
ACCUM = {"train_accum/mamba2-2.7b": ("mamba2-2.7b", 4),
         "train_accum2/qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", 2),
         "train_accum4/qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", 4)}
STEP_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=0)
LOGITS_TOL = 1e-5
# K2 on local heads: (b, s, h, p, n, chunk), heads split over model=2
K2_SHAPE = (4, 64, 16, 16, 16, 16)


def _cfg(arch):
    cfg = get_config(arch).reduced()
    kw = {"n_layers": LAYERS}
    if cfg.attn_every:
        kw["attn_every"] = LAYERS
    if cfg.cross_attn_every:
        kw["cross_attn_every"] = LAYERS
    return dataclasses.replace(cfg, **kw)


def _rc(arch, train=False, **kw):
    if train and get_config(arch).n_experts:
        kw["moe_group"] = TRAIN_MOE_GROUP
    return RunConfig(device="cpu", compute_dtype=torch.float32, **kw)


def _whole(tree):
    return {k: whole(v).detach().clone() for k, v in tree_flatten_with_path(tree).items()}


def _inputs(cfg):
    """The seeded host inputs of one arch: the prompt (and its labels) by
    frontend, and the audio family's decode frames."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"labels": np.ascontiguousarray(toks[:, 1:])}
    if cfg.frontend == "audio":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = np.ascontiguousarray(toks[:, :-1])
    if cfg.frontend == "vision":
        batch["img_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    frames = rng.standard_normal((DECODE_STEPS, B, 1, cfg.d_model)).astype(np.float32)
    return {"batch": batch, "frames": frames}


# ---------------------------------------------------------------------------
# the rank's side (no JAX)
# ---------------------------------------------------------------------------
def k2_local_heads(mesh):
    """``_local_ssd`` on DTensors (heads on model, batch on data) joined whole,
    and the whole call on the plain path, from the same seeded inputs."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.models.ssm import _local_ssd
    b, s, h, p, n, chunk = K2_SHAPE
    g = torch.Generator().manual_seed(0)
    x = torch.randn((b, s, h, p), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g))
    A = -torch.exp(0.3 * torch.randn((h,), generator=g))
    Bm, Cm = (0.5 * torch.randn((b, s, n), generator=g) for _ in range(2))
    init = 0.5 * torch.randn((b, h, p, n), generator=g)

    def put(t, pl):
        return distribute_tensor(t, mesh, pl, src_data_rank=None)
    heads, rows, rep = [Shard(0), Shard(2)], [Shard(0), Replicate()], [Replicate()] * 2
    y, st = _local_ssd(put(x, heads), put(dt, heads), put(A, rep), put(Bm, rows),
                       put(Cm, rows), chunk=chunk,
                       init_state=put(init, [Shard(0), Shard(1)]))
    ref_y, ref_st = ops.ssd(x, dt, A, Bm, Cm, chunk=chunk, init_state=init)
    return {"local_heads": tuple(y.to_local().shape), "y": whole(y), "state": whole(st),
            "ref_y": ref_y, "ref_state": ref_st}


def serve_logits(cfg, params, inputs, mesh, batch=B):
    """Prefill of the first ``batch`` prompts, the cache grown by
    DECODE_STEPS, then DECODE_STEPS greedy decode steps (audio: the seeded
    frames): every step's last-position logits, whole."""
    arch = cfg.name.removesuffix("-reduced")
    prefill, _, batch_meta, p_sh, _ = tserve.build_prefill_step(cfg, mesh, B=batch, S=S,
                                                               rc=_rc(arch))
    shape = ShapeConfig("serve", "decode", S + DECODE_STEPS, batch)
    decode, _, _, dec_meta, shardings, _ = tserve.build_decode_step(cfg, shape, mesh,
                                                                    rc=_rc(arch))
    prompt = {k: v[:batch] for k, v in inputs["batch"].items() if k in batch_meta}

    def place(batch, meta):
        if mesh is None:
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        return shard_batch(batch, mesh, specs_of(to_named(
            batch_specs(meta, mesh, ShardingPolicy()), mesh)))
    if mesh is not None:
        params = ttrain.distribute(params, p_sh)
    with torch.no_grad():
        logits, cache = prefill(params, place(prompt, batch_meta))
        cache = tserve.grow_cache(cache, DECODE_STEPS)
        steps = [_whole({"l": logits})["l"]]
        for i in range(DECODE_STEPS):
            if cfg.frontend == "audio":
                nxt = {"embeds": inputs["frames"][i][:batch]}
            else:
                nxt = {"tokens": steps[-1][:, -1:].argmax(-1).to(torch.int32).numpy()}
            logits, cache = decode(params, cache, place(nxt, dec_meta))
            steps.append(_whole({"l": logits})["l"])
    return torch.stack([s[:, -1] for s in steps])


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
    """Record each (loss, grads) the train step's ``value_and_grad`` returns."""
    seen, real = [], ttrain.value_and_grad

    def record(*args):
        seen.append(real(*args))
        return seen[-1]
    ttrain.value_and_grad = record
    try:
        yield seen
    finally:
        ttrain.value_and_grad = real


def train_step(cfg, params, inputs, mesh, grad_accum=1):
    """One AdamW step: the step's loss and gradient (each the mean over its
    micro-batches, which is the whole batch's), metrics and new params, whole."""
    arch = cfg.name.removesuffix("-reduced")
    trc = ttrain.TrainRunConfig(opt=OptConfig(**OPT), grad_accum=grad_accum)
    step, _, batch_meta, st_sh, b_sh, _ = ttrain.build_train_step(
        cfg, mesh, B=B, S=S, rc=_rc(arch, train=True), trc=trc)
    batch = {k: v for k, v in inputs["batch"].items() if k in batch_meta}
    state = init_state(params)
    if mesh is None:
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    else:
        state = ttrain.distribute(state, st_sh)
        batch = shard_batch(batch, mesh, specs_of(b_sh))
    with _recording_grads() as seen, counting_spread_heads() as spread:
        new, met = step(state, batch)
    micro = [_whole(g) for _, g in seen]
    return {"loss": sum(float(_whole({"l": l})["l"]) for l, _ in seen) / len(seen),
            "grads": {k: sum(g[k] for g in micro) / len(micro) for k in micro[0]},
            "params": _whole(new.params), "step_loss": float(met["loss"]),
            "grad_norm": float(met["grad_norm"]), "spread_heads": len(spread)}


def _port_params(cfg, flat):
    return tree_rebuild(build(cfg, _rc(cfg.name)).init_eval_shape(), flat)


def worker(rank: int, tmp: Path) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'rendezvous'}",
                            rank=rank, world_size=WORLD)
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=AXES)
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    out = {"seconds": {}}
    t0 = time.perf_counter()
    out["k2"] = k2_local_heads(mesh)
    out["seconds"]["k2"] = time.perf_counter() - t0
    for arch in SERVE_ARCHS:
        cfg = _cfg(arch)
        t0 = time.perf_counter()
        params = _port_params(cfg, inputs[arch]["params"])
        out[f"serve/{arch}"] = serve_logits(cfg, params, inputs[arch], mesh)
        if arch == LONG_CTX:
            out[f"serve1/{arch}"] = serve_logits(cfg, params, inputs[arch], mesh, batch=1)
        if arch in TRAIN_ARCHS:
            out[f"train/{arch}"] = train_step(cfg, params, inputs[arch], mesh)
        for case, (accum_arch, accum) in ACCUM.items():
            if arch == accum_arch:
                out[case] = train_step(cfg, params, inputs[arch], mesh, grad_accum=accum)
        out["seconds"][arch] = time.perf_counter() - t0
    if rank == 0:
        torch.save(out, tmp / "results.pt")
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the test's side
# ---------------------------------------------------------------------------
_JAX = """
import dataclasses, json, pickle
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import shard_batch
from repro.models import RunConfig, build
from repro.optim.adamw import OptConfig, init_state
from repro.runtime import serve
from repro.runtime.train import TrainRunConfig, build_train_step

tmp = Path(TMP)
a = json.loads((tmp / "jax_args.json").read_text())
inputs = pickle.loads((tmp / "jax_inputs.pkl").read_bytes())
mesh = jax.make_mesh(tuple(a["mesh"]), tuple(a["axes"]), axis_types=(AxisType.Auto,) * 2)
B, S, n = a["B"], a["S"], a["decode_steps"]
out = {}


def flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


for arch, cfg_kw in a["cfgs"].items():
    cfg = dataclasses.replace(get_config(arch).reduced(), **cfg_kw)
    rc = RunConfig(param_dtype="float32", compute_dtype="float32")
    host = inputs[arch]["params"]
    batch = {k: jnp.asarray(v) for k, v in inputs[arch]["batch"].items()}
    for nb, key in [(B, "serve/")] + ([(1, "serve1/")] if arch == a["long_ctx"] else []):
        prefill, _, bmeta, p_sh, _ = serve.build_prefill_step(cfg, mesh, B=nb, S=S, rc=rc)
        decode, *_, (_, c_sh, _), _ = serve.build_decode_step(
            cfg, ShapeConfig("serve", "decode", S + n, nb), mesh, rc=rc)
        sp = jax.device_put(host, p_sh)
        logits, cache = prefill(sp, {k: batch[k][:nb] for k in bmeta})
        pad = ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))
        if "k" in cache:
            cache = dict(cache, k=jnp.pad(cache["k"], pad), v=jnp.pad(cache["v"], pad))
        cache = jax.device_put(cache, c_sh)
        steps = [logits[:, -1]]
        for i in range(n):
            if cfg.frontend == "audio":
                nxt = {"embeds": jnp.asarray(inputs[arch]["frames"][i][:nb])}
            else:
                nxt = {"tokens": jnp.argmax(steps[-1], axis=-1)[:, None].astype(jnp.int32)}
            logits, cache = decode(sp, cache, nxt)
            steps.append(logits[:, -1])
        out[key + arch] = np.stack([np.asarray(l) for l in steps])
    cases = ([("train/" + arch, 1)] if arch in a["train"] else []) + [
        (case, accum) for case, (accum_arch, accum) in a["accum"].items() if accum_arch == arch]
    for key, accum in cases:
        trc = TrainRunConfig(opt=OptConfig(**a["opt"]), grad_accum=accum)
        trc_rc = rc.replace(moe_group=a["train_moe_group"]) if cfg.n_experts else rc
        step, _, tmeta, st_sh, b_sh, model = build_train_step(cfg, mesh, B=B, S=S, rc=trc_rc,
                                                              trc=trc)
        tb = {k: batch[k] for k in tmeta}
        # the step's loss and gradient: their means over its micro-batches
        m = B // accum
        vg = jax.jit(jax.value_and_grad(model.loss))
        micro = [vg(host, {k: v[i * m:(i + 1) * m] for k, v in tb.items()})
                 for i in range(accum)]
        loss = sum(float(l) for l, _ in micro) / accum
        grads = jax.tree.map(lambda *g: sum(g) / accum, *[g for _, g in micro])
        new, met = step(jax.device_put(init_state(host), st_sh),
                        shard_batch(tb, mesh, jax.tree.map(lambda s: s.spec, b_sh)))
        out[key] = {"loss": loss, "grads": flat(grads),
                           "step_loss": float(met["loss"]),
                           "grad_norm": float(met["grad_norm"]),
                           "params": flat(new.params)}
(tmp / "jax_refs.pkl").write_bytes(pickle.dumps(out))
print("JAX_REFS_OK")
"""


def _cfg_kw(cfg):
    return {"n_layers": cfg.n_layers, "attn_every": cfg.attn_every,
            "cross_attn_every": cfg.cross_attn_every}


def _jax_params(arch, cfg):
    """The JAX package's init of the reduced arch (its gates set to GATE), as
    numpy, and the port's tree of the same values."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.models import RunConfig as JaxRunConfig, build as jax_build
    from repro_torch.convert import params_from_jax
    jc = dataclasses.replace(jax_config(arch).reduced(), **_cfg_kw(cfg))
    jm = jax_build(jc, JaxRunConfig(param_dtype="float32", compute_dtype="float32"))
    host = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if "cross_blocks" in host:
        host["cross_blocks"]["gate"] = np.full_like(host["cross_blocks"]["gate"], GATE)
    return host, params_from_jax(host, device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the world once; the port's single-process references and the JAX
    package's sharded twin beside it, all from the JAX init's weights."""
    from tests.torch_world import join_world, run_world
    from tests.util import run_subprocess
    tmp = tmp_path_factory.mktemp("gloo_families")
    rank_inputs, jax_inputs, port = {}, {}, {}
    singles = {}
    for arch in SERVE_ARCHS:
        cfg = _cfg(arch)
        host, params = _jax_params(arch, cfg)
        inputs = _inputs(cfg)
        rank_inputs[arch] = {**inputs, "params": tree_flatten_with_path(params)}
        jax_inputs[arch] = {**inputs, "params": host}
        singles[arch] = (cfg, params, inputs)
    torch.save(rank_inputs, tmp / "inputs.pt")
    (tmp / "jax_inputs.pkl").write_bytes(pickle.dumps(jax_inputs))
    (tmp / "jax_args.json").write_text(json.dumps({
        "mesh": MESH, "axes": AXES, "B": B, "S": S, "decode_steps": DECODE_STEPS,
        "opt": OPT, "train": TRAIN_ARCHS, "train_moe_group": TRAIN_MOE_GROUP,
        "long_ctx": LONG_CTX, "accum": ACCUM,
        "cfgs": {arch: _cfg_kw(_cfg(arch)) for arch in SERVE_ARCHS}}))
    deadline = time.monotonic() + TIMEOUT_S
    procs = run_world(__file__, WORLD, tmp)
    try:
        run_subprocess(_JAX.replace("TMP", repr(str(tmp))), devices=WORLD)
        for arch, (cfg, params, inputs) in singles.items():
            port[f"serve/{arch}"] = serve_logits(cfg, params, inputs, None)
            if arch == LONG_CTX:
                port[f"serve1/{arch}"] = serve_logits(cfg, params, inputs, None, batch=1)
            if arch in TRAIN_ARCHS:
                port[f"train/{arch}"] = train_step(cfg, params, inputs, None)
            for case, (accum_arch, accum) in ACCUM.items():
                if arch == accum_arch:
                    port[case] = train_step(cfg, params, inputs, None, grad_accum=accum)
    finally:
        join_world(procs, tmp, deadline, TIMEOUT_S)
    jax_refs = pickle.loads((tmp / "jax_refs.pkl").read_bytes())
    return {"out": torch.load(tmp / "results.pt", weights_only=False),
            "refs": {"port": port, "jax": jax_refs}}


def test_k2_on_local_heads_joined_equals_the_whole_call(world):
    k2 = world["out"]["k2"]
    b, s, h, p, n, chunk = K2_SHAPE
    assert k2["local_heads"] == (b // 2, s, h // 2, p)
    for key in ("y", "state"):
        np.testing.assert_allclose(k2[key].numpy(), k2[f"ref_{key}"].numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("ref_of", ["port", "jax"])
@pytest.mark.parametrize("case", [f"serve/{a}" for a in SERVE_ARCHS] + [f"serve1/{LONG_CTX}"])
def test_sharded_prefill_and_decode_match(world, case, ref_of):
    """``ref_of`` "port": one process of the port; "jax": the JAX package's
    sharded prefill and decode on the same (2, 2) mesh. "serve1/" is the
    one-request case, its decode cache cut along T over data."""
    got = world["out"][case]
    ref = torch.as_tensor(world["refs"][ref_of][case])
    nb = 1 if case.startswith("serve1/") else B
    assert got.shape == ref.shape == (DECODE_STEPS + 1, nb,
                                      _cfg(case.split("/")[1]).vocab_padded)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=LOGITS_TOL)


@pytest.mark.parametrize("ref_of", ["port", "jax"])
@pytest.mark.parametrize("case", [f"train/{a}" for a in TRAIN_ARCHS]
                         + list(ACCUM))
def test_sharded_train_step_matches(world, case, ref_of):
    """The step's loss and gradient are the means over its micro-batches
    (the whole batch's at grad_accum 1); an ``ACCUM`` case takes its
    micro-batches, the JAX references too."""
    got, ref = world["out"][case], world["refs"][ref_of][case]
    for key in ("loss", "step_loss", "grad_norm"):
        assert abs(got[key] - ref[key]) <= 1e-5 * abs(ref[key]), (key, got[key], ref[key])
    assert got["grads"].keys() == got["params"].keys() == set(ref["grads"])
    for k, g in ref["grads"].items():
        g = torch.as_tensor(g)
        scale = float(g.abs().max())
        assert float((got["grads"][k] - g).abs().max()) <= 1e-4 * max(scale, 1e-30), k
        # Adam's first step moves each element by about lr * sign(g): where the
        # gradient lies within the gradients' tolerance of 0, the runs may take
        # opposite signs, up to 2 lr apart
        near0 = g.abs() <= 1e-4 * scale
        diff = (got["params"][k] - torch.as_tensor(ref["params"][k])).abs()
        assert not bool((diff[~near0] > STEP_TOL).any()), k
        assert float(diff.max()) <= 2 * OPT["lr"] + STEP_TOL, k


def test_uneven_micro_batches_take_the_spread_head(world):
    """At grad_accum 4 a micro-batch of one row sits on one of the two data
    ranks: each of the MoE step's 4 heads runs on each rank's model-major
    vocab piece (``layers.spread_logits``), held to one process and JAX by
    ``test_sharded_train_step_matches``. The even cases never take it."""
    counts = {case: world["out"][case]["spread_heads"]
              for case in [f"train/{a}" for a in TRAIN_ARCHS] + list(ACCUM)}
    print(f"spread heads a step: {counts}")
    assert counts["train_accum4/qwen2-moe-a2.7b"] == 4, counts
    for case, n in counts.items():
        if B // ACCUM.get(case, (None, 1))[1] % MESH[0] == 0:
            assert n == 0, counts


def card_check(tmp: Path) -> None:
    """The world against the port in one process, on weights of the port's
    own seeded init: the run for a machine without JAX (the card's, whose
    torch may differ from the one the tests run on). ``python
    tests/test_torch_distributed_families.py card-check <tmp>``: the
    script's directory is on the path (a ``tests`` package installed
    elsewhere may shadow this one)."""
    from torch_world import join_world, run_world
    rank_inputs, port = {}, {}
    for arch in SERVE_ARCHS:
        cfg = _cfg(arch)
        params = build(cfg, _rc(arch)).init(torch.Generator().manual_seed(0))
        if "cross_blocks" in params:
            params["cross_blocks"]["gate"].fill_(GATE)
        inputs = _inputs(cfg)
        rank_inputs[arch] = {**inputs, "params": tree_flatten_with_path(params)}
        port[f"serve/{arch}"] = serve_logits(cfg, params, inputs, None)
        if arch == LONG_CTX:
            port[f"serve1/{arch}"] = serve_logits(cfg, params, inputs, None, batch=1)
        if arch in TRAIN_ARCHS:
            port[f"train/{arch}"] = train_step(cfg, params, inputs, None)
        for case, (accum_arch, accum) in ACCUM.items():
            if arch == accum_arch:
                port[case] = train_step(cfg, params, inputs, None, grad_accum=accum)
    torch.save(rank_inputs, tmp / "inputs.pt")
    t0 = time.monotonic()
    join_world(run_world(__file__, WORLD, tmp), tmp, t0 + TIMEOUT_S, TIMEOUT_S)
    world = {"out": torch.load(tmp / "results.pt", weights_only=False),
             "refs": {"port": port}}
    test_k2_on_local_heads_joined_equals_the_whole_call(world)
    for case in [f"serve/{a}" for a in SERVE_ARCHS] + [f"serve1/{LONG_CTX}"]:
        test_sharded_prefill_and_decode_match(world, case, "port")
    for case in [f"train/{a}" for a in TRAIN_ARCHS] + list(ACCUM):
        test_sharded_train_step_matches(world, case, "port")
    test_uneven_micro_batches_take_the_spread_head(world)
    print(f"CARD_CHECK_OK torch {torch.__version__}: K2 on local heads, "
          f"{len(SERVE_ARCHS) + 1} served and {len(TRAIN_ARCHS) + len(ACCUM)} trained cases "
          f"on the "
          f"(2, 2) gloo world equal one process; seconds {world['out']['seconds']}")


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), Path(sys.argv[3]))
if __name__ == "__main__" and sys.argv[1:2] == ["card-check"]:
    card_check(Path(sys.argv[2]))
