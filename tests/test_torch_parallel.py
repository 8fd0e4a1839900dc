"""The port's sharding rules (repro_torch.parallel, runtime.elastic's mesh
shapes, runtime.specs.input_specs) against the JAX package's, in one
process, and the plain K1's query offset against the JAX oracle.

The spec functions read only a mesh's axis sizes, so both packages get a
duck mesh (``SimpleNamespace(shape={name: size})``): (data=4, model=2),
(2, 4), the production (16, 16) and (pod=2, 16, 16). Every leaf of all
ten archs' full-width param trees (JAX ``init_eval_shape``, the port's
meta trees) and of their decode caches at the decode shapes must get the
same PartitionSpec, under the train policy (FSDP) and the serve policy
without it. ``input_specs`` must give the same shapes and dtypes for
every arch and shape. ``attention_ref(q_offset=)`` is held against
``full_attention(q_offset=)`` at 1e-5, and its ``attention_bwd`` against
autograd at 1e-5.
"""
import functools
import types

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import SHAPES as JSHAPES, get_config as jax_config  # noqa: E402
from repro.models import RunConfig as JaxRunConfig, build as jax_build  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.parallel import mesh as jmesh, sharding as jsh  # noqa: E402
from repro.runtime import elastic as jelastic, specs as jspecs  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.parallel import mesh as tmesh, sharding as tsh  # noqa: E402
from repro_torch.parallel.mesh import P  # noqa: E402
from repro_torch.runtime import elastic as telastic, specs as tspecs  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

MESHES = [{"data": 4, "model": 2}, {"data": 2, "model": 4}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]
POLICIES = [dict(fsdp=True), dict(fsdp=False)]
DECODE_SHAPES = [s for s in SHAPES.values() if s.kind == "decode"]


def _mesh(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _jax_flat(tree):
    """{path key: leaf} with the port's keys (the checkpointer's convention)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in leaves}


def _same_specs(jax_tree, port_tree):
    j = {k: tuple(v) for k, v in _jax_flat(jax_tree).items()}
    t = {k: tuple(v) for k, v in tree_flatten_with_path(
        port_tree, is_leaf=lambda x: isinstance(x, P)).items()}
    assert j.keys() == t.keys()
    bad = {k: (j[k], t[k]) for k in j if j[k] != t[k]}
    assert not bad, bad
    return len(j)


@functools.cache
def _models(arch):
    jm = jax_build(jax_config(arch), JaxRunConfig())
    tm = build(get_config(arch), RunConfig(device="cpu"))
    return jm, tm


@functools.cache
def _params(arch):
    jm, tm = _models(arch)
    return jm.init_eval_shape(), tm.init_eval_shape()


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------
RESOLVE_CASES = [
    (("dp", None, "tp"), (8, 32, 448)),
    (("dp", "tp", None, None), (8, 32, 14, 64)),    # "seq": rows on tp
    (("dp", None, "tp", None), (8, 32, 14, 64)),    # 14 heads: tp kept only where it divides
    (("dp", None, None), (1, 4096, 896)),           # batch 1: dp dropped
    (("dp", None, None), (2, 8, 8)),                # dp prefix ("pod",) of ("pod", "data")
    (("fsdp", "tp"), (896, 4864)),
    (("tp", "fsdp"), (151936, 896)),
    (("sp", "dp"), (64, 64)),                       # sp then dp: 'data' used once
    ((None, "tp", "tp"), (4, 32, 32)),              # an axis used once only
]


@pytest.mark.parametrize("shape", MESHES, ids=lambda m: "x".join(map(str, m.values())))
def test_resolve_spec_and_pick_attn_shard_match_jax(shape):
    mesh = _mesh(shape)
    for axes, dims in RESOLVE_CASES:
        got = tmesh.resolve_spec(mesh, axes, dims)
        assert isinstance(got, P)
        assert tuple(got) == tuple(jmesh.resolve_spec(mesh, axes, dims)), (axes, dims)
        assert tmesh.axis_size(mesh, ("pod", "data")) == jmesh.axis_size(mesh, ("pod", "data"))
    for arch in list_configs():
        assert tmesh.pick_attn_shard(get_config(arch), mesh) == \
            jmesh.pick_attn_shard(jax_config(arch), mesh), arch
    assert tmesh.pick_attn_shard(get_config("qwen2-0.5b"), None) == "heads"


def test_best_mesh_shape_matches_jax():
    for n in range(1, 17):
        for prefer in (0, 1, 2, 4, 8, 16):
            assert telastic.best_mesh_shape(n, prefer) == jelastic.best_mesh_shape(n, prefer)


def test_to_placements_follows_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh({"pod": 2, "data": 2, "model": 2})
    assert tmesh.to_placements(mesh, P(("pod", "data"), None, "model"), 3) == (
        Shard(0), Shard(0), Shard(2))
    assert tmesh.to_placements(mesh, P(None, ("pod", "model")), 2) == (
        Shard(1), Replicate(), Shard(1))
    assert tmesh.to_placements(mesh, P(), 2) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        tmesh.to_placements(mesh, P(("model", "pod")), 1)
    with pytest.raises(ValueError, match="twice"):
        tmesh.to_placements(mesh, P("data", "data"), 2)


# ---------------------------------------------------------------------------
# param, cache and batch specs of all ten archs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list_configs())
def test_param_specs_match_jax_on_every_leaf(arch):
    jp, tp = _params(arch)
    for shape in MESHES:
        for pol in POLICIES:
            n = _same_specs(jsh.param_specs(jp, _mesh(shape), jsh.ShardingPolicy(**pol)),
                            tsh.param_specs(tp, _mesh(shape), tsh.ShardingPolicy(**pol)))
            assert n == len(tree_flatten_with_path(tp))


@pytest.mark.parametrize("arch", list_configs())
def test_cache_and_batch_specs_match_jax_on_every_leaf(arch):
    jm, tm = _models(arch)
    jcfg, tcfg = jax_config(arch), get_config(arch)
    for shape in MESHES:
        mesh = _mesh(shape)
        for s in DECODE_SHAPES:
            B, T = s.global_batch, s.seq_len
            jc, tc = jm.init_cache_eval_shape(B, T), tm.init_cache_eval_shape(B, T)
            _same_specs(jsh.cache_specs(jc, mesh, jcfg, JSHAPES[s.name], jsh.ShardingPolicy()),
                        tsh.cache_specs(tc, mesh, tcfg, s, tsh.ShardingPolicy()))
        for s in SHAPES.values():
            jb = jspecs.input_specs(jcfg, JSHAPES[s.name], jm)["batch"]
            tb = tspecs.input_specs(tcfg, s, tm)["batch"]
            _same_specs(jsh.batch_specs(jb, mesh, jsh.ShardingPolicy()),
                        tsh.batch_specs(tb, mesh, tsh.ShardingPolicy()))


@pytest.mark.parametrize("arch", list_configs())
def test_input_specs_match_jax(arch):
    jm, tm = _models(arch)
    for name, s in SHAPES.items():
        j = _jax_flat(jspecs.input_specs(jax_config(arch), JSHAPES[name], jm))
        t = tree_flatten_with_path(tspecs.input_specs(get_config(arch), s, tm))
        assert j.keys() == t.keys(), name
        for k, leaf in t.items():
            if k.endswith("pos"):
                assert leaf == 0 and tuple(j[k].shape) == (), k
                continue
            assert leaf.device.type == "meta", k
            assert tuple(leaf.shape) == tuple(j[k].shape), (name, k)
            assert str(leaf.dtype).removeprefix("torch.") == str(j[k].dtype), (name, k)
    with pytest.raises(ValueError, match="model"):
        tspecs.input_specs(get_config(arch), SHAPES["decode_32k"])


# ---------------------------------------------------------------------------
# K1's plain version at a query offset
# ---------------------------------------------------------------------------
OFFSET_CASES = [
    # (B, S, T, H, K, hd, q_offset)
    (2, 8, 32, 4, 2, 16, 0),
    (2, 8, 32, 4, 2, 16, 8),
    (2, 8, 32, 4, 2, 16, 24),
    (1, 5, 20, 14, 2, 32, 15),     # qwen2-0.5b's G = 7, a ragged block at the end
]


def _qkv(rng, B, S, T, H, K, hd):
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]


@pytest.mark.parametrize("B,S,T,H,K,hd,q_offset", OFFSET_CASES)
def test_attention_ref_q_offset_matches_jax_full_attention(B, S, T, H, K, hd, q_offset):
    rng = np.random.default_rng(S + T + q_offset)
    q, k, v = _qkv(rng, B, S, T, H, K, hd)
    for causal in (True, False):
        got = tref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                 q_offset=q_offset)
        expect = jattn.full_attention(jnp.asarray(q), jattn.repeat_kv(jnp.asarray(k), H),
                                      jattn.repeat_kv(jnp.asarray(v), H), causal=causal,
                                      q_offset=q_offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0, atol=1e-5)


@pytest.mark.parametrize("tp", [2, 4])
def test_row_blocks_at_their_offsets_make_the_unsharded_attention(tp):
    """What each rank computes under "seq": its rows at q_offset r * S/tp."""
    rng = np.random.default_rng(tp)
    q, k, v = map(torch.from_numpy, _qkv(rng, 2, 16, 16, 14, 2, 32))
    whole = tref.attention_ref(q, k, v, causal=True)
    n = 16 // tp
    blocks = [tref.attention_ref(q[:, r * n:(r + 1) * n], k, v, causal=True, q_offset=r * n)
              for r in range(tp)]
    torch.testing.assert_close(torch.cat(blocks, dim=1), whole, rtol=0, atol=1e-6)


@pytest.mark.parametrize("B,S,T,H,K,hd,q_offset", OFFSET_CASES)
def test_attention_bwd_q_offset_matches_autograd(B, S, T, H, K, hd, q_offset):
    rng = np.random.default_rng(S + T + q_offset + 1)
    q, k, v = map(torch.from_numpy, _qkv(rng, B, S, T, H, K, hd))
    dout = torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(np.float32))
    inputs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tref.attention_ref(*inputs, causal=True, q_offset=q_offset)
    expect = torch.autograd.grad(out, inputs, dout)
    got = tref.attention_bwd(q, k, v, out.detach(), dout, causal=True, q_offset=q_offset)
    for g, e in zip(got, expect):
        torch.testing.assert_close(g, e, rtol=0, atol=1e-5)


def test_q_offset_past_the_keys_is_refused():
    q = torch.zeros((1, 8, 2, 16))
    kv = torch.zeros((1, 16, 2, 16))
    with pytest.raises(ValueError, match="q_offset"):
        tref.attention_ref(q, kv, kv, causal=True, q_offset=9)
    with pytest.raises(ValueError, match="q_offset"):
        tref.attention_bwd(q, kv, kv, q, q, causal=True, q_offset=9)
    with pytest.raises(ValueError, match="q_offset"):
        tref.attention_ref(q, kv, kv, causal=True, q_offset=-1)
    # not causal, the offset has no effect; at 0, any S and T as before
    torch.testing.assert_close(tref.attention_ref(q, kv, kv, causal=False, q_offset=9),
                               tref.attention_ref(q, kv, kv, causal=False))
    tref.attention_ref(kv, q, q, causal=True)
