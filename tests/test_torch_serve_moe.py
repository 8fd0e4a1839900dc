"""Serving parity of the port (repro_torch) with the JAX package: the MoE
family (qwen2-moe-a2.7b: 60 routed experts top-4 padded to 64, 4 shared;
llama4-scout-17b-a16e: 16 experts top-1, 1 shared).

Weights are made once by the JAX package and moved with
``convert.params_from_jax``; prompts come from numpy seeds. JAX runs on
the CPU, the port with device="cpu", where attention takes K1's plain
version. The reduced configs have 4 layers, d 128, 8 experts padded to
16, top-2 (qwen2-moe) or top-1 (llama4-scout).

The serving path keeps the reference's capacity factor (1.25): routing
is a function of the whole batch, so prefill and decode are compared
with JAX's own prefill and decode, not with a forward.

Tolerances. f32: logits and cache atol = rtol = 1e-4, greedy tokens
equal, and every top-k choice the same. bf16: the tolerances of the
dense serving tests (4e-2 on logits, 1.25e-1 on the cache, absolute),
with teacher forcing in decode (near-tied greedy tokens). In bf16 the
router's inputs differ between the two packages by the attention's
rounding (the reference rounds the scores to bf16, the port does not),
and its logits are rounded to bf16, so near-tied top-k choices flip:
with this test's prompts over seeds 0-4, 0-6 of the 48 prompt tokens
of a layer were routed differently. A flipped token's hidden state
then differs from the next layer on, by up to 1.45 in its cached k/v.
So in bf16 the routing of both packages is recorded (a
``jax.debug.callback`` in the reference's, ``moe.route`` wrapped in the
port's): the logits are held on the rows whose current token was routed
alike in every layer, the cache on the (layer, token) entries whose
token was routed alike in every earlier layer, and the differing
choices are counted and bounded (at most 1 in 8 token-layers).
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import RunConfig as JaxRunConfig, build as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.convert import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.runtime.serve import build_decode_step, build_prefill_step  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"]
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL = 1e-4
BF16_LOGIT_TOL = 4e-2
BF16_CACHE_TOL = 1.25e-1


def _models(arch, dtype, **changes):
    """(JAX model, JAX params, port model, port params) sharing weights."""
    jc = dataclasses.replace(jax_config(arch).reduced(), **changes)
    tc = dataclasses.replace(get_config(arch).reduced(), **changes)
    jm = jax_build(jc, JaxRunConfig(param_dtype="float32", compute_dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build(tc, RunConfig(param_dtype=torch.float32,
                             compute_dtype=TORCH_DTYPE[dtype], device="cpu"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _grow_jax(cache, extra):
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return dict(cache, k=jnp.pad(cache["k"], pad), v=jnp.pad(cache["v"], pad))


def _grow(cache, extra):
    pad = (0, 0, 0, 0, 0, extra)
    return dict(cache, k=torch.nn.functional.pad(cache["k"], pad),
                v=torch.nn.functional.pad(cache["v"], pad))


@contextlib.contextmanager
def _routing_logs():
    """Record each MoE layer's kept choices, (tokens, Ep) bool, in call order:
    yields (JAX's list, the port's list)."""
    jlog, tlog = [], []
    jroute, troute = jmoe.route, tmoe.route

    def jrecord(logits, cfg, group):
        d, c, aux = jroute(logits, cfg, group)
        kept = (d.astype(jnp.float32).sum(-1) > 0).reshape(-1, d.shape[2])
        jax.debug.callback(lambda k: jlog.append(np.asarray(k)), kept, ordered=True)
        return d, c, aux

    def trecord(logits, cfg, group):
        d, c, aux = troute(logits, cfg, group)
        tlog.append((d.float().sum(-1) > 0).reshape(-1, d.shape[2]).numpy())
        return d, c, aux
    jmoe.route, tmoe.route = jrecord, trecord
    try:
        yield jlog, tlog
    finally:
        jmoe.route, tmoe.route = jroute, troute


def _routed_alike(jlog, tlog, B, S):
    """(B, S, L) bool: the token was routed alike in each layer."""
    assert len(jlog) == len(tlog)
    return np.stack([(a == b).all(-1).reshape(B, S) for a, b in zip(jlog, tlog)], -1)


def _jax_greedy(jm, jp, prompts, steps):
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    cache = _grow_jax(cache, steps)
    decode = jax.jit(jm.decode)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    toks, step_logits = [tok], []
    for _ in range(steps):
        lg, cache = decode(jp, cache, {"tokens": tok})
        step_logits.append(lg)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        toks.append(tok)
    return np.concatenate([np.asarray(t) for t in toks], axis=1), step_logits


# ---------------------------------------------------------------------------
# reduced MoE models: prefill logits + cache, greedy decode, f32 and bf16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_prefill_and_greedy_decode(arch, dtype):
    jm, jp, tm, tp = _models(arch, dtype)
    cfg = tm.cfg
    assert (cfg.family, cfg.n_layers, cfg.n_experts_padded) == ("moe", 4, 16)
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32
    prompts = _tokens(cfg, 2, 24, seed=1)
    steps = 8
    tol = F32_TOL if dtype == "float32" else BF16_LOGIT_TOL
    cache_tol = F32_TOL if dtype == "float32" else BF16_CACHE_TOL

    with _routing_logs() as (jlog, tlog):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
        before = ops.attention.launches
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)})
        alike = _routed_alike(jlog, tlog, 2, 24)                # (B, S, L)
    assert ops.attention.launches == before                     # plain versions on the CPU
    assert tl.shape == (2, 1, cfg.vocab_padded) and tl.dtype == TORCH_DTYPE[dtype]
    assert sorted(tc) == sorted(jc) == ["k", "pos", "v"] and tc["pos"] == 24
    if dtype == "float32":
        assert alike.all()
    flips = int((~alike).sum())
    rows = alike[:, -1].all(-1)                                 # the last token routed alike
    np.testing.assert_allclose(_np(tl)[rows], _np(jl)[rows], atol=tol, rtol=F32_TOL)
    # a (layer, token) entry of the cache: the token routed alike in every earlier layer
    before_layer = np.concatenate([np.ones((2, 24, 1), bool),
                                   np.cumprod(alike, -1)[..., :-1].astype(bool)], -1)
    entries = before_layer.transpose(2, 0, 1)                   # (L, B, S)
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape == (4, 2, 24, 2, 32)
        np.testing.assert_allclose(_np(tc[name])[entries], _np(jc[name])[entries],
                                   atol=cache_tol, rtol=F32_TOL)

    with _routing_logs() as (jlog, _):
        jtoks, jlogits = _jax_greedy(jm, jp, prompts, steps)
    L = cfg.n_layers
    assert len(jlog) == L * (1 + steps)                         # the prefill, then each step
    cache = _grow(tc, steps)
    k = cache["k"]
    tok = tl[:, -1:].argmax(dim=-1)
    ttoks = [tok]
    for t in range(steps):
        if dtype == "bfloat16":       # teacher forcing: see the module docstring
            tok = torch.from_numpy(jtoks[:, t:t + 1].astype(np.int64))
        with _routing_logs() as (_, tlog):
            lg, cache = tm.decode(tp, cache, {"tokens": tok})
        step_alike = _routed_alike(jlog[L * (1 + t):L * (2 + t)], tlog, 2, 1)[:, 0]  # (B, L)
        if dtype == "float32":
            assert step_alike.all()
        flips += int((~step_alike).sum())
        rows = step_alike.all(-1)
        np.testing.assert_allclose(_np(lg)[rows], _np(jlogits[t])[rows], atol=tol,
                                   rtol=F32_TOL)
        tok = lg.argmax(dim=-1)
        ttoks.append(tok)
    assert cache["pos"] == 24 + steps and cache["k"] is k        # written in place
    assert flips <= (2 * 24 + 2 * steps) * cfg.n_layers // 8, flips
    if dtype == "float32":
        np.testing.assert_array_equal(torch.cat(ttoks, dim=1).numpy(), jtoks)


def test_decode_continues_a_jax_cache():
    """A MoE cache made by the JAX prefill, moved with cache_from_jax,
    decodes to the JAX logits."""
    jm, jp, tm, tp = _models("qwen2-moe-a2.7b", "float32")
    prompts = _tokens(tm.cfg, 2, 10, seed=3)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    jc = _grow_jax(jc, 1)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["pos"] == 10 and tc["k"].shape == (4, 2, 11, 2, 32)
    nxt = np.full((2, 1), 7, np.int32)
    jl, _ = jm.decode(jp, jc, {"tokens": jnp.asarray(nxt)})
    tl, _ = tm.decode(tp, tc, {"tokens": torch.from_numpy(nxt)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)


def test_full_width_qwen2_moe_one_layer_f32():
    """qwen2-moe-a2.7b at its published width (d 2048, 16 heads of 128, 60
    routed experts of 1408 padded to 64, top-4, shared 5632), cut to 1
    layer and a 512-token vocab: the forward against JAX's."""
    jm, jp, tm, tp = _models("qwen2-moe-a2.7b", "float32", d_model=2048, n_heads=16,
                             n_kv_heads=16, head_dim=128, n_experts=60, top_k=4,
                             expert_d_ff=1408, shared_expert_d_ff=5632, n_layers=1)
    assert tp["blocks"]["moe"]["w1"].shape == (1, 64, 2048, 1408)
    prompts = _tokens(tm.cfg, 2, 16, seed=2)
    jl, jaux, _ = jm.apply(jp, {"tokens": jnp.asarray(prompts)})
    tl, taux, _ = tm.apply(tp, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)
    assert abs(float(taux) - float(jaux)) <= F32_TOL * float(jaux)


# ---------------------------------------------------------------------------
# full-size shapes on the meta device, and the count
# ---------------------------------------------------------------------------
def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_tree_matches_jax(arch):
    cfg = get_config(arch)
    meta = dict(_leaves(build(cfg, RunConfig(device="cpu")).init_eval_shape()))
    ref = dict(_leaves(jax_build(jax_config(arch), JaxRunConfig()).init_eval_shape()))
    assert sorted(meta) == sorted(ref)
    for name, t in meta.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[name].shape), name
        assert str(t.dtype).removeprefix("torch.") == str(ref[name].dtype), name


def test_qwen2_moe_tree_holds_the_pad_experts_the_count_leaves_out():
    """The analytic count takes n_experts = 60 routed experts (and a 60-wide
    router); the tree holds n_experts_padded = 64 of each, and the final
    norm: 830,670,848 values more, 30.30 GB of bf16 params against the
    count's 28.63 GB (ROADMAP §3)."""
    cfg = get_config("qwen2-moe-a2.7b")
    meta = dict(_leaves(build(cfg, RunConfig(device="cpu")).init_eval_shape()))
    n = sum(t.numel() for t in meta.values())
    pad = cfg.n_experts_padded - cfg.n_experts
    d, f = cfg.d_model, cfg.expert_d_ff
    assert meta["blocks/moe/w1"].shape == (24, 64, 2048, 1408)
    assert meta["blocks/moe/router"].shape == (24, 2048, 64)
    assert cfg.param_count() == 14_316_257_280 and n == 15_146_928_128
    assert n - cfg.param_count() == 830_670_848 == \
        cfg.n_layers * pad * (3 * d * f + d) + d
    bf16_bytes = sum(t.numel() * (4 if "router" in k or k.endswith(("ln1", "ln2", "norm"))
                                  else 2) for k, t in meta.items())
    assert round(bf16_bytes / 1e9, 2) == 30.30


def test_serve_meta_specs_for_the_moe():
    cfg = get_config("qwen2-moe-a2.7b")
    rc = RunConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device="cpu")
    _, params_meta, batch_meta, _, _ = build_prefill_step(cfg, None, B=8, S=512, rc=rc)
    assert batch_meta["tokens"].shape == (8, 512)
    moe = params_meta["blocks"]["moe"]
    assert moe["w2"].shape == (24, 64, 1408, 2048) and moe["w2"].dtype == torch.bfloat16
    assert moe["router"].dtype == torch.float32
    assert moe["shared"]["w1"].shape == (24, 2048, 5632)
    _, _, cache_meta, dbatch, _, _ = build_decode_step(
        cfg, ShapeConfig("d", "decode", 576, 8), None, rc=rc)
    assert cache_meta["k"].shape == (24, 8, 576, 16, 128) and dbatch["tokens"].shape == (8, 1)
