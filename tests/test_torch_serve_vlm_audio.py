"""Serving parity of the port (repro_torch) with the JAX package: the vlm
family (llama-3.2-vision-11b) and the audio family (musicgen-medium),
and the decode-equals-forward check of all ten archs.

Weights are made once by the JAX package and moved with
``convert.params_from_jax``; tokens, frame embeddings and image
embeddings come from numpy seeds. JAX runs on the CPU, the port with
device="cpu", where attention (self and cross) takes K1's plain version.

The reduced vlm has 4 self-attention layers and a gated cross-attention
block after every 2nd over 16 image tokens (n_cross = 2). Its gates are
initialised to 0, and tanh(0) = 0 multiplies the cross-attention away,
so a wrong cross path would pass: here every gate is set to 1 in both
packages' params. The audio family takes frame embeddings (B, S, D) in
the prompt and one frame (B, 1, D) per decode step (its frontend is a
stub, so no generated token is fed back).

Tolerances. f32: logits and cache (k, v and the cross blocks' xk, xv)
atol = rtol = 1e-4, greedy tokens equal (vlm). bf16: the dense serving
tests' (4e-2 on logits, 1.25e-1 on the cache, absolute), with teacher
forcing in the vlm's decode. The port's plain attention at a cross shape
(S=12 queries, T=16 keys, not causal, 4 query heads over 2 KV heads)
agrees with the Pallas kernel in interpret mode on ``repeat_kv``'d k/v
at f32 1e-5, bf16 2e-2. Decode equals forward (f32, 2e-3, as
tests/test_serving.py holds the JAX package) for every arch of
``list_configs()``, the MoEs at capacity factor 16 (drop-free).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import RunConfig as JaxRunConfig, build as jax_build  # noqa: E402
from repro.models.attention import repeat_kv as jax_repeat_kv  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config, list_configs  # noqa: E402
from repro_torch.convert import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.runtime.serve import (build_decode_step, build_prefill_step,  # noqa: E402
                                       grow_cache)

VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-medium"
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL = 1e-4
BF16_LOGIT_TOL = 4e-2
BF16_CACHE_TOL = 1.25e-1
GATE = 1.0


def _models(arch, dtype, **changes):
    """(JAX model, JAX params, port model, port params) sharing weights; a
    vlm's cross-block gates set to ``GATE`` in both."""
    jc = dataclasses.replace(jax_config(arch).reduced(), **changes)
    tc = dataclasses.replace(get_config(arch).reduced(), **changes)
    jm = jax_build(jc, JaxRunConfig(param_dtype="float32", compute_dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(0))
    if "cross_blocks" in jp:
        jp["cross_blocks"]["gate"] = jnp.full_like(jp["cross_blocks"]["gate"], GATE)
    tm = build(tc, RunConfig(param_dtype=torch.float32,
                             compute_dtype=TORCH_DTYPE[dtype], device="cpu"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _embeds(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _grow_jax(cache, extra):
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return dict(cache, k=jnp.pad(cache["k"], pad), v=jnp.pad(cache["v"], pad))


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_cache(jc, tc, names, tol):
    for name in names:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), atol=tol, rtol=F32_TOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# reduced llama-3.2-vision-11b: prefill with an image, the cross cache, decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_vlm_prefill_and_greedy_decode(dtype):
    jm, jp, tm, tp = _models(VLM, dtype)
    cfg = tm.cfg
    assert (cfg.family, cfg.n_layers, cfg.cross_attn_every, cfg.n_img_tokens) == \
        ("vlm", 4, 2, 16)
    assert float(tp["cross_blocks"]["gate"].min()) == GATE
    B, S, steps = 2, 20, 6
    batch = {"tokens": _tokens(cfg, B, S, seed=1),
             "img_embeds": _embeds((B, cfg.n_img_tokens, cfg.d_model), seed=2)}
    tol = F32_TOL if dtype == "float32" else BF16_LOGIT_TOL
    cache_tol = F32_TOL if dtype == "float32" else BF16_CACHE_TOL

    jl, jc = jm.prefill(jp, _to_jax(batch))
    before = ops.attention.launches
    tl, tc = tm.prefill(tp, _to_torch(batch))
    assert ops.attention.launches == before                     # plain versions on the CPU
    assert sorted(tc) == sorted(jc) == ["k", "pos", "v", "xk", "xv"] and tc["pos"] == S
    assert tc["xk"].shape == (2, B, 16, 2, 32) and tc["k"].shape == (4, B, S, 2, 32)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=F32_TOL)
    _close_cache(jc, tc, ("k", "v", "xk", "xv"), cache_tol)

    # the JAX serving loop: grow the self-attention k/v only, then greedy decode
    jcache = _grow_jax(jc, steps)
    decode = jax.jit(jm.decode)
    cache = grow_cache(tc, steps)
    assert cache["xk"] is tc["xk"] and cache["k"].shape[2] == S + steps
    xk = cache["xk"].clone()
    tok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = tl[:, -1:].argmax(dim=-1)
    if dtype == "float32":
        assert np.array_equal(ttok.numpy(), np.asarray(tok))
    for _ in range(steps):
        jlg, jcache = decode(jp, jcache, {"tokens": tok})
        feed = torch.from_numpy(np.asarray(tok).astype(np.int64)) if dtype == "bfloat16" \
            else ttok
        lg, cache = tm.decode(tp, cache, {"tokens": feed})
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=tol, rtol=F32_TOL)
        tok = jnp.argmax(jlg, axis=-1).astype(jnp.int32)
        ttok = lg.argmax(dim=-1)
        if dtype == "float32":
            assert np.array_equal(ttok.numpy(), np.asarray(tok))
    assert cache["pos"] == S + steps and torch.equal(cache["xk"], xk)   # xk only read
    _close_cache(jcache, cache, ("k", "v"), cache_tol)


def test_vlm_cross_blocks_move_the_logits():
    """With the gates at 0 (as initialised) the image cannot change the
    logits; at 1 it does, and the port follows JAX in both."""
    for gate, moves in ((0.0, False), (GATE, True)):
        jm, jp, tm, tp = _models(VLM, "float32")
        jp["cross_blocks"]["gate"] = jnp.full_like(jp["cross_blocks"]["gate"], gate)
        tp["cross_blocks"]["gate"].fill_(gate)
        toks = _tokens(tm.cfg, 2, 8, seed=3)
        outs = []
        for seed in (4, 5):
            batch = {"tokens": toks, "img_embeds": _embeds((2, 16, 128), seed)}
            jl, _, _ = jm.apply(jp, _to_jax(batch))
            tl, _, _ = tm.apply(tp, _to_torch(batch))
            np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)
            outs.append(_np(tl))
        assert (np.abs(outs[0] - outs[1]).max() > 1e-3) == moves


def test_vlm_without_an_image_runs_its_self_attention_stack():
    """forward on a vlm config without img_embeds takes the plain stack (no
    cross block, no xk/xv), as the JAX package does."""
    jm, jp, tm, tp = _models(VLM, "float32")
    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt
    toks = _tokens(tm.cfg, 2, 10, seed=6)
    jl, _, jc = jt.forward(jp, jm.cfg, jm.rc, tokens=jnp.asarray(toks), return_cache=True)
    tl, _, tc = tt.forward(tp, tm.cfg, tm.rc, tokens=torch.from_numpy(toks),
                           return_cache=True)
    assert sorted(tc) == sorted(jc) == ["k", "pos", "v"]
    np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)


def test_vlm_decode_continues_a_jax_cache():
    """A vlm cache made by the JAX prefill (k, v grown; xk, xv as they are),
    moved with cache_from_jax, decodes to the JAX logits."""
    jm, jp, tm, tp = _models(VLM, "float32")
    batch = {"tokens": _tokens(tm.cfg, 2, 9, seed=7),
             "img_embeds": _embeds((2, 16, 128), seed=8)}
    _, jc = jm.prefill(jp, _to_jax(batch))
    jc = _grow_jax(jc, 1)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["pos"] == 9 and tc["xv"].shape == (2, 2, 16, 2, 32)
    nxt = np.full((2, 1), 5, np.int32)
    jl, _ = jm.decode(jp, jc, {"tokens": jnp.asarray(nxt)})
    tl, _ = tm.decode(tp, tc, {"tokens": torch.from_numpy(nxt)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_plain_version_matches_pallas_interpret(dtype):
    """The cross shape, S != T, not causal, GQA: the port's plain K1 on
    K-head k/v against the Pallas kernel (interpret mode) on repeat_kv'd k/v."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 12, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 16, 2, 32)).astype(np.float32) for _ in range(2))
    jd = jnp.dtype(dtype)
    expect = jax_flash(jnp.asarray(q, jd), jax_repeat_kv(jnp.asarray(k, jd), 4),
                       jax_repeat_kv(jnp.asarray(v, jd), 4), causal=False, interpret=True)
    qt, kt, vt = (torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in (q, k, v))
    out = ops.attention(qt, kt, vt, causal=False)
    assert torch.equal(out, ref.attention_ref(qt, kt, vt, causal=False))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(out), _np(expect), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# reduced musicgen-medium: frame embeddings in
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_audio_prefill_and_decode(dtype):
    jm, jp, tm, tp = _models(AUDIO, dtype)
    cfg = tm.cfg
    assert (cfg.family, cfg.frontend, cfg.n_layers) == ("audio", "audio", 4)
    B, S, steps = 2, 16, 5
    frames = _embeds((B, S + steps, cfg.d_model), seed=10)
    tol = F32_TOL if dtype == "float32" else BF16_LOGIT_TOL
    cache_tol = F32_TOL if dtype == "float32" else BF16_CACHE_TOL
    jl, jc = jm.prefill(jp, {"embeds": jnp.asarray(frames[:, :S])})
    tl, tc = tm.prefill(tp, {"embeds": torch.from_numpy(frames[:, :S])})
    assert sorted(tc) == ["k", "pos", "v"] and tc["pos"] == S
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=F32_TOL)
    _close_cache(jc, tc, ("k", "v"), cache_tol)
    jcache, cache = _grow_jax(jc, steps), grow_cache(tc, steps)
    for t in range(S, S + steps):
        jlg, jcache = jm.decode(jp, jcache, {"embeds": jnp.asarray(frames[:, t:t + 1])})
        lg, cache = tm.decode(tp, cache, {"embeds": torch.from_numpy(frames[:, t:t + 1])})
        np.testing.assert_allclose(_np(lg), _np(jlg), atol=tol, rtol=F32_TOL)
    assert cache["pos"] == S + steps
    _close_cache(jcache, cache, ("k", "v"), cache_tol)


# ---------------------------------------------------------------------------
# all ten archs: decode equals forward (tests/test_serving.py, for the port)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list_configs())
def test_incremental_decode_matches_forward(arch):
    """Each reduced arch of the port, f32, its own seeded weights: token by
    token decode from an empty cache gives the forward's logits; a vlm is
    prefilled with its image, then decodes 3 tokens against a forward over
    the longer sequence (its cross k/v come from the prefill)."""
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        # capacity drops depend on the batch; decode equals forward only drop-free
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    model = build(cfg, RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32,
                                 device="cpu"))
    params = model.init(torch.Generator().manual_seed(0))
    if "cross_blocks" in params:
        params["cross_blocks"]["gate"].fill_(GATE)
    B, S = 2, 12
    if cfg.frontend == "audio":
        embeds = torch.from_numpy(_embeds((B, S, cfg.d_model), seed=11))
        full, _, _ = model.apply(params, {"embeds": embeds})
        steps = [{"embeds": embeds[:, t:t + 1]} for t in range(S)]
        cache, start = model.init_cache(B, S), 0
    else:
        tokens = torch.from_numpy(_tokens(cfg, B, S, seed=11).astype(np.int64))
        batch = {"tokens": tokens}
        if cfg.frontend == "vision":
            batch["img_embeds"] = torch.from_numpy(
                _embeds((B, cfg.n_img_tokens, cfg.d_model), seed=12))
        full, _, _ = model.apply(params, batch)
        steps = [{"tokens": tokens[:, t:t + 1]} for t in range(S)]
        cache, start = model.init_cache(B, S), 0
        if cfg.frontend == "vision":
            start = S - 3
            _, cache = model.prefill(params, {"tokens": tokens[:, :start],
                                              "img_embeds": batch["img_embeds"]})
            cache = grow_cache(cache, 3)
    outs = []
    for step in steps[start:]:
        logits, cache = model.decode(params, cache, step)
        outs.append(logits)
    err = (torch.cat(outs, dim=1) - full[:, start:]).abs().max()
    assert float(err) < 2e-3, float(err)
    assert cache["pos"] == S


# ---------------------------------------------------------------------------
# full-size shapes on the meta device, specs, and the count
# ---------------------------------------------------------------------------
def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_meta_tree_matches_jax(arch):
    cfg = get_config(arch)
    meta = dict(_leaves(build(cfg, RunConfig(device="cpu")).init_eval_shape()))
    ref_ = dict(_leaves(jax_build(jax_config(arch), JaxRunConfig()).init_eval_shape()))
    assert sorted(meta) == sorted(ref_)
    for name, t in meta.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref_[name].shape), name
        assert str(t.dtype).removeprefix("torch.") == str(ref_[name].dtype), name
    n = sum(t.numel() for t in meta.values())
    if arch == VLM:
        # a cross block holds ln (d) and a scalar gate where the count takes
        # 2 * d; the count leaves out the final norm (d)
        assert meta["cross_blocks/attn/wk"].shape == (8, 4096, 1024)
        assert "cross_blocks/attn/bq" not in meta and meta["cross_blocks/gate"].shape == (8,)
        assert n == cfg.param_count() - 8 * (cfg.d_model - 1) + cfg.d_model
        assert (n, cfg.param_count()) == (10_110_734_344, 10_110_763_008)
    else:
        assert n == cfg.param_count() + cfg.d_model


def test_serve_meta_specs_for_the_frontends():
    rc = RunConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device="cpu")
    cfg = get_config(AUDIO)
    _, _, batch_meta, _, _ = build_prefill_step(cfg, None, B=8, S=512, rc=rc)
    assert sorted(batch_meta) == ["embeds"]
    assert batch_meta["embeds"].shape == (8, 512, 1536)
    assert batch_meta["embeds"].dtype == torch.bfloat16
    _, _, cache_meta, dbatch, _, _ = build_decode_step(
        cfg, ShapeConfig("d", "decode", 576, 8), None, rc=rc)
    assert dbatch["embeds"].shape == (8, 1, 1536) and cache_meta["k"].shape == \
        (48, 8, 576, 24, 64)
    cfg = get_config(VLM)
    _, _, batch_meta, _, _ = build_prefill_step(cfg, None, B=8, S=512, rc=rc)
    assert sorted(batch_meta) == ["img_embeds", "tokens"]
    assert batch_meta["img_embeds"].shape == (8, 1601, 4096)
    _, _, cache_meta, dbatch, _, _ = build_decode_step(
        cfg, ShapeConfig("d", "decode", 576, 8), None, rc=rc)
    assert dbatch["tokens"].shape == (8, 1)
    assert cache_meta["k"].shape == (40, 8, 576, 8, 128)
    assert cache_meta["xk"].shape == cache_meta["xv"].shape == (8, 8, 1601, 8, 128)
    assert all(t.device.type == "meta" for t in cache_meta.values() if torch.is_tensor(t))
