"""Serving parity of the port (repro_torch) with the JAX package: the hybrid
family (zamba2-1.2b) and gemma-7b at its head_dim of 256.

Weights are made once by the JAX package and moved with
``convert.params_from_jax``; prompts come from numpy seeds. JAX runs on
the CPU, the port with device="cpu", where the SSD scan takes K2's plain
version (``models.ssm.ssd_chunked``) and attention K1's
(``ref.attention_ref``).

A hybrid runs its Mamba2 stack in segments of ``attn_every`` layers and
applies one shared attention + MLP block after every full segment; its
cache holds the stacked SSM state of every Mamba2 layer and the k/v of
every application of the shared block.

Tolerances. f32: logits and cache atol = rtol = 1e-4, greedy tokens
equal. bf16: 4 Mamba2 layers and 2 applications of the shared block in
bf16 activations, rounded at other places by XLA and by PyTorch. With
this test's inputs over prompt seeds 0-4 the largest differences were
2.5e-2 in the prefill and in the decode logits (|logit| < 0.90), 1.6e-3
in the f32 SSD state (|s| < 0.13), 8.2e-2 in the bf16 conv tails
(|x| < 3.5) and 7.8e-2 in the shared block's k/v (|k| < 4.4, about 4
bf16 ulps). So the bf16 tolerances are 4e-2 on logits, 1e-2 on the SSD
state and 1.25e-1 on the conv tails and k/v, absolute: the ones the
dense and ssm serving tests use. Those runs chose 3 of 90 greedy tokens
differently (near-ties), so in bf16 the port's decode is fed the
reference's greedy tokens (teacher forcing); the tokens themselves are
held equal in f32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import RunConfig as JaxRunConfig, build as jax_build  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.convert import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.models.ssm import SSMState  # noqa: E402
from repro_torch.models.transformer import _segments  # noqa: E402
from repro_torch.runtime.serve import build_decode_step, build_prefill_step  # noqa: E402

ARCH = "zamba2-1.2b"
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL = 1e-4
BF16_LOGIT_TOL = 4e-2
BF16_CACHE_TOL = {"ssd": 1e-2, "conv_x": 1.25e-1, "conv_B": 1.25e-1, "conv_C": 1.25e-1,
                  "k": 1.25e-1, "v": 1.25e-1}


def _configs(arch, **changes):
    """(JAX config, port config): the reduced config unless ``full``."""
    full = changes.pop("full", False)
    jc, tc = jax_config(arch), get_config(arch)
    if not full:
        jc, tc = jc.reduced(), tc.reduced()
    return dataclasses.replace(jc, **changes), dataclasses.replace(tc, **changes)


def _models(dtype, arch=ARCH, **changes):
    """(JAX model, JAX params, port model, port params) sharing weights."""
    jc, tc = _configs(arch, **changes)
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


def _close_cache(jc, tc, dtype):
    """The hybrid cache: the SSM state of every layer and the shared block's k/v."""
    assert sorted(tc) == sorted(jc) == ["k", "pos", "ssm", "v"]
    assert isinstance(tc["ssm"], SSMState)
    pairs = [(f, getattr(jc["ssm"], f), getattr(tc["ssm"], f)) for f in SSMState._fields]
    pairs += [(f, jc[f], tc[f]) for f in ("k", "v")]
    for f, j, t in pairs:
        tol = F32_TOL if dtype == "float32" else BF16_CACHE_TOL[f]
        assert tuple(t.shape) == tuple(j.shape), f
        np.testing.assert_allclose(_np(t), _np(j), atol=tol, rtol=F32_TOL, err_msg=f)


def _grow(cache, extra, lib):
    """Room for ``extra`` more tokens along the k/v's T axis (the SSM state
    does not grow)."""
    if lib is jnp:
        pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
        return dict(cache, k=jnp.pad(cache["k"], pad), v=jnp.pad(cache["v"], pad))
    pad = (0, 0, 0, 0, 0, extra)
    return dict(cache, k=torch.nn.functional.pad(cache["k"], pad),
                v=torch.nn.functional.pad(cache["v"], pad))


def _jax_greedy(jm, jp, prompts, steps):
    """The JAX serving loop of examples/serve_batch.py: prefill, grow the
    k/v, then greedy decode."""
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    cache = _grow(cache, steps, jnp)
    decode = jax.jit(jm.decode)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    toks, step_logits = [tok], []
    for _ in range(steps):
        lg, cache = decode(jp, cache, {"tokens": tok})
        step_logits.append(lg)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        toks.append(tok)
    return np.concatenate([np.asarray(t) for t in toks], axis=1), step_logits, cache


def _serve_against_jax(jm, jp, tm, tp, prompts, steps, dtype):
    """Prefill (logits and cache) and greedy decode of the port against JAX."""
    tol = F32_TOL if dtype == "float32" else BF16_LOGIT_TOL
    S = prompts.shape[1]
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    before = (ops.attention.launches, ops.ssd.launches)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)})
    assert (ops.attention.launches, ops.ssd.launches) == before   # plain versions on the CPU
    assert tl.shape == (2, 1, tm.cfg.vocab_padded) and tl.dtype == TORCH_DTYPE[dtype]
    assert tc["pos"] == int(jc["pos"]) == S
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=F32_TOL)
    _close_cache(jc, tc, dtype)

    jtoks, jlogits, jcache = _jax_greedy(jm, jp, prompts, steps)
    cache = _grow(tc, steps, torch)
    ssd, k = cache["ssm"].ssd, cache["k"]
    tok = tl[:, -1:].argmax(dim=-1)
    ttoks = [tok]
    for t in range(steps):
        if dtype == "bfloat16":       # teacher forcing: see the module docstring
            tok = torch.from_numpy(jtoks[:, t:t + 1].astype(np.int64))
        lg, cache = tm.decode(tp, cache, {"tokens": tok})
        np.testing.assert_allclose(_np(lg), _np(jlogits[t]), atol=tol, rtol=F32_TOL)
        tok = lg.argmax(dim=-1)
        ttoks.append(tok)
    assert cache["pos"] == S + steps
    assert cache["ssm"].ssd is ssd and cache["k"] is k      # written in place
    if dtype == "float32":
        np.testing.assert_array_equal(torch.cat(ttoks, dim=1).numpy(), jtoks)
        _close_cache(jcache, cache, dtype)


# ---------------------------------------------------------------------------
# reduced zamba2-1.2b: prefill logits + cache, greedy decode, f32 and bf16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_prefill_and_greedy_decode(dtype):
    jm, jp, tm, tp = _models(dtype)
    cfg = tm.cfg
    assert (cfg.family, cfg.n_layers, cfg.attn_every) == ("hybrid", 4, 2)
    prompts = _tokens(cfg, 2, 24, seed=1)              # S=24 -> chunk 12
    _serve_against_jax(jm, jp, tm, tp, prompts, 8, dtype)


def test_tail_segment_without_the_shared_block_f32():
    """n_layers=5, attn_every=2: segments (0,2), (2,4) with the shared
    block after each, then a 1-layer tail (4,5) without it."""
    jm, jp, tm, tp = _models("float32", n_layers=5)
    assert _segments(5, 2) == [(0, 2, True), (2, 4, True), (4, 5, False)]
    prompts = _tokens(tm.cfg, 2, 16, seed=2)
    _serve_against_jax(jm, jp, tm, tp, prompts, 4, "float32")
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)})
    assert tc["ssm"].ssd.shape[0] == 5 and tc["k"].shape[0] == 2


def test_full_width_seven_layers_f32():
    """zamba2-1.2b at its published width (d_model 2048, d_inner 4096, 64
    SSD heads of P=64, N=64; 32 attention heads of 64, d_ff 8192), cut to
    7 layers and a 512-token vocab: one application of the shared block
    after layer 6, then a 1-layer tail."""
    jm, jp, tm, tp = _models("float32", full=True, n_layers=7, vocab_size=512)
    cfg = tm.cfg
    assert (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.attn_every) == \
        (2048, 4096, 64, 64, 64, 32, 32, 64, 8192, 6)
    assert _segments(7, 6) == [(0, 6, True), (6, 7, False)]
    prompts = _tokens(cfg, 2, 16, seed=3)
    jl, _, _ = jm.apply(jp, {"tokens": jnp.asarray(prompts)})
    tl, _, _ = tm.apply(tp, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)
    jtoks, jlogits, _ = _jax_greedy(jm, jp, prompts, 3)
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)})
    assert cache["k"].shape == (1, 2, 16, 32, 64)
    cache = _grow(cache, 3, torch)
    tok = tl[:, -1:].argmax(dim=-1)
    for t in range(3):
        lg, cache = tm.decode(tp, cache, {"tokens": tok})
        np.testing.assert_allclose(_np(lg), _np(jlogits[t]), atol=F32_TOL, rtol=F32_TOL)
        tok = lg.argmax(dim=-1)
        assert np.array_equal(tok.numpy(), jtoks[:, t + 1:t + 2])


def test_decode_continues_a_jax_cache():
    """A hybrid cache made by the JAX prefill (SSM state and the shared
    block's k/v), moved with cache_from_jax, decodes to the JAX logits."""
    jm, jp, tm, tp = _models("float32")
    prompts = _tokens(tm.cfg, 2, 10, seed=4)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    jc = _grow(jc, 1, jnp)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["pos"] == 10 and isinstance(tc["ssm"], SSMState)
    assert tc["k"].shape == (2, 2, 11, 2, 32) and tc["k"].dtype == torch.float32
    nxt = np.full((2, 1), 7, np.int32)
    jl, jc2 = jm.decode(jp, jc, {"tokens": jnp.asarray(nxt)})
    tl, tc2 = tm.decode(tp, tc, {"tokens": torch.from_numpy(nxt)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)
    _close_cache(jc2, tc2, "float32")


def test_gemma_head_dim_256_f32():
    """Reduced gemma-7b at its own head_dim of 256 (GeGLU, scaled and tied
    embeddings, 2 KV heads): prefill logits and k/v, and greedy decode
    against JAX."""
    jm, jp, tm, tp = _models("float32", arch="gemma-7b", head_dim=256)
    cfg = tm.cfg
    assert (cfg.resolved_head_dim, cfg.gelu_mlp, cfg.scale_embeddings,
            cfg.tie_embeddings) == (256, True, True, True)
    assert "head" not in tp and tp["blocks"]["attn"]["wq"].shape == (4, 128, 4 * 256)
    prompts = _tokens(cfg, 2, 20, seed=5)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)
    for name in ("k", "v"):
        assert tc[name].shape == (4, 2, 20, 2, 256)
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), atol=F32_TOL, rtol=F32_TOL)
    jtoks, jlogits, _ = _jax_greedy(jm, jp, prompts, 4)
    cache = _grow(tc, 4, torch)
    tok = tl[:, -1:].argmax(dim=-1)
    for t in range(4):
        lg, cache = tm.decode(tp, cache, {"tokens": tok})
        np.testing.assert_allclose(_np(lg), _np(jlogits[t]), atol=F32_TOL, rtol=F32_TOL)
        tok = lg.argmax(dim=-1)
        assert np.array_equal(tok.numpy(), jtoks[:, t + 1:t + 2])


# ---------------------------------------------------------------------------
# cache correctness of the port itself (tests/test_serving.py's zamba2 cases)
# ---------------------------------------------------------------------------
def _port_model(**changes):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **changes)
    model = build(cfg, RunConfig(param_dtype=torch.float32,
                                 compute_dtype=torch.float32, device="cpu"))
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("n_layers", [4, 5])
def test_incremental_decode_matches_forward(n_layers):
    model, params = _port_model(n_layers=n_layers)
    B, S = 2, 12
    tokens = torch.from_numpy(_tokens(model.cfg, B, S, seed=6).astype(np.int64))
    full, _, _ = model.apply(params, {"tokens": tokens})
    cache = model.init_cache(B, S)
    outs = []
    for t in range(S):
        logits, cache = model.decode(params, cache, {"tokens": tokens[:, t:t + 1]})
        outs.append(logits)
    err = (torch.cat(outs, dim=1) - full).abs().max()
    assert float(err) < 2e-3, float(err)
    assert cache["pos"] == S


def test_prefill_then_decode_continuation():
    """prefill(tokens[:k]) + decode(tokens[k:]) == forward(tokens), as
    tests/test_serving.py holds the JAX package for zamba2-1.2b."""
    model, params = _port_model()
    B, S, k = 2, 16, 8
    tokens = torch.from_numpy(_tokens(model.cfg, B, S, seed=7).astype(np.int64))
    full, _, _ = model.apply(params, {"tokens": tokens})
    _, cache = model.prefill(params, {"tokens": tokens[:, :k]})
    cache = _grow(cache, S - k, torch)
    outs = []
    for t in range(k, S):
        logits, cache = model.decode(params, cache, {"tokens": tokens[:, t:t + 1]})
        outs.append(logits)
    err = (torch.cat(outs, dim=1) - full[:, k:]).abs().max()
    assert float(err) < 2e-3, float(err)


def test_init_cache_layers_do_not_alias():
    model, params = _port_model()
    cache = model.init_cache(2, 4)
    for t in (*cache["ssm"], cache["k"], cache["v"]):
        assert t.stride(0) != 0
    tokens = torch.from_numpy(_tokens(model.cfg, 2, 1, seed=8).astype(np.int64))
    _, cache = model.decode(params, cache, {"tokens": tokens})
    per_layer = [cache["ssm"].ssd[i] for i in range(model.cfg.n_layers)]
    assert all(float(s.abs().max()) > 0 for s in per_layer)
    assert not torch.equal(per_layer[0], per_layer[1])
    assert float(cache["k"][:, :, 0].abs().min(dim=-1).values.max()) > 0   # slot 0 written
    assert float(cache["k"][:, :, 1:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# meta shapes of the full-width params and cache; the param count
# ---------------------------------------------------------------------------
def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_meta_tree_and_norm_count():
    """zamba2-1.2b's full-width params tree matches the JAX tree key for
    key (the stacked Mamba2 blocks and the one unstacked shared_block). The
    analytic count takes 2 * d_model norm values per Mamba2 layer while a
    layer holds ``ln`` (d_model) and ``gate_norm`` (d_inner = 2 * d_model),
    and it leaves out the final norm (the reference's own count, ROADMAP
    §3): the tree holds param_count() + n_layers * d_model + d_model values,
    in the port as in the reference."""
    cfg = get_config(ARCH)
    meta = dict(_leaves(build(cfg, RunConfig(device="cpu")).init_eval_shape()))
    ref = dict(_leaves(jax_build(jax_config(ARCH), JaxRunConfig()).init_eval_shape()))
    assert sorted(meta) == sorted(ref)
    for name, t in meta.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[name].shape), name
        assert str(t.dtype).removeprefix("torch.") == str(ref[name].dtype), name
    assert meta["shared_block/attn/wq"].shape == (2048, 2048)
    assert meta["blocks/mamba/in_x"].shape == (38, 2048, 4096)
    n = sum(t.numel() for t in meta.values())
    assert cfg.ssm_d_inner == 2 * cfg.d_model
    assert n == cfg.param_count() + cfg.n_layers * cfg.d_model + cfg.d_model
    assert n == 1_170_313_344


def test_serve_meta_specs_for_the_hybrid_cache():
    cfg = get_config(ARCH)
    rc = RunConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device="cpu")
    _, params_meta, batch_meta, sh, _ = build_prefill_step(cfg, None, B=8, S=512, rc=rc)
    assert sh is None and batch_meta["tokens"].shape == (8, 512)
    assert params_meta["shared_block"]["mlp"]["w1"].shape == (2048, 8192)
    _, _, cache_meta, dbatch, _, _ = build_decode_step(
        cfg, ShapeConfig("d", "decode", 576, 8), None, rc=rc)
    st = cache_meta["ssm"]
    assert isinstance(st, SSMState) and cache_meta["pos"] == 0
    assert st.ssd.shape == (38, 8, 64, 64, 64) and st.ssd.dtype == torch.float32
    assert st.conv_x.shape == (38, 8, 3, 4096) and st.conv_x.dtype == torch.bfloat16
    # 6 applications of the shared block (38 = 6 * 6 + 2): their k/v grow with seq_len
    assert cache_meta["k"].shape == cache_meta["v"].shape == (6, 8, 576, 32, 64)
    assert cache_meta["k"].dtype == torch.bfloat16
    assert all(t.device.type == "meta" for t in (*st, cache_meta["k"], cache_meta["v"]))
    assert dbatch["tokens"].shape == (8, 1)


def test_gemma_meta_specs_at_head_dim_256():
    cfg = get_config("gemma-7b")
    rc = RunConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device="cpu")
    _, params_meta, _, _, _ = build_prefill_step(cfg, None, B=8, S=512, rc=rc)
    assert params_meta["blocks"]["attn"]["wq"].shape == (28, 3072, 16 * 256)
    assert "head" not in params_meta                    # tied embeddings
    n = sum(t.numel() for _, t in _leaves(params_meta))
    assert n == cfg.param_count() + cfg.d_model == 8_537_677_824 + 3072
    _, _, cache_meta, _, _, _ = build_decode_step(
        cfg, ShapeConfig("d", "decode", 576, 8), None, rc=rc)
    assert cache_meta["k"].shape == (28, 8, 576, 16, 256)


# ---------------------------------------------------------------------------
# chip_smoke.py, rehearsed on the CPU with the reduced hybrid and gemma
# ---------------------------------------------------------------------------
@pytest.fixture
def chip_smoke():
    """The repo-root script, imported as a module (its main() is not run)."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("arch,changes", [(ARCH, {}), ("gemma-7b", {"head_dim": 256})])
def test_chip_smoke_phases_rehearse_on_cpu(chip_smoke, arch, changes):
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    res = chip_smoke.serve(cfg, device="cpu", batch=2, prompt_len=16, decode_steps=3)
    assert res["tokens"].shape == (2, 4)
    no_card = {"attention": 0, "ssd": 0}
    assert res["prefill_launches"] == res["request_launches"] == no_card
    errs = chip_smoke.consistency(cfg, device="cpu", prefill_batch=2, prefill_len=16,
                                  batch=2, seq_len=12, split=5)
    assert errs["prefill_kernels_vs_plain"] == 0.0
    assert errs["prefill_decode_vs_forward"] < chip_smoke.DECODE_TOL


def test_chip_smoke_expected_launches(chip_smoke):
    expect = {name: chip_smoke.expected_launches(get_config(name))
              for name in chip_smoke.SERVE_ARCHS}
    assert expect == {"qwen2-0.5b": {"attention": 24, "ssd": 0},
                      "qwen2-1.5b": {"attention": 28, "ssd": 0},
                      "mamba2-2.7b": {"attention": 0, "ssd": 64},
                      "zamba2-1.2b": {"attention": 6, "ssd": 38},
                      "gemma-7b": {"attention": 28, "ssd": 0},
                      "qwen2-moe-a2.7b": {"attention": 24, "ssd": 0},
                      "musicgen-medium": {"attention": 48, "ssd": 0},
                      "llama-3.2-vision-11b": {"attention": 40 + 8, "ssd": 0},
                      "deepseek-67b": {"attention": 95, "ssd": 0},
                      "llama4-scout-17b-a16e": {"attention": 48, "ssd": 0}}
    # phase 3 serves the two largest at a depth cut: K1 once a layer of the cut
    cuts = {name: chip_smoke.expected_launches(chip_smoke.cut_depth(name, layers)[0])
            for name, layers in chip_smoke.SERVE_LAYERS.items()}
    assert cuts == {"deepseek-67b": {"attention": 40, "ssd": 0},
                    "llama4-scout-17b-a16e": {"attention": 12, "ssd": 0}}
    per_step = {name: chip_smoke.expected_decode_launches(get_config(name))
                for name in chip_smoke.SERVE_ARCHS}
    assert per_step["llama-3.2-vision-11b"] == {"attention": 8, "ssd": 0}
    assert all(n == {"attention": 0, "ssd": 0} for name, n in per_step.items()
               if name != "llama-3.2-vision-11b")
    assert chip_smoke.expected_launches(get_config(ARCH).reduced()) == \
        {"attention": 2, "ssd": 4}
    tail = dataclasses.replace(get_config(ARCH).reduced(), n_layers=5)
    assert chip_smoke.expected_launches(tail) == {"attention": 2, "ssd": 5}
    assert sum(s for *_, s in _segments(38, 6)) == 6


def test_k1_bound_at_gemmas_prefill_shape(chip_smoke):
    # q, k, v and o: 4 * 8 * 512 * 16 * 256 * 2 B = 134.2 MB, 40.1 us at 3.35 TB/s;
    # the causal pairs' 17.2 GFLOP take 17.4 us at 989 TFLOP/s
    assert chip_smoke.K1_SHAPES["gemma-7b"] == (8, 512, 512, 16, 16, 256)
    ms, by = chip_smoke.attention_bound(8, 512, 512, 16, 16, 256, torch.bfloat16, True)
    assert by == "bytes"
    assert abs(ms - 4 * 8 * 512 * 16 * 256 * 2 / 3.35e12 * 1e3) < 1e-12
    flops = 4 * 8 * 16 * 256 * (512 * 513 // 2)
    assert abs(flops / 17.2e9 - 1) < 0.01
    ms32, by32 = chip_smoke.attention_bound(8, 512, 512, 16, 16, 256, torch.float32, True)
    assert by32 == "operations" and abs(ms32 - flops / 67e12 * 1e3) < 1e-12
