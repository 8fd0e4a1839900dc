"""Serving parity of the port (repro_torch) with the JAX package, ssm family.

Weights are made once by the JAX package and moved with
``convert.params_from_jax``; prompts come from numpy seeds. JAX runs on
the CPU, the port with device="cpu", where the SSD scan takes K2's plain
version (``models.ssm.ssd_chunked``, the JAX package's own jnp path).

Tolerances. f32: logits and cache atol = rtol = 1e-4, greedy tokens
equal. bf16: 4 layers of bf16 activations, rounded at other places by
XLA and by PyTorch. With this test's inputs over prompt seeds 0-4 the
largest differences were 1.8e-2 in the prefill logits (|logit| < 0.83),
1.9e-2 in the decode logits, 2.3e-3 in the f32 SSD state (|s| < 0.13)
and 5.5e-2 in the bf16 conv tails (|x| < 3.6, about 4 bf16 ulps), so
the bf16 tolerances are 4e-2 on logits, 1e-2 on the SSD state and
1.25e-1 on the conv tails, absolute. Those runs chose 4 of 80 greedy
tokens differently (near-ties), so in bf16 the port's decode is fed the
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
from repro_torch.runtime.serve import build_decode_step, build_prefill_step  # noqa: E402

ARCH = "mamba2-2.7b"
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL = 1e-4
BF16_LOGIT_TOL = 4e-2
BF16_CACHE_TOL = {"ssd": 1e-2, "conv_x": 1.25e-1, "conv_B": 1.25e-1, "conv_C": 1.25e-1}


def _models(dtype, *, n_layers=None, vocab_size=None):
    """(JAX model, JAX params, port model, port params) sharing weights."""
    jc, tc = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    if n_layers is not None:       # full width, cut in depth and vocab
        jc = dataclasses.replace(jax_config(ARCH), n_layers=n_layers, vocab_size=vocab_size)
        tc = dataclasses.replace(get_config(ARCH), n_layers=n_layers, vocab_size=vocab_size)
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
    assert isinstance(tc["ssm"], SSMState)
    for f in SSMState._fields:
        tol = F32_TOL if dtype == "float32" else BF16_CACHE_TOL[f]
        j, t = getattr(jc["ssm"], f), getattr(tc["ssm"], f)
        assert tuple(t.shape) == tuple(j.shape), f
        np.testing.assert_allclose(_np(t), _np(j), atol=tol, rtol=F32_TOL)


def _jax_greedy(jm, jp, prompts, steps):
    """The JAX serving loop: prefill, then greedy decode (an SSM cache needs no room)."""
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    decode = jax.jit(jm.decode)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    toks, step_logits = [tok], []
    for _ in range(steps):
        lg, cache = decode(jp, cache, {"tokens": tok})
        step_logits.append(lg)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        toks.append(tok)
    return np.concatenate([np.asarray(t) for t in toks], axis=1), step_logits, cache


# ---------------------------------------------------------------------------
# reduced mamba2-2.7b: prefill logits + SSM cache, greedy decode, f32 and bf16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_prefill_and_greedy_decode(dtype):
    jm, jp, tm, tp = _models(dtype)
    prompts = _tokens(tm.cfg, 2, 24, seed=1)           # S=24 -> chunk 12
    steps = 8
    tol = F32_TOL if dtype == "float32" else BF16_LOGIT_TOL

    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    before = ops.ssd.launches
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)})
    assert ops.ssd.launches == before                  # the CPU runs the plain version
    assert tl.shape == (2, 1, tm.cfg.vocab_padded) and tl.dtype == TORCH_DTYPE[dtype]
    assert tc["pos"] == int(jc["pos"]) == 24
    assert tc["ssm"].ssd.shape == (4, 2, 16, 16, 16) and tc["ssm"].ssd.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=F32_TOL)
    _close_cache(jc, tc, dtype)

    jtoks, jlogits, jcache = _jax_greedy(jm, jp, prompts, steps)
    cache, ssd = tc, tc["ssm"].ssd
    tok = tl[:, -1:].argmax(dim=-1)
    ttoks = [tok]
    for t in range(steps):
        if dtype == "bfloat16":       # teacher forcing: see the module docstring
            tok = torch.from_numpy(jtoks[:, t:t + 1].astype(np.int64))
        lg, cache = tm.decode(tp, cache, {"tokens": tok})
        np.testing.assert_allclose(_np(lg), _np(jlogits[t]), atol=tol, rtol=F32_TOL)
        tok = lg.argmax(dim=-1)
        ttoks.append(tok)
    assert cache["pos"] == 24 + steps
    assert cache["ssm"].ssd is ssd                     # written in place
    if dtype == "float32":
        np.testing.assert_array_equal(torch.cat(ttoks, dim=1).numpy(), jtoks)
        _close_cache(jcache, cache, dtype)


def test_full_width_two_layers_f32():
    """mamba2-2.7b at its published width (d_model 2560, d_inner 5120, 80
    heads of P=64, N=128), cut to 2 layers and a 512-token vocab."""
    jm, jp, tm, tp = _models("float32", n_layers=2, vocab_size=512)
    cfg = tm.cfg
    assert (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_head_dim,
            cfg.ssm_state) == (2560, 5120, 80, 64, 128)
    prompts = _tokens(cfg, 2, 16, seed=2)
    jl, _, _ = jm.apply(jp, {"tokens": jnp.asarray(prompts)})
    tl, _, _ = tm.apply(tp, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)
    jtoks, jlogits, _ = _jax_greedy(jm, jp, prompts, 3)
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)})
    tok = tl[:, -1:].argmax(dim=-1)
    for t in range(3):
        lg, cache = tm.decode(tp, cache, {"tokens": tok})
        np.testing.assert_allclose(_np(lg), _np(jlogits[t]), atol=F32_TOL, rtol=F32_TOL)
        tok = lg.argmax(dim=-1)
        assert np.array_equal(tok.numpy(), jtoks[:, t + 1:t + 2])


def test_decode_continues_a_jax_cache():
    """An SSM cache made by the JAX prefill, moved with cache_from_jax,
    decodes to the JAX logits."""
    jm, jp, tm, tp = _models("float32")
    prompts = _tokens(tm.cfg, 2, 10, seed=3)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["pos"] == 10 and isinstance(tc["ssm"], SSMState)
    assert tc["ssm"].conv_x.dtype == torch.float32
    nxt = np.full((2, 1), 7, np.int32)
    jl, jc2 = jm.decode(jp, jc, {"tokens": jnp.asarray(nxt)})
    tl, tc2 = tm.decode(tp, tc, {"tokens": torch.from_numpy(nxt)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)
    _close_cache(jc2, tc2, "float32")


# ---------------------------------------------------------------------------
# cache correctness of the port itself (tests/test_serving.py's mamba2 cases)
# ---------------------------------------------------------------------------
def _port_model():
    cfg = get_config(ARCH).reduced()
    model = build(cfg, RunConfig(param_dtype=torch.float32,
                                 compute_dtype=torch.float32, device="cpu"))
    return model, model.init(torch.Generator().manual_seed(0))


def test_incremental_decode_matches_forward():
    model, params = _port_model()
    B, S = 2, 12
    tokens = torch.from_numpy(_tokens(model.cfg, B, S, seed=4).astype(np.int64))
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
    model, params = _port_model()
    B, S, k = 2, 16, 8
    tokens = torch.from_numpy(_tokens(model.cfg, B, S, seed=5).astype(np.int64))
    full, _, _ = model.apply(params, {"tokens": tokens})
    _, cache = model.prefill(params, {"tokens": tokens[:, :k]})
    outs = []
    for t in range(k, S):
        logits, cache = model.decode(params, cache, {"tokens": tokens[:, t:t + 1]})
        outs.append(logits)
    err = (torch.cat(outs, dim=1) - full[:, k:]).abs().max()
    assert float(err) < 2e-3, float(err)


# ---------------------------------------------------------------------------
# runtime.serve: meta specs of the SSM cache; each layer's state its own
# ---------------------------------------------------------------------------
def test_serve_meta_specs_for_the_ssm_cache():
    cfg = get_config(ARCH)
    rc = RunConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device="cpu")
    _, params_meta, batch_meta, sh, _ = build_prefill_step(cfg, None, B=8, S=512, rc=rc)
    assert sh is None and batch_meta["tokens"].shape == (8, 512)
    assert params_meta["blocks"]["mamba"]["in_x"].shape == (64, 2560, 5120)
    assert params_meta["blocks"]["mamba"]["A_log"].dtype == torch.float32
    _, _, cache_meta, dbatch, _, _ = build_decode_step(
        cfg, ShapeConfig("d", "decode", 576, 8), None, rc=rc)
    st = cache_meta["ssm"]
    assert isinstance(st, SSMState) and cache_meta["pos"] == 0
    assert st.ssd.shape == (64, 8, 80, 64, 128) and st.ssd.dtype == torch.float32
    assert st.conv_x.shape == (64, 8, 3, 5120) and st.conv_x.dtype == torch.bfloat16
    assert st.conv_B.shape == st.conv_C.shape == (64, 8, 3, 128)
    assert all(t.device.type == "meta" for t in st)
    assert dbatch["tokens"].shape == (8, 1)
    # 1.34 GB of f32 SSD state: 64 layers x 8 x 80 x 64 x 128 x 4 bytes
    assert st.ssd.numel() * 4 == 1_342_177_280


def test_init_cache_layers_do_not_alias():
    model, params = _port_model()
    cache = model.init_cache(2, 4)
    for t in cache["ssm"]:
        assert t.stride(0) != 0
    tokens = torch.from_numpy(_tokens(model.cfg, 2, 1, seed=6).astype(np.int64))
    _, cache = model.decode(params, cache, {"tokens": tokens})
    per_layer = [cache["ssm"].ssd[i] for i in range(model.cfg.n_layers)]
    assert all(float(s.abs().max()) > 0 for s in per_layer)
    assert not torch.equal(per_layer[0], per_layer[1])


# ---------------------------------------------------------------------------
# chip_smoke.py, rehearsed on the CPU with reduced mamba2-2.7b
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


def test_chip_smoke_ssm_phases_rehearse_on_cpu(chip_smoke):
    cfg = get_config(ARCH).reduced()
    res = chip_smoke.serve(cfg, device="cpu", batch=2, prompt_len=16, decode_steps=3)
    assert res["tokens"].shape == (2, 4)
    no_card = {"attention": 0, "ssd": 0}
    assert res["prefill_launches"] == res["request_launches"] == no_card
    cache = {"ssm": "a state", "pos": 3}
    assert chip_smoke.grow_cache(cache, 5) is cache
    errs = chip_smoke.consistency(cfg, device="cpu", prefill_batch=2, prefill_len=16,
                                  batch=2, seq_len=12, split=5)
    assert errs["prefill_kernels_vs_plain"] == 0.0
    assert errs["prefill_decode_vs_forward"] < chip_smoke.DECODE_TOL


def test_k2_bound_at_the_serving_shape(chip_smoke):
    bf16, f32 = torch.bfloat16, torch.float32
    ms, by = chip_smoke.ssd_bound(8, 512, 80, 64, 128, 128, bf16, bf16)
    nbytes = (2 * 8 * 512 * 80 * 64 * 2 + 8 * 512 * 80 * 4 + 80 * 4
              + 2 * 8 * 512 * 128 * 2 + 8 * 80 * 64 * 128 * 4)
    assert nbytes == 108_265_792                   # about 108 MB
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12   # 32.3 us
    pairs = 128 * 129 // 2
    flops = 2 * 8 * 4 * (pairs * 128 + 80 * (pairs * 64 + 2 * 128 * 128 * 64))
    assert abs(flops / 13.5e9 - 1) < 0.01          # about 13.5 GFLOP
    ms32, by32 = chip_smoke.ssd_bound(8, 512, 80, 64, 128, 128, f32, f32)
    assert by32 == "operations" and abs(ms32 - flops / 67e12 * 1e3) < 1e-12
    ms_init, _ = chip_smoke.ssd_bound(8, 512, 80, 64, 128, 128, bf16, bf16, init_state=True)
    assert abs(ms_init - (nbytes + 8 * 80 * 64 * 128 * 4) / 3.35e12 * 1e3) < 1e-12
